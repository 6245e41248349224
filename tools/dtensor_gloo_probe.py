"""Which of DTensor's own collectives run over gloo on CUDA tensors.

Each case runs in a fresh pair of gloo ranks on one device type (``cuda``:
both ranks on ``cuda:0``; ``cpu``), so a rank that crashes ends only its
case. A case prints ``ok`` with the first values of rank 0's result, the
error's first line, or the signal that ended a rank. The training step
on a device mesh runs its collectives through ``repro_torch.comm`` (host
staging on gloo), never through these; the probe records why.

    python3 tools/dtensor_gloo_probe.py [--device cuda|cpu]
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = ("full_tensor", "all_to_all", "all_reduce", "reduce_scatter", "distribute_tensor",
         "vmap_grad_tp", "vmap_grad_conv")


def _case(name, mesh, dev, rank):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    x = torch.arange(16, dtype=torch.float32, device=dev).reshape(4, 4) + rank
    shard = DTensor.from_local(x, mesh, [Replicate(), Shard(0)], run_check=False)
    part = DTensor.from_local(x, mesh, [Replicate(), Partial()], run_check=False)
    if name == "full_tensor":            # all-gather
        return shard.full_tensor()
    if name == "all_to_all":
        return shard.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
    if name == "all_reduce":
        return part.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    if name == "reduce_scatter":
        return part.redistribute(mesh, [Replicate(), Shard(0)]).to_local()
    if name == "distribute_tensor":      # scatter from rank 0
        return distribute_tensor(x, mesh, [Replicate(), Shard(0)]).to_local()
    if name == "vmap_grad_conv":
        # a convolution whose weight is split over its output channels (the
        # TP spec of cnn_cifar's conv weights) under vmap(grad)
        w = distribute_tensor(torch.ones(8, 3, 3, 3, device=dev), mesh, [Replicate(), Shard(0)],
                              src_data_rank=None)
        xb = distribute_tensor(torch.ones(3, 2, 3, 8, 8, device=dev), mesh,
                               [Replicate(), Replicate()], src_data_rank=None)
        g = torch.func.vmap(torch.func.grad(
            lambda a, v: torch.nn.functional.conv2d(v, a, padding=1).relu().sum()),
            in_dims=(None, 0))(w, xb)
        return g.to_local()
    # a column-parallel then a row-parallel weight under vmap(grad)
    w1 = distribute_tensor(torch.ones(4, 8, device=dev), mesh, [Replicate(), Shard(1)],
                           src_data_rank=None)
    w2 = distribute_tensor(torch.ones(8, 4, device=dev), mesh, [Replicate(), Shard(0)],
                           src_data_rank=None)
    xb = distribute_tensor(torch.ones(3, 2, 4, device=dev), mesh, [Replicate(), Replicate()],
                           src_data_rank=None)
    g = torch.func.vmap(torch.func.grad(lambda a, b, v: ((v @ a).relu() @ b).sum(),
                                        argnums=(0, 1)), in_dims=(None, None, 0))(w1, w2, xb)
    return g[1].to_local()


def _rank(rank, store, dev, name, out):
    from torch.distributed.device_mesh import init_device_mesh

    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=2, init_method=f"file://{store}")
    mesh = init_device_mesh(dev, (1, 2), mesh_dim_names=("data", "model"))
    try:
        y = _case(name, mesh, dev, rank)
        if dev == "cuda":
            torch.cuda.synchronize()
        msg = f"ok {y.flatten()[:4].tolist()}"
    except Exception as e:
        msg = f"error {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    if rank == 0:
        with open(out, "w") as f:
            f.write(msg)
    dist.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = ap.parse_args().device
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    for name in CASES:
        tmp = tempfile.mkdtemp()
        out = os.path.join(tmp, "out")
        try:
            mp.spawn(_rank, args=(os.path.join(tmp, "store"), dev, name, out), nprocs=2)
            msg = open(out).read()
        except Exception as e:   # a rank ended by a signal, or failed outright
            msg = f"rank ended: {str(e).splitlines()[0][:160]}"
        print(f"gloo/{dev} {name}: {msg}", flush=True)


if __name__ == "__main__":
    main()
