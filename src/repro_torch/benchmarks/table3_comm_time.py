"""Paper Table 3 / Figs 5-6: communication time + extra overheads.

Port of ``benchmarks/table3_comm_time.py``. The paper measures wall-clock
on 10 GPUs over 1 Gbps GLOO point-to-point. Here the transport is the
analytic ``LinkModel`` (sequential uplink, 1 Gbps, 1e-4 s per upload,
paper Section 5.1) applied to the per-upload bits of the top-1% config
(``comm.bits.account``) and to the skip fraction of the port's own Table-2
run (``table2.json`` beside this table's output). The extra computation is
the auxiliary gradient, timed on the device: 100 iterations of one
worker's cnn_cifar gradient at 10 samples, after a warm-up, between two
``torch.cuda.synchronize()`` on the card. The server-memory columns are
counted from the params.
"""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.comm.bits import account
from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.metrics import LinkModel, model_dimension
from repro_torch.core.types import tree_leaves
from repro_torch.models import build
from repro_torch.train.step import resolve_device

OUT_DIR = "artifacts/bench_torch"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def aux_grad_seconds(model, params, device, iters=100) -> float:
    """Seconds for ``iters`` gradients of one worker at 10 samples."""
    batch = {"x": torch.zeros((10, 32, 32, 3), device=device),
             "labels": torch.zeros((10,), dtype=torch.long, device=device)}
    g = torch.func.grad(model.loss_fn)
    g(params, batch)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = g(params, batch)
    _sync(device)
    del out
    return time.perf_counter() - t0


def run(out_dir=OUT_DIR, log=print, device=None):
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    log("== Table 3: comm time per 100 iterations + adaptive-method overheads ==")
    cfg = get_config("cnn_cifar")
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    d = model_dimension(params)
    M, iters = 10, 100
    link = LinkModel(bandwidth_bps=1e9, latency_s=1e-4, sequential_uplink=True)

    topk_cfg = CompressorConfig(name="topk_ef", k_ratio=0.01,
                                topk_impl="sharded", block_size=64)
    dense_bits = 32.0 * d
    sparse_bits = account(topk_cfg, params).paper

    # realized skip fraction from the table2 run if available
    skip = 0.35
    t2 = os.path.join(out_dir, "table2.json")
    if os.path.exists(t2):
        with open(t2) as f:
            res = json.load(f).get("fc_mnist", {})
        if "sasg" in res and "sgd" in res:
            skip = 1.0 - res["sasg"]["rounds_total"] / max(res["sgd"]["rounds_total"], 1)

    rows = {
        "sgd": link.upload_time(dense_bits, M) * iters,
        "sparse": link.upload_time(sparse_bits, M) * iters,
        "lasg": link.upload_time(dense_bits, M * (1 - skip)) * iters,
        "sasg": link.upload_time(sparse_bits, M * (1 - skip)) * iters,
    }

    # extra computation: the auxiliary gradient (paper: ~1.25 s / 100 iters)
    aux_time = aux_grad_seconds(model, params, device, iters)

    # extra memory: stale state held server-side
    mem_lasg = sum(x.numel() * x.element_size() for x in tree_leaves(params)) * M
    mem_sasg = int(sparse_bits / 8) * M          # sparse stale payloads

    log(f"{'method':8s} {'comm time /100 iter':>20s} {'extra compute':>14s} "
        f"{'server memory':>14s}   (aux gradient on {device})")
    for name in ["sgd", "sparse", "lasg", "sasg"]:
        extra_c = f"{aux_time:8.2f}s" if name in ("lasg", "sasg") else "       -"
        extra_m = {"lasg": f"{mem_lasg/2**20:9.2f}MB",
                   "sasg": f"{mem_sasg/2**20:9.2f}MB"}.get(name, "        -")
        log(f"{name:8s} {rows[name]:>19.2f}s {extra_c:>14s} {extra_m:>14s}")

    if not rows["sasg"] < rows["sparse"] < rows["sgd"]:
        raise AssertionError("Table 3: expected SASG < Sparse < SGD in comm time")
    if not rows["sasg"] < rows["lasg"]:
        raise AssertionError("Table 3: expected SASG < LASG in comm time")
    if not mem_sasg < mem_lasg / 50:
        raise AssertionError("sparse server cache should be ~100x smaller")
    log(f"ok: SASG comm time lowest; server memory {mem_lasg/max(mem_sasg,1):.0f}x "
        "smaller than LASG\n")
    out = {"table3": {"comm_time_s": rows, "aux_grad_s": aux_time,
                      "aux_grad_device": str(device),
                      "server_mem_lasg": mem_lasg, "server_mem_sasg": mem_sasg,
                      "skip_fraction": skip}}
    with open(os.path.join(out_dir, "table3.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    run()
