"""Serving launcher of the port: the continuous-batching engine on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m \
      --requests 8 --prompt-len 512 --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
      --requests 8 --prompt-len 256 --max-seq 1024 --max-new 16

Runs on the card (``--device cuda``, the default) and raises without one;
``--device cpu`` runs the plain versions of the kernels (add ``--reduced``
for the smoke-test width). Port of ``repro/launch/serve.py``: the same
flags, plus ``--device`` and
``--prompt-len`` (the JAX launcher's fixed 6). Params and prompts are
drawn from seed 0, as in the JAX launcher. Architectures with
global-attention layers are served from the paged KV cache
(``--block-size``, ``--cache-dtype`` for the blocks' wire dtype; default
the compute dtype, bitwise the dense cache), unless ``--dense``. MoE
architectures (mixtral_8x7b, kimi_k2) serve completions only: their
capacity groups drop other tokens in a tick than in a full forward
(DESIGN.md §9). For SSD architectures the prefill chunk is the SSD chunk,
as ``benchmarks/serve_bench.py`` sets it, so prompts of at least one
chunk are prefilled through the chunked SSD; for the others it is the JAX
engine's default, 8. recurrentgemma_9b (RG-LRU + local attention) has no
global layer to page and is served from the dense cache. The
encoder-decoder (seamless_m4t_v2) is refused with a ``ValueError``: the
engine feeds no frames, and encoder-decoder decode takes one scalar
position for all rows, not the engine's per-slot positions.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_9b \
      --requests 8 --prompt-len 256 --max-seq 1024 --max-new 16

``--mesh-shape data,model`` serves over a mesh (``serve.engine.
build_serve``): with ``--procs`` (the mesh's size) as that many ranks of a
device mesh (gloo by default: several ranks may share a card), each
holding its tensor-parallel shard of the params and its heads of the
cache, every rank running the same engine (rank 0 logs; its mesh line
says ``tp_compute=sharded``); without, on a stacked mesh, which splits
nothing. Tensor parallelism takes the decoder-only LMs of attention, SSD
and RG-LRU layers whose widths divide by the model axis (KV heads may
instead divide it: each rank keeps them whole), on a data axis of 1;
MoE and a vocabulary the axis does not divide are refused:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b --reduced \
      --device cpu --mesh-shape 1,2 --procs 2 --requests 3 --prompt-len 10
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m --reduced \
      --device cpu --mesh-shape 1,2 --procs 2 --requests 3 --prompt-len 40
"""
import argparse
import sys
import time


def parse_args(argv=None):
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_370m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--dense", action="store_true",
                    help="dense per-slot KV cache (default: paged when the arch has "
                         "global-attention layers)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--cache-dtype", default=None, choices=["float32", "bfloat16"],
                    help="paged-block wire dtype (default: compute dtype, bitwise the "
                         "dense cache)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model sizes: serve over a stacked mesh, or with --procs "
                         "over a device mesh of that many ranks")
    ap.add_argument("--procs", type=int, default=None,
                    help="ranks of the device mesh (the mesh's size)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = ap.parse_args(argv)
    if args.mesh_shape is not None:
        from repro_torch.launch.mesh import parse_mesh_shape

        try:
            args.mesh_shape, args.mesh_axes = parse_mesh_shape(args.mesh_shape)
        except ValueError as e:
            ap.error(str(e))
        size = 1
        for d in args.mesh_shape:
            size *= d
        if args.procs is not None and args.procs != size:
            ap.error(f"--procs {args.procs} must equal the mesh's size {size}")
    elif args.procs is not None:
        ap.error("--procs needs --mesh-shape")
    return args


def serve(argv=None, log_fn=print, group=None):
    """Build a server from command-line arguments, answer the requests;
    returns ``(server, completed)``. With ``--procs``, ``group`` is this
    rank's worker group (``main`` spawns the ranks)."""
    args = parse_args(argv)
    if args.procs is not None and group is None:
        raise ValueError("--procs: run through main, which spawns the ranks")
    if group is not None and group.rank != 0:
        log_fn = _silent

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import BatchedServer, Request, build_serve
    from repro_torch.train.step import resolve_device

    cfg = get_config(args.arch)
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: the serving engine feeds no frames, and "
            "its decode takes one scalar position, not the engine's per-slot positions")
    device = resolve_device(group.device if group is not None else args.device)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    mesh = None
    if args.mesh_shape is not None:
        from repro_torch.launch.mesh import make_test_mesh

        mesh = make_test_mesh(args.mesh_shape, args.mesh_axes, group=group,
                              device_type=device.type)
        sizes = dict(zip(args.mesh_axes, args.mesh_shape))
        log_fn(f"[serve] mesh={sizes}"
               + ("" if group is None else f" procs={group.world_size} "
                                           f"backend={group.backend}")
               + (" tp_compute=sharded" if group is not None and sizes["model"] > 1 else ""))
    built = build_serve(model, mesh, None, "model" if mesh is not None else None, "data",
                        group=group)
    params = built.place(params)
    chunk = cfg.ssm.chunk_size if "ssd" in cfg.attn_pattern else 8
    paged = False if args.dense else None   # None: paged when pageable
    srv = BatchedServer(built, params, cfg, args.batch, args.max_seq,
                        paged=paged, block_size=args.block_size,
                        cache_dtype=args.cache_dtype, prefill_chunk=chunk)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        srv.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    t0 = time.perf_counter()
    done, _ = srv.drain(strict=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    stats = srv.cache_stats()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    mode = "paged" if srv.paged else "dense"
    log_fn(f"[serve] {cfg.name}: {len(done)} requests, {stats['ticks']} engine ticks "
           f"({mode} cache, {stats['cache_dtype']}, {stats['cache_bytes']} B), "
           f"{stats['prefill_tokens']} prompt tokens, "
           f"{stats['decode_tokens'] / dt:.1f} tok/s on {name}")
    if srv.paged:
        log_fn(f"[serve] block high-water {stats['block_high_water']}"
               f"/{stats['num_blocks']}: {stats['high_water_bytes']:.0f} B "
               f"vs dense-equivalent {stats['dense_equiv_bytes']:.0f} B")
    return srv, done


def _silent(msg: str) -> None:
    pass


def _rank_main(group, argv):
    """One rank of a device-mesh server: the same requests on every rank."""
    _, done = serve(argv, group=group)
    return sorted((c["uid"], [int(t) for t in c["tokens"]]) for c in done)


def main(argv=None):
    args = parse_args(argv)
    if args.procs is None:
        serve(argv)
        return 0
    from repro_torch.comm import process_group

    argv = list(sys.argv[1:] if argv is None else argv)
    device_type = "cuda" if str(args.device).startswith("cuda") else str(args.device)
    process_group.spawn(_rank_main, args.procs, args.backend, device_type, args=(argv,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
