"""Compressor x layout sweep of the port.

Port of ``benchmarks/compressor_bench.py``. The smoke-sized cnn_cifar
(d_model=16) train step for each of its nine compressor configs (the
per-shard top-k through the fused kernel, its unfused reference, the
per-tensor and flat layouts, randk, and the dense baselines), on a flat
2-worker mesh and on a 2-worker x 2-stage pipelined mesh (stacked in this
process), with the selection rule off. Records per config the bits per
upload (paper and wire, and the transport's per-bucket report) and ms per
step on the device: every cell built and warmed first, then timed in
interleaved rounds, each cell keeping its fastest round. Writes
``compressors.json`` into the output directory
(``artifacts/bench_torch/``), never the JAX package's
``BENCH_compressors.json``:

  PYTHONPATH=src python -m repro_torch.benchmarks.run --compressors [--smoke] [--device cpu]

``--smoke``: one round of one timed step (the bits are the same).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from .table2_rounds_bits import OUT_DIR


def sweep_configs() -> dict:
    from repro_torch.core.compressors import CompressorConfig

    return {
        "topk_ef_kernel": CompressorConfig(name="topk_ef", k_ratio=0.05, topk_impl="kernel",
                                           block_size=64),
        "topk_ef_reference": CompressorConfig(name="topk_ef", k_ratio=0.05,
                                              topk_impl="reference", block_size=64),
        "topk_ef_per_tensor_exact": CompressorConfig(name="topk_ef", k_ratio=0.05,
                                                     layout="per_tensor", topk_impl="exact"),
        "topk_ef_flat_global": CompressorConfig(name="topk_ef", k_ratio=0.05, bucket="global",
                                                topk_impl="exact"),
        "randk": CompressorConfig(name="randk", k_ratio=0.05),
        "qsgd": CompressorConfig(name="qsgd"),
        "signsgd_ef": CompressorConfig(name="signsgd_ef"),
        "terngrad": CompressorConfig(name="terngrad"),
        "identity": CompressorConfig(name="identity"),
    }


def run(stages: int = 2, steps: int = 10, rounds: int = 3, out_dir: str = OUT_DIR,
        device=None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.sasg import SASGConfig
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.dist.strategy import choose_strategy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    device = torch.device(device or "cuda")
    cfg = dataclasses.replace(get_config("cnn_cifar"), d_model=16)
    model = build(cfg)
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(8,)).astype(np.int32)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    mesh_flat = make_test_mesh((2,), ("data",), device_type=device.type)
    s_flat = choose_strategy(mesh_flat, sasg_enabled=True)
    mesh_pipe = make_test_mesh((2, stages), ("data", "stage"), device_type=device.type)
    s_pipe = choose_strategy(mesh_pipe, sasg_enabled=True, pipeline_stages=stages,
                             trunk_layers=model.pipeline.n_layers)
    if not s_pipe.pipelined:
        raise ValueError(f"stages={stages} does not divide the cnn trunk depth "
                         f"{model.pipeline.n_layers}")

    # build and warm every cell first, then time in interleaved rounds and
    # keep each cell's fastest: a cell timed in one block would carry
    # whatever drift (clocks, allocator growth) its turn met
    cells = {}
    for name, comp in sweep_configs().items():
        scfg = SASGConfig(compressor=comp, selection=SelectionConfig(enabled=False), name=name)
        for mesh_name, mesh, strategy in (("flat", mesh_flat, s_flat),
                                          ("pipelined", mesh_pipe, s_pipe)):
            built = build_train_step(model, scfg, None, constant(0.05), device=device,
                                     mesh=mesh, strategy=strategy)
            state, _ = built.step(built.init(0), batch)      # warm-up
            cells[(name, mesh_name)] = [built, state, float("inf")]
    sync()
    for _ in range(rounds):
        for cell in cells.values():
            built, state, best = cell
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = built.step(state, batch)
            sync()
            cell[1] = state
            cell[2] = min(best, (time.perf_counter() - t0) / steps)

    template = model.init(torch.Generator().manual_seed(0), device="meta")
    results = {}
    for name, comp in sweep_configs().items():
        bf, _, t_flat = cells[(name, "flat")]
        bp, _, t_pipe = cells[(name, "pipelined")]
        if (bf.bits_paper, bf.bits_wire) != (bp.bits_paper, bp.bits_wire):
            raise RuntimeError(f"{name}: flat and pipelined bits per upload differ")
        results[name] = {
            "layout": bf.exchange.transport.layout,
            "topk_impl": comp.resolved_impl() if comp.name == "topk_ef" else None,
            "bits_paper_per_upload": bf.bits_paper,
            "bits_wire_per_upload": bf.bits_wire,
            "step_ms_flat": t_flat * 1e3,
            "step_ms_pipelined": t_pipe * 1e3,
            "buckets": bf.exchange.transport.bits_report(template).rows(),
        }
        print(f"[compressor_bench] {name:26s} flat {t_flat * 1e3:8.2f} ms  {stages}-stage "
              f"{t_pipe * 1e3:8.2f} ms  wire {bf.bits_wire:.3e} bits/upload", flush=True)

    speedup = {m: results["topk_ef_reference"][f"step_ms_{m}"]
               / results["topk_ef_kernel"][f"step_ms_{m}"] for m in ("flat", "pipelined")}
    record = {
        "model": "cnn_cifar(d_model=16)",
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "stages": stages,
        "steps_timed": steps,
        "rounds": rounds,
        "compressors": results,
        "kernel_vs_reference_speedup": speedup,
        "note": "stacked meshes in one process: every worker and stage on the one device; "
                "ms per step is the fastest of the interleaved rounds, host clock around "
                "a synchronize",
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "compressors.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[compressor_bench] kernel-vs-reference speedup flat {speedup['flat']:.2f}x, "
          f"pipelined {speedup['pipelined']:.2f}x -> {path}", flush=True)
    return {"compressors": record}
