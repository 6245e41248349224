"""Pipelined-vs-flat SASG step benchmark of the port.

Port of ``benchmarks/pipeline_bench.py``. The smoke-sized cnn_cifar
(d_model=16) SASG step three ways, on stacked meshes in this process:
flat workers (``data`` 2); workers x 2 stages under the 1F1B engine with
the compressed ``ActivationLayout`` ring (blocked top-k of fp32 values +
u8 block indices through the block_topk kernel on the card, k 0.05,
blocks of 256) and ``overlap=True`` (accepted for parity with the JAX
bench, run as the synchronous exchange); and under the GPipe engine
with the dense ring. Records step time, the SASG upload bits and the
stage-axis traffic of ``core.metrics.PipelineCommModel`` split into the
activation ring and the gradient gather. Writes ``pipeline.json`` into the
output directory (``artifacts/bench_torch/``), never into the JAX
package's ``BENCH_pipeline.json``:

  PYTHONPATH=src python -m repro_torch.benchmarks.run --stages 2 [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from .table2_rounds_bits import OUT_DIR


def run(stages: int = 2, steps: int = 5, out_dir: str = OUT_DIR, device=None) -> dict:
    from repro_torch.comm.transport import ActivationLayout
    from repro_torch.configs import get_config
    from repro_torch.core.sasg import sasg_config
    from repro_torch.dist.strategy import choose_strategy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    device = torch.device(device or "cuda")
    cfg = dataclasses.replace(get_config("cnn_cifar"), d_model=16)
    model = build(cfg)
    scfg = sasg_config(k_ratio=0.05, max_delay=4)
    ring = ActivationLayout(wire_dtype="float32", k_ratio=0.05, block_size=256)
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(8,)).astype(np.int32)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def bench(cfg_step, mesh, strategy):
        built = build_train_step(model, cfg_step, None, constant(0.05), device=device,
                                 mesh=mesh, strategy=strategy)
        state = built.init(0)
        state, mets = built.step(state, batch)          # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, mets = built.step(state, batch)
        sync()
        return built, {k: float(v) for k, v in mets.items()}, (time.perf_counter() - t0) / steps

    mesh_flat = make_test_mesh((2,), ("data",), device_type=device.type)
    bf, _, t_flat = bench(scfg, mesh_flat, choose_strategy(mesh_flat))
    mesh_pipe = make_test_mesh((2, stages), ("data", "stage"), device_type=device.type)
    s_pipe = choose_strategy(mesh_pipe, pipeline_stages=stages,
                             trunk_layers=model.pipeline.n_layers)
    if not s_pipe.pipelined:
        raise ValueError(f"stages={stages} does not divide the cnn trunk depth "
                         f"{model.pipeline.n_layers}")
    scfg_gpipe = dataclasses.replace(scfg, pipeline_engine="gpipe")
    scfg_1f1b = dataclasses.replace(scfg, pipeline_engine="1f1b", act_layout=ring,
                                    overlap=True)
    bg, mets_g, t_gpipe = bench(scfg_gpipe, mesh_pipe, s_pipe)
    bp, mets_p, t_pipe = bench(scfg_1f1b, mesh_pipe, s_pipe)

    def pipe_record(built, mets, dt, cfg_step):
        layout = cfg_step.act_layout or ActivationLayout()
        return {
            "mesh": {"data": 2, "stage": stages},
            "engine": cfg_step.pipeline_engine,
            "overlap": cfg_step.overlap,
            "act_layout": {"wire_dtype": layout.wire_dtype, "k_ratio": layout.k_ratio,
                           "block_size": layout.block_size},
            "step_time_s": dt,
            "bits_wire_per_upload": built.bits_wire,
            "bits_paper_per_upload": built.bits_paper,
            "pipe_bits_per_step": mets["pipe_bits_step"],
            "pipe_ring_bits_per_step": mets["pipe_ring_bits_step"],
            "pipe_gather_bits_per_step": mets["pipe_gather_bits_step"],
        }

    record = {
        "model": "cnn_cifar(d_model=16)",
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "stages": stages,
        "steps_timed": steps,
        "flat": {"mesh": {"data": 2}, "step_time_s": t_flat,
                 "bits_wire_per_upload": bf.bits_wire, "bits_paper_per_upload": bf.bits_paper},
        "pipelined": pipe_record(bp, mets_p, t_pipe, scfg_1f1b),
        "pipelined_gpipe": pipe_record(bg, mets_g, t_gpipe, scfg_gpipe),
        "note": "stacked meshes in one process: every stage runs on the one device, so the "
                "times compare total work, not a schedule's critical path",
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "pipeline.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[pipeline_bench] flat {t_flat * 1e3:.1f} ms/step, {stages}-stage gpipe "
          f"{t_gpipe * 1e3:.1f} ms/step, 1f1b+ring-topk {t_pipe * 1e3:.1f} ms/step -> {path}",
          flush=True)
    return {"pipeline": record}
