"""Elasticity and chaos benchmark of the port.

Port of ``benchmarks/elastic_bench.py``, with its cell: fc_mnist, SASG
(k 0.1, lr 0.05), 4 workers, 12 steps, a checkpoint every 4, every fault
at step 7 (strictly between checkpoints 4 and 8: recovery replays). It
runs the single-fault chaos matrix (``FaultPlan.single_fault_matrix``)
and the in-run 4 -> 2 -> 4 resize, and records per plan: recovery
latency, steps lost to replay (failed step - restored step), restarts,
lost checkpoints, resizes, and whether the final params are bitwise an
uninterrupted run's.

Bit-identity is part of the record (``expect_bitexact``): crash,
data_hiccup, save_fail and corrupt_ckpt recoveries replay the same
batches from an exactly restored state, so they must end bitwise; the
straggler and the resizes change the update history by design. The bench
raises (a non-zero exit from ``run.py``) when a cell fails the bounds that
the reference's ``analysis/baseline.json::elastic_bench`` gates: every
cell completes, every ``expect_bitexact`` cell is bitwise, every replay
applies the clean run's batch at each step, and steps lost stay within
``ckpt_every`` (``2 * ckpt_every`` where the plan corrupts the only
checkpoint before the fault, so recovery starts over from step 0: the
baseline's 8). Writes ``elastic.json`` into the output directory
(``artifacts/bench_torch/``), never the JAX package's
``BENCH_elastic.json``:

  PYTHONPATH=src python -m repro_torch.benchmarks.run --elastic [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from .table2_rounds_bits import OUT_DIR

TOTAL_STEPS = 12
CKPT_EVERY = 4
FAULT_STEP = 7   # strictly between checkpoint steps 4 and 8: real replay
WORKERS = 4
INIT_SEED = 7
# the faults whose recovery must reproduce the clean run bitwise
EXPECT_BITEXACT = frozenset({"crash", "corrupt_ckpt", "save_fail_transient",
                             "save_fail_lost", "data_hiccup"})


def _max_abs_diff(a, b) -> float:
    from repro_torch.core.types import tree_leaves

    return max((float((x.float() - y.float()).abs().max()) if x.numel() else 0.0)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def plans(smoke: bool = False) -> dict:
    from repro_torch.train.faults import FaultPlan

    out = dict(FaultPlan.single_fault_matrix(step=FAULT_STEP, workers=WORKERS))
    out["resize_4_2_4"] = (FaultPlan().worker_drop(CKPT_EVERY, to=WORKERS // 2)
                           .worker_join(2 * CKPT_EVERY, to=WORKERS))
    if smoke:
        out = {k: out[k] for k in ("crash", "worker_drop")}
    return out


def cell_failures(cell: dict) -> list:
    """What a cell's record breaks of the bench's bounds (module docstring)."""
    bound = CKPT_EVERY * (2 if "corrupt_ckpt" in cell["faults"] else 1)
    out = []
    if not cell["completed"]:
        out.append("did not complete")
    if cell["expect_bitexact"] and not cell["bitexact_vs_clean"]:
        out.append(f"not bitwise the clean run (max diff {cell['max_param_diff_vs_clean']:.3e})")
    if not cell["replay_exact"]:
        out.append("a step applied another batch than the clean run's")
    if cell["steps_lost"] > bound:
        out.append(f"{cell['steps_lost']} steps lost > {bound}")
    return out


def run(smoke: bool = False, out_dir: str = OUT_DIR, device=None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.sasg import PRESETS
    from repro_torch.data import indexed_classification_stream, synthetic_classification
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import TrainerConfig
    from repro_torch.train.elastic import ElasticTrainer, WorkerMembership

    device = torch.device(device or "cuda")
    cfg = get_config("fc_mnist")
    xs, ys = synthetic_classification(256, cfg.vocab_size, (28, 28, 1), seed=0)
    mem = WorkerMembership(build(cfg), PRESETS["sasg"](k_ratio=0.1), constant(0.05),
                           device=device)
    built = mem.build(WORKERS)

    def trainer(ckpt_dir, plan=None):
        tc = TrainerConfig(total_steps=TOTAL_STEPS, ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
                           log_every=10**9, record_batches=True)
        return ElasticTrainer(built, indexed_classification_stream(xs, ys, batch=8, seed=3),
                              tc, membership=mem, plan=plan, log_fn=lambda s: None)

    cells = []
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as root:
        t_clean = trainer(os.path.join(root, "clean"))
        clean = t_clean.run(seed=INIT_SEED)
        for name, plan in plans(smoke).items():
            t0 = time.perf_counter()
            t = trainer(os.path.join(root, name), plan=plan)
            state = t.run(seed=INIT_SEED)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            recoveries = [e for e in t.events if e["kind"] == "recovery"]
            diff = _max_abs_diff(clean.params, state.params)
            cell = {
                "plan": name,
                "faults": [f.kind for f in plan.faults],
                "completed": len(t.history) >= TOTAL_STEPS,
                "restarts": len(recoveries),
                "steps_lost": int(sum(e["steps_lost"] for e in recoveries)),
                "recovery_latency_s": float(sum(e["latency_s"] for e in recoveries)),
                "ckpt_lost": sum(1 for e in t.events if e["kind"] == "ckpt_lost"),
                "resizes": sum(1 for e in t.events if e["kind"] == "resize"),
                "max_param_diff_vs_clean": diff,
                "bitexact_vs_clean": diff == 0.0,
                "expect_bitexact": name in EXPECT_BITEXACT,
                # the last application of every step is the clean run's batch
                "replay_exact": dict(t.batch_log) == dict(t_clean.batch_log),
                "wall_s": wall,
            }
            cell["failures"] = cell_failures(cell)
            cells.append(cell)
            print(f"[elastic_bench] {name}: restarts={cell['restarts']} "
                  f"steps_lost={cell['steps_lost']} "
                  f"recovery={cell['recovery_latency_s']:.3f}s "
                  + ("bitexact" if cell["bitexact_vs_clean"] else f"diff={diff:.2e}")
                  + (f" FAILED: {'; '.join(cell['failures'])}" if cell["failures"] else ""),
                  flush=True)

    record = {
        "arch": "fc_mnist",
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "workers": WORKERS,
        "total_steps": TOTAL_STEPS,
        "ckpt_every": CKPT_EVERY,
        "fault_step": FAULT_STEP,
        "smoke": smoke,
        "cells": cells,
        "note": "recovery_latency_s is the host time of the restore and reseek (a rebuild "
                "at the checkpoint's worker count included; builds are cached per count); "
                "steps_lost counts replayed steps; bitexact_vs_clean compares every final "
                "parameter bit against an uninterrupted run from the same seed",
    }
    path = os.path.join(out_dir, "elastic.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[elastic_bench] {len(cells)} cells -> {path}", flush=True)
    failed = [c["plan"] for c in cells if c["failures"]]
    if failed:
        raise RuntimeError(f"elastic bench: cells {failed} failed their bounds")
    return {"elastic": record}
