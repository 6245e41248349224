"""Continuous-batching serve benchmark of the port.

Port of ``benchmarks/serve_bench.py``. For each ported serveable arch, the
reduced config through ``BatchedServer`` at a sweep of concurrency levels,
recording tokens/s, tick counts and the cache-memory accounting (the
paged pool's high-water against the dense-equivalent cache). Every paged
cell replays its dense twin's request stream and records whether the
generated tokens are identical (``bitexact_vs_dense``; they must be on the
identity cache dtype). Global-attention archs run dense AND paged; the
recurrent archs (mamba2_370m, recurrentgemma_9b) keep their O(1) dense
states and windowed rings (nothing to page). Writes ``serve.json`` into
the output directory (``artifacts/bench_torch/``), never into the JAX package's
``BENCH_serve.json``:

  PYTHONPATH=src python -m repro_torch.benchmarks.run --serve [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.serve import BatchedServer, Request, build_serve

from .table2_rounds_bits import OUT_DIR

ATTN_ARCHS = ("llama3_8b", "internvl2_2b", "starcoder2_3b")
RECURRENT_ARCHS = ("mamba2_370m", "recurrentgemma_9b")
MAX_SEQ = 64


def _run_server(srv, requests, device):
    for r in requests:
        srv.submit(r)
    t0 = time.perf_counter()
    done, _ = srv.drain(strict=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    stats = srv.cache_stats()
    stats["wall_s"] = dt
    stats["tok_per_s"] = stats["decode_tokens"] / max(dt, 1e-9)
    return {r["uid"]: r["tokens"] for r in done}, stats


def run(smoke: bool = False, out_dir: str = OUT_DIR, device=None, log=print) -> dict:
    device = torch.device(device or "cuda")
    archs = ("internvl2_2b",) if smoke else ATTN_ARCHS + RECURRENT_ARCHS
    concurrency = (2,) if smoke else (2, 4)
    max_new = 4 if smoke else 8

    def requests_for(cfg, n, rng):
        return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(
            rng.integers(5, 13))).astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]

    records = []
    for arch in archs:
        cfg = get_config(arch).reduced()
        model = build(cfg)
        serve = build_serve(model)
        params = model.init(torch.Generator(device=device).manual_seed(0), device)
        # SSD archs need multi-token widths to be scan-chunk multiples
        chunk = cfg.ssm.chunk_size if "ssd" in cfg.attn_pattern else 8
        for conc in concurrency:
            reqs = requests_for(cfg, 2 * conc, np.random.default_rng(0))
            dense_out, dense_stats = _run_server(
                BatchedServer(serve, params, cfg, conc, MAX_SEQ, paged=False,
                              prefill_chunk=chunk), reqs, device)
            dense_stats.update(arch=arch, concurrency=conc)
            records.append(dense_stats)
            if serve.init_paged_cache is None:
                continue
            paged_out, paged_stats = _run_server(
                BatchedServer(serve, params, cfg, conc, MAX_SEQ, paged=True, block_size=16,
                              prefill_chunk=chunk), reqs, device)
            exact = paged_out == dense_out
            paged_stats.update(arch=arch, concurrency=conc, bitexact_vs_dense=exact)
            records.append(paged_stats)
            log(f"[serve_bench] {arch} conc={conc}: dense {dense_stats['tok_per_s']:.1f} "
                f"tok/s, paged {paged_stats['tok_per_s']:.1f} tok/s "
                f"({'bitexact' if exact else 'MISMATCH'}, "
                f"{paged_stats['high_water_bytes']:.0f}B high-water vs "
                f"{paged_stats['dense_equiv_bytes']:.0f}B dense)")
        if serve.init_paged_cache is None:
            log(f"[serve_bench] {arch}: dense-only (recurrent state, nothing to page)")

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    record = {"device": name, "max_seq": MAX_SEQ, "max_new_tokens": max_new,
              "smoke": smoke, "cells": records}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serve.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    log(f"[serve_bench] {len(records)} cells -> {path}")
    bad = [r["arch"] for r in records if r.get("bitexact_vs_dense") is False]
    if bad:
        raise RuntimeError(f"paged tokens differ from the dense run's: {bad}")
    return {"serve": record}
