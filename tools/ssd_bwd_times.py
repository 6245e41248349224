#!/usr/bin/env python3
"""Time the SSD chunk backward kernel on one NVIDIA GPU at the shape of a
mamba2_370m training step (``chip_smoke.py`` phase 14 (c): 4 workers x 1
sequence of 512 tokens, so B = 4, NC = 2, Q = 256, H = 32, P = 64, G = 1,
N = 128).

    python3 tools/ssd_bwd_times.py [--tree DIR] [--evals N] [--errors]

``--tree`` names the root of a checkout whose kernel to time (default: the
one holding this script), so that two trees can be timed in turns within
one session, each in a process of its own (parent, change, change,
parent). Each layer of a gradient evaluation gets its own copy of the
operands, as in training (cold in L2). Prints one JSON line: the tree, the
card's name and power limit, the ms per gradient evaluation (48 launches
captured in a CUDA graph and replayed; and eager), and each sub-kernel's
device time per evaluation from ``torch.profiler``, beside nvcc's
``-Xptxas -v`` lines of the build. ``--errors`` prints instead, for every
case of ``checks.ssd_cases()`` and each of the five gradients, the
kernel's largest gap to the plain version (fp32, on the card) and to the
plain version in float64 (on the CPU), absolute and over max(1, max|x|)
of the float64 gradient.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

LAYERS = 48


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--evals", type=int, default=10, help="gradient evaluations timed")
    ap.add_argument("--errors", action="store_true", help="the kernel's errors, not its time")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch

    if not torch.cuda.is_available():
        print("ssd_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, checks
    from repro_torch.kernels.ssd_scan.ssd_scan_bwd import library, ssd_chunk_bwd_cuda

    library()
    if args.errors:
        return errors(tree, checks, ssd_chunk_bwd_cuda)
    case = checks.SsdCase("train", 4, 512, 32, 64, 1, 128, 256, "model")
    base = checks.ssd_bwd_inputs(case, "cuda")
    layers = [tuple(t.clone() for t in base) for _ in range(LAYERS)]

    def evaluation():
        for ins in layers:
            ssd_chunk_bwd_cuda(*ins)

    def timed(fn, iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            evaluation()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        evaluation()
    graph.replay()
    torch.cuda.synchronize()
    ms = timed(graph.replay, args.evals)
    eager_ms = timed(evaluation, args.evals)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.evals):
            evaluation()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "ssd_bwd" in e.key:
            name = re.search(r"ssd_bwd_\w+", e.key).group(0)
            split[name] = {"ms": e.self_device_time_total / 1e3 / args.evals,
                           "launches": e.count // args.evals}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    ptxas = [line.strip() for line in build.build_log("ssd_scan_bwd").splitlines()
             if "ssd_bwd" in line or "registers" in line or "spill" in line]
    print(json.dumps({"tree": str(tree), "card": smi.stdout.strip(), "layers": LAYERS,
                      "ms": ms, "eager_ms": eager_ms, "split": split, "ptxas": ptxas}),
          flush=True)
    return 0


def errors(tree, checks, kernel) -> int:
    import torch

    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_bwd_ref

    for case in checks.ssd_cases():
        ins = checks.ssd_bwd_inputs(case, "cuda")
        got = kernel(*ins)
        plain = ssd_chunk_bwd_ref(*ins)
        exact = ssd_chunk_bwd_ref(*[t.cpu().double() for t in ins])
        row = {}
        for name, k, p32, p64 in zip(checks.SSD_GRADS, got, plain, exact):
            k, p32 = k.cpu().double(), p32.cpu().double()
            scale = max(1.0, float(p64.abs().max()))
            row[name] = {"vs_plain": float((k - p32).abs().max()),
                         "vs_fp64": float((k - p64).abs().max()),
                         "plain_vs_fp64": float((p32 - p64).abs().max()), "scale": scale}
        print(json.dumps({"tree": str(tree), "case": case.name, "grads": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
