#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each on lines of its own:

  1. environment: the card, its power limit, torch and CUDA versions;
  2. build: nvcc builds the port's kernels from ``src/repro_torch/csrc``
     and prints ptxas's registers / shared memory / spills;
  3. every kernel against its plain PyTorch version on the card, bitwise,
     at the main path's shapes and at the edges (ties, zeros, bc up to
     2048, kb = bc, lr != 1);
  4. the main path: cnn_cifar at full width, SASG, 10 workers x 10
     samples, lr 0.02, 20 steps through ``repro_torch.launch.train``, with
     the kernel launches counted; then the same 20 steps with the kernel and
     with ``topk_impl="reference"`` in lockstep, held bitwise equal; then
     fc_mnist with sgd and lasg (the identity exchange);
  5. times: each kernel per training step beside its bound, its plain
     version and a library call; the step time and the peak memory.

Prints a JSON line of the kernels, then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
there is no CUDA device, no checkout around it, or any phase fails.
"""
import os

# deterministic cuBLAS, set before CUDA initialises (the lockstep run of
# phase 4 compares two runs bitwise)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
WORKERS, PER_WORKER, LR, STEPS = 10, 10, 0.02, 20


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around many calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of ``fn`` in ms without the host's launch overhead: ``fn``
    is captured once into a CUDA graph and the graph replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    import torch

    name = torch.cuda.get_device_name(0)
    log(f"device {name} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return name, card


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_ef.topk_ef import library

    t0 = time.perf_counter()
    library()
    log(f"built csrc/topk_ef.cu in {time.perf_counter() - t0:.1f} s")
    # ptxas -v, one line per kernel instantiation: registers, stack, spills
    entry = None
    for line in build.build_log("topk_ef").splitlines():
        m = re.search(r"Compiling entry function '.*?topk_rows_kernelILi(\d+)ELb([01])", line)
        if m:
            entry = f"topk_rows_kernel<VPL={m.group(1)}, EF={m.group(2)}>"
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "registers" in line:
            print(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}; {spills}", flush=True)
            entry = None


def phase_kernels():
    from repro_torch.kernels import checks

    err = {"topk_ef": 0.0, "block_topk": 0.0}
    cases = checks.cases(WORKERS)
    for case in cases:
        e1 = checks.check_topk_ef(case)
        e2 = checks.check_block_topk(case)
        err["topk_ef"] = max(err["topk_ef"], e1)
        err["block_topk"] = max(err["block_topk"], e2)
        log(f"bitwise ok: {case.name:24s} rows={case.rows:6d} kind={case.kind:6s} "
            f"lr={case.lr}")
    log(f"phase 3: {len(cases)} cases x 2 kernels bitwise equal to the plain versions")
    return err


def _final_params_equal(a, b) -> bool:
    import torch

    from repro_torch.core.types import tree_leaves

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_main_path():
    import torch

    from repro_torch.kernels.block_topk import block_topk
    from repro_torch.kernels.topk_ef import topk_ef
    from repro_torch.launch import train as launch

    argv = ["--arch", "cnn_cifar", "--algo", "sasg", "--workers", str(WORKERS),
            "--global-batch", str(WORKERS * PER_WORKER), "--lr", str(LR),
            "--steps", str(STEPS), "--device", "cuda"]
    torch.use_deterministic_algorithms(True)
    torch.cuda.reset_peak_memory_stats()
    topk_ef.LAUNCHES.reset()
    block_topk.LAUNCHES.reset()
    trainer, state = launch.train(argv, log_fn=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    launches = {"topk_ef": topk_ef.LAUNCHES.count, "block_topk": block_topk.LAUNCHES.count}
    peak = torch.cuda.max_memory_allocated()

    n_leaves = 37
    want = n_leaves * (STEPS + 1)  # one encode per step + one zero_payload
    log(f"main path launches: topk_ef {launches['topk_ef']} (expected {want} = "
        f"{n_leaves} leaves x ({STEPS} steps + 1)), block_topk {launches['block_topk']}")
    if launches["topk_ef"] != want:
        fail(f"topk_ef launched {launches['topk_ef']} times, expected {want}")
    hist = trainer.history
    if len(hist) != STEPS or not all(math.isfinite(r["loss"]) for r in hist):
        fail("main path loss is not finite")
    rounds = hist[-1]["rounds_total"]
    if not 0 < rounds <= WORKERS * STEPS or hist[0]["num_sent"] != WORKERS:
        fail(f"implausible rounds {rounds} / first-step sends {hist[0]['num_sent']}")
    if hist[-1]["bits_paper_total"] != rounds * 1_132_736:
        fail("bits_paper_total != rounds x 1,132,736 (cnn_cifar top-1% payload)")
    log(f"main path: {STEPS} steps, loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
        f"rounds {rounds:.0f}/{WORKERS * STEPS}, peak memory {peak / 2**20:.1f} MiB")
    return trainer, state, launches, peak


def phase_lockstep(arch, lr, state_main=None, want_skips=False):
    """Kernel and reference impls step by step from the same init, held
    bitwise equal every step (sends, counters, loss, params, taus); with
    ``state_main`` the kernel run must also equal the main path's run."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    args = launch.parse_args(["--arch", arch, "--algo", "sasg"])
    cfg = get_config(arch)
    model = build(cfg)
    built = {}
    for impl in ("kernel", "reference"):
        scfg = launch.sasg_config_from_args(args)
        scfg = dataclasses.replace(
            scfg, compressor=dataclasses.replace(scfg.compressor, topk_impl=impl))
        built[impl] = build_train_step(model, scfg, WORKERS, constant(lr), device="cuda")
    states = {impl: b.init(seed=0) for impl, b in built.items()}
    stream = launch.data_stream(cfg, WORKERS * PER_WORKER)
    step_s = {"kernel": [], "reference": []}
    sent = []
    for step in range(STEPS):
        batch = stream.batch_at(step)
        mets = {}
        for impl in ("kernel", "reference"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[impl], m = built[impl].step(states[impl], batch)
            torch.cuda.synchronize()
            step_s[impl].append(time.perf_counter() - t0)
            mets[impl] = {k: float(v) for k, v in m.items()}
        if mets["kernel"] != mets["reference"]:
            fail(f"{arch} step {step}: metrics differ kernel {mets['kernel']} "
                 f"vs reference {mets['reference']}")
        if not _final_params_equal(states["kernel"].params, states["reference"].params):
            fail(f"{arch} step {step}: params differ between the kernel and reference runs")
        if not torch.equal(states["kernel"].wstate.tau, states["reference"].wstate.tau):
            fail(f"{arch} step {step}: staleness counters differ")
        sent.append(int(mets["kernel"]["num_sent"]))
    if state_main is not None and not _final_params_equal(states["kernel"].params,
                                                          state_main.params):
        fail("the lockstep kernel run differs from the main run (not deterministic)")
    if want_skips and min(sent) == WORKERS:
        fail(f"{arch} lr={lr}: no worker skipped, the stale-payload path did not run")
    log(f"lockstep {arch} sasg lr={lr}: {STEPS} steps, kernel == reference bitwise "
        f"(sends, counters, loss, params, taus each step)"
        + ("; kernel run == main run bitwise" if state_main is not None else "")
        + f"; sends per step {sent}")
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in step_s.items()}
    log(f"step time {arch} (host clock around synchronize, median of steps "
        f"1..{STEPS - 1}): kernel {med['kernel']:.2f} ms, reference {med['reference']:.2f} ms")
    return med


def phase_identity_exchange():
    from repro_torch.launch import train as launch

    for algo in ("sgd", "lasg"):
        trainer, _ = launch.train(
            ["--arch", "fc_mnist", "--algo", algo, "--workers", "4", "--steps", "3",
             "--lr", "0.05", "--device", "cuda"], log_fn=lambda m: None)
        losses = [r["loss"] for r in trainer.history]
        if not all(math.isfinite(x) for x in losses):
            fail(f"fc_mnist {algo}: loss not finite {losses}")
        log(f"fc_mnist {algo}: 3 steps, losses {[round(x, 4) for x in losses]}, "
            f"rounds {trainer.history[-1]['rounds_total']:.0f}")


def phase_times():
    import torch

    from repro_torch.kernels import checks
    from repro_torch.kernels.block_topk.block_topk import block_topk_cuda
    from repro_torch.kernels.block_topk.ref import block_topk_ref
    from repro_torch.kernels.topk_ef.ref import topk_ef_ref
    from repro_torch.kernels.topk_ef.topk_ef import topk_ef_cuda

    views = checks.leaf_views("cnn_cifar", WORKERS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = [(torch.randn((v.rows, v.bc), generator=gen, device="cuda"),
               0.01 * torch.randn((v.rows, v.bc), generator=gen, device="cuda"))
              for v in views]
    corrected = [g + e for g, e in inputs]

    def run_kernel():
        for v, (g, e) in zip(views, inputs):
            topk_ef_cuda(g, e, 1.0, v.kb)

    def run_plain():
        for v, (g, e) in zip(views, inputs):
            topk_ef_ref(g, e, 1.0, v.kb)

    def run_library():
        for v, c in zip(views, corrected):
            c.gather(-1, torch.topk(c.abs(), v.kb, dim=-1).indices)

    def run_bt_kernel():
        for v, c in zip(views, corrected):
            block_topk_cuda(c, v.kb)

    def run_bt_plain():
        for v, c in zip(views, corrected):
            block_topk_ref(c, v.kb)

    elems = sum(v.rows * v.bc for v in views)
    picks = sum(v.rows * v.kb for v in views)
    cmp_ops = sum(v.rows * v.bc * v.kb for v in views)
    bounds = {
        # read grad + err, write new_err; write (value, index) per pick.
        # ops: lr*grad + err (2) and one compare per element per round
        "topk_ef": (12 * elems + 8 * picks, 2 * elems + cmp_ops),
        "block_topk": (4 * elems + 8 * picks, cmp_ops),
    }
    # device time: each function's 37 launches captured in a CUDA graph and
    # replayed; eager: the same launches from Python, which is what the
    # training step pays. The library call (torch.topk + gather on g) is the
    # yardstick of both kernels; the port never calls it.
    fns = {"topk_ef": (run_kernel, run_plain), "block_topk": (run_bt_kernel, run_bt_plain)}
    library = (graph_ms(run_library, 50), cuda_ms(run_library, 20))
    out = {}
    for name, (nbytes, ops) in bounds.items():
        kernel = (graph_ms(fns[name][0], 100), cuda_ms(fns[name][0], 50))
        plain = (graph_ms(fns[name][1], 10), cuda_ms(fns[name][1], 5))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        out[name] = {
            "ms": kernel[0], "plain_ms": plain[0], "library_ms": library[0],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        log(f"{name}: {kernel[0]:.4f} ms per step on the device ({len(views)} launches, "
            f"{nbytes / 1e6:.1f} MB; eager {kernel[1]:.4f} ms) vs bound "
            f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}, "
            f"{HBM_BYTES_PER_S / 1e12} TB/s); plain {plain[0]:.3f} ms (eager "
            f"{plain[1]:.3f}); torch.topk+gather {library[0]:.3f} ms (eager {library[1]:.3f})")
    for v, (g, e) in zip(views, inputs):
        ms = graph_ms(lambda: topk_ef_cuda(g, e, 1.0, v.kb), 50)
        b = (12 * v.rows * v.bc + 8 * v.rows * v.kb) / HBM_BYTES_PER_S * 1e3
        log(f"  topk_ef leaf {v.path:16s} rows={v.rows:6d} bc={v.bc:3d} kb={v.kb} "
            f"{ms * 1e3:8.2f} us (bound {b * 1e3:7.2f} us)")
    return out


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc" / "topk_ef.cu").is_file():
        fail(f"no checkout around {ROOT}: src/repro_torch is missing")
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")

    name, card = phase_environment()
    phase_build()
    errs = phase_kernels()
    trainer, state, launches, peak = phase_main_path()
    step_ms = phase_lockstep("cnn_cifar", LR, state_main=state)
    # fc_mnist at lr 0.1 skips uploads within 20 steps: the stale-payload
    # branch of the exchange runs on the card too
    phase_lockstep("fc_mnist", 0.1, want_skips=True)
    phase_identity_exchange()
    times = phase_times()
    log(f"card {card}: step {step_ms['kernel']:.2f} ms, peak memory {peak} bytes")

    sources = {
        "topk_ef": "src/repro/kernels/topk_ef/topk_ef.py:32",
        "block_topk": "src/repro/kernels/block_topk/block_topk.py:23",
    }
    kernels = [
        {
            "name": k, "route": "cuda", "source": "src/repro_torch/csrc/topk_ef.cu",
            "replaces": sources[k], "launches": launches[k],
            "max_abs_err": errs[k], "ms": times[k]["ms"],
            "plain_ms": times[k]["plain_ms"], "bound_ms": times[k]["bound_ms"],
            "bound_by": times[k]["bound_by"], "library_ms": times[k]["library_ms"],
        }
        for k in ("topk_ef", "block_topk")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
