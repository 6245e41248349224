#!/usr/bin/env python3
"""Where the device memory of a mamba2_370m SASG training step peaks, with
and without remat, on one NVIDIA GPU (``chip_smoke.py`` phase 14 (c)'s
cell: full width and depth, bf16, 4 workers x 1 sequence of 512 tokens).

    python3 tools/memory_peak.py [--tree DIR]

For each remat policy (``none``, ``full``) it records the caching
allocator's history (``torch.cuda.memory._record_memory_history``, Python
frames) over two spans: one gradient evaluation of the step
(``core.sasg.per_worker_grad_fn`` on the model's loss, params shared by
the workers) and one whole SASG step after a first one. It replays each
span's allocations and frees, finds the point where the bytes allocated
in the span are largest, and prints the allocations live there grouped by
their innermost frames in ``repro_torch`` (blocks made by the autograd
engine carry no such frame and are grouped under its own frames or none).
Prints the card's name and power limit first. ``--tree`` names the root
of the checkout to measure (default: the one holding this script).
"""
import argparse
import collections
import subprocess
import sys
from pathlib import Path

ARCH, WORKERS, SEQ = "mamba2_370m", 4, 512


def _where(frames, n=3) -> str:
    own = [f for f in frames if "repro_torch" in f["filename"]] or \
        [f for f in frames if "torch/autograd" in f["filename"]]
    return " < ".join(f"{Path(f['filename']).name}:{f['line']}:{f['name']}" for f in own[:n])


def _recorded(fn):
    """Run ``fn()`` under the allocator's history; returns its result, the
    bytes allocated before it, the allocator's peak during it, and the
    allocations live at the span's largest total, grouped."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
    out = fn()
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    live, cur, best, at = {}, 0, -1, ({}, None)
    for e in snap["device_traces"][0]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > best:
                best, at = cur, (dict(live), e)
        elif e["action"] == "free_requested" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    groups, blocks = collections.Counter(), collections.Counter()
    for e in at[0].values():
        k = _where(e["frames"])
        groups[k] += e["size"]
        blocks[k] += 1
    return out, base, peak, best, _where(at[1]["frames"], 5) if at[1] else "", groups, blocks


def _report(what, base, peak, best, event, groups, blocks):
    print(f"== {what}: allocated before {base} bytes, peak {peak} ({peak - base} above); "
          f"in the span at most {best} bytes, at an allocation in {event}")
    for k, v in groups.most_common(12):
        print(f"   {v / 1e9:8.3f} GB in {blocks[k]:5d} blocks  {k or '(no frame)'}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.sasg import per_worker_grad_fn
    from repro_torch.launch import train as launch
    from repro_torch.models import build
    from repro_torch.train.step import worker_batch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    cfg = get_config(ARCH)
    stream = launch.data_stream(cfg, WORKERS, SEQ)
    for remat in ("none", "full"):
        argv = ["--arch", ARCH, "--algo", "sasg", "--workers", str(WORKERS), "--global-batch",
                str(WORKERS), "--seq-len", str(SEQ), "--steps", "2", "--device", "cuda",
                "--remat", remat]
        built = launch.build_trainer(launch.parse_args(argv), print).built
        state = built.init(seed=0)
        state, _ = built.step(state, stream.batch_at(0))
        grad_fn = per_worker_grad_fn(build(cfg, remat=remat).loss_fn)
        batch = worker_batch(stream.batch_at(1), WORKERS, "cuda")
        grad_fn(state.params, batch, False)   # warm
        res = _recorded(lambda: grad_fn(state.params, batch, False))
        _report(f"remat {remat}: one gradient evaluation", *res[1:])
        del res, batch
        res = _recorded(lambda: built.step(state, stream.batch_at(1)))
        _report(f"remat {remat}: one SASG step", *res[1:])
        del res, built, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
