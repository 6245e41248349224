"""Figures 2-4: test accuracy against rounds and bits, from the curves the
Table-2 run writes, as JSON and as ASCII sparklines.

Port of ``benchmarks/fig_curves.py``."""
import json
import os

OUT_DIR = "artifacts/bench_torch"


def _spark(vals, width=40):
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    rng = (hi - lo) or 1.0
    chars = ".:-=+*#%@"
    idx = [int((v - lo) / rng * (len(chars) - 1)) for v in vals]
    return "".join(chars[i] for i in idx[:width])


def run(out_dir=OUT_DIR, log=print):
    log("== Figs 2-4: accuracy vs rounds/bits ==")
    any_found = False
    for name in ("fc_mnist", "cnn_cifar"):
        path = os.path.join(out_dir, f"curves_{name}.json")
        if not os.path.exists(path):
            continue
        any_found = True
        with open(path) as f:
            curves = json.load(f)
        log(f"[{name}] accuracy over evaluation points:")
        for algo, pts in curves.items():
            accs = [p["acc"] for p in pts]
            rounds = pts[-1]["rounds"] if pts else 0
            bits = pts[-1]["bits"] if pts else 0
            log(f"  {algo:7s} {_spark(accs)}  final acc={accs[-1]:.3f} "
                f"rounds={rounds:6.0f} bits={bits:.2e}")
    if not any_found:
        log("  (no curves yet — table2 must run first)")
    log("")
    return {"fig_curves": any_found}


if __name__ == "__main__":
    run()
