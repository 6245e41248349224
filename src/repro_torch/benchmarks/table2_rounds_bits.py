"""Paper Table 2 + Figures 2-4: rounds and bits to reach a target accuracy
for SGD / Sparse / LASG / SASG (M=10 simulated workers, paper Section 5.1
hyperparameters: top-1% sparsity, D=10, alpha_d = 1/(2*lr)).

Port of ``benchmarks/table2_rounds_bits.py``, with its settings: 5,120
synthetic samples (``synthetic_classification``, Gaussian mixtures shaped
like MNIST/CIFAR) split 4,096 / 1,024, 10 samples per worker, evaluation
every 20 steps in batches of 512. Two properties of the reference are
kept: one numpy ``rng`` per model feeds the four algorithms in the order
sgd, sparse, lasg, sasg, so each trains on other draws; and every
algorithm starts from the same init (here from a torch seed).

The reference's presets select top-k with ``topk_impl="sharded"`` (per
shard, the unfused reference); ``topk_impl`` overrides it, and the card
runs ``"kernel"``. Every table and ``table2.json`` names the impl. The
paper's two assertions are checked only when SASG reaches the target, as
in the reference; a run that misses says so instead of passing in silence.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.sasg import SASGConfig
from repro_torch.core.selection import SelectionConfig
from repro_torch.data import synthetic_classification
from repro_torch.models import build
from repro_torch.train.step import resolve_device

from .simulator import make_simulator

M = 10
ALGOS = ("sgd", "sparse", "lasg", "sasg")
OUT_DIR = "artifacts/bench_torch"
# (model, steps quick, steps full, lr, target accuracy); cnn_cifar runs
# only with --full
SETTINGS = (("fc_mnist", 300, 800, 0.05, 0.96), ("cnn_cifar", None, 400, 0.02, 0.90))


def _algo_cfg(name: str, k_ratio=0.01, D=10) -> SASGConfig:
    topk = CompressorConfig(name="topk_ef", k_ratio=k_ratio, topk_impl="sharded",
                            block_size=64)
    dense = CompressorConfig(name="identity")
    sel_on = SelectionConfig(enabled=True, max_delay=D, alpha_scale=0.5)
    sel_off = SelectionConfig(enabled=False)
    return {
        "sgd": SASGConfig(compressor=dense, selection=sel_off, name="sgd"),
        "sparse": SASGConfig(compressor=topk, selection=sel_off, name="sparse"),
        "lasg": SASGConfig(compressor=dense, selection=sel_on, name="lasg"),
        "sasg": SASGConfig(compressor=topk, selection=sel_on, name="sasg"),
    }[name]


def algo_config(name: str, topk_impl: Optional[str] = None) -> SASGConfig:
    """The preset of ``name``, its top-k impl replaced by ``topk_impl``."""
    scfg = _algo_cfg(name)
    if topk_impl and scfg.compressor.name == "topk_ef":
        scfg = dataclasses.replace(
            scfg, compressor=dataclasses.replace(scfg.compressor, topk_impl=topk_impl))
    return scfg


@torch.no_grad()
def _accuracy(model, params, x, y, bs=512):
    correct = 0
    for i in range(0, len(x), bs):
        logits = model.prefill(params, {"x": x[i:i + bs]})
        correct += int((logits.argmax(-1) == y[i:i + bs]).sum())
    return correct / len(x)


def run_model(model_name="fc_mnist", steps=400, lr=0.05, target_acc=0.97,
              eval_every=20, seed=0, log=print, topk_impl: Optional[str] = None,
              device=None, on_step: Optional[Callable] = None):
    """Train the four algorithms on ``model_name``; returns ``(results,
    curves)``. ``on_step(algo, t, batches, state)`` sees every step's
    worker batches and the state after it (the card's smoke run steps a
    second simulator in lockstep through it)."""
    device = resolve_device(device)
    cfg = get_config(model_name)
    model = build(cfg)
    shape = (28, 28, 1) if cfg.family == "mlp" else (32, 32, 3)
    xall, yall = synthetic_classification(5120, cfg.vocab_size, shape, seed=seed)
    xtr, ytr = xall[:4096], yall[:4096]
    xte = torch.as_tensor(xall[4096:], device=device)
    yte = torch.as_tensor(yall[4096:], device=device).long()
    rng = np.random.default_rng(seed)

    results = {}
    curves = {}
    for algo in ALGOS:
        scfg = algo_config(algo, topk_impl)
        init, step, _, _ = make_simulator(scfg, model.loss_fn, M, device=device)
        params = model.init(torch.Generator(device=device).manual_seed(seed), device=device)
        state = init(params)
        curve = []
        hit = None
        for t in range(steps):
            idx = rng.integers(0, len(xtr), size=(M, 10))  # 10 samples/worker (paper)
            batches = {"x": xtr[idx], "labels": ytr[idx]}
            state, _ = step(state, batches, lr)
            if on_step is not None:
                on_step(algo, t, batches, state)
            if (t + 1) % eval_every == 0 or t == steps - 1:
                acc = _accuracy(model, state.params, xte, yte)
                curve.append(
                    {"step": t + 1, "acc": acc, "rounds": state.rounds,
                     "bits": state.bits_paper}
                )
                if hit is None and acc >= target_acc:
                    hit = curve[-1]
        final = curve[-1]
        row = {
            "algo": algo,
            "topk_impl": (scfg.compressor.topk_impl
                          if scfg.compressor.name == "topk_ef" else None),
            "rounds_total": final["rounds"],
            "bits_total": final["bits"],
            "final_acc": final["acc"],
            "rounds_to_target": (hit or final)["rounds"],
            "bits_to_target": (hit or final)["bits"],
            "hit_target": hit is not None,
        }
        results[algo] = row
        curves[algo] = curve
        log(f"  {algo:7s} acc={final['acc']:.3f} rounds={final['rounds']:6.0f} "
            f"bits={final['bits']:.3e} (to {target_acc:.0%}: "
            f"rounds={row['rounds_to_target']:.0f} bits={row['bits_to_target']:.3e})"
            + (f" topk_impl={row['topk_impl']}" if row["topk_impl"] else ""))
    return results, curves


def claims(res: dict) -> Optional[dict]:
    """The paper's two claims on one model's results: SASG needs >= 10x
    fewer bits than SGD, and at most 1.05x Sparse's rounds, to the target.
    None when SASG missed its target: the reference checks them only then."""
    sasg = res["sasg"]
    if not sasg["hit_target"]:
        return None
    return {
        "bits_10x_under_sgd": sasg["bits_to_target"] <= res["sgd"]["bits_to_target"] / 10,
        "rounds_within_1.05x_sparse":
            sasg["rounds_to_target"] <= res["sparse"]["rounds_to_target"] * 1.05,
    }


def check_claims(res: dict, log=print) -> bool:
    """Assert the paper's claims (``claims``) when SASG hit its target, as
    the reference does; say so when it did not. Returns whether they were
    checked."""
    log("  hit_target: " + ", ".join(f"{a}={res[a]['hit_target']}" for a in ALGOS))
    c = claims(res)
    if c is None:
        log("  NOT CHECKED: SASG did not reach the target accuracy, so the paper's "
            "two assertions (bits <= SGD / 10, rounds <= 1.05 x Sparse) were not checked")
        return False
    if not c["bits_10x_under_sgd"]:
        raise AssertionError("SASG should cut bits by >=10x vs SGD")
    if not c["rounds_within_1.05x_sparse"]:
        raise AssertionError("SASG rounds should not exceed Sparse")
    log("  ok: SASG reduces bits >=10x vs SGD and rounds <= Sparse")
    return True


def run(quick=True, out_dir=OUT_DIR, log=print, topk_impl="kernel", device=None):
    os.makedirs(out_dir, exist_ok=True)
    log(f"== Table 2 / Figs 2-4: rounds & bits to equal accuracy (M={M}), "
        f"topk_impl={topk_impl} ==")
    all_results = {}
    for name, quick_steps, full_steps, lr, tgt in SETTINGS:
        steps = quick_steps if quick else full_steps
        if steps is None:
            continue
        log(f"[{name}] target acc {tgt:.0%}, {steps} steps, lr {lr}, topk_impl={topk_impl}")
        res, curves = run_model(name, steps=steps, lr=lr, target_acc=tgt, log=log,
                                topk_impl=topk_impl, device=device)
        res["assertions_checked"] = check_claims(res, log)
        all_results[name] = res
        with open(os.path.join(out_dir, f"curves_{name}.json"), "w") as f:
            json.dump(curves, f, indent=1)
    with open(os.path.join(out_dir, "table2.json"), "w") as f:
        json.dump(all_results, f, indent=1)
    log("")
    return {"table2": all_results}


if __name__ == "__main__":
    run(quick=True)
