"""The port's optimizer transforms and the ``fold_lr=False`` training step,
against the JAX package's.

Transforms on the same gradient trees over five steps (jitted on the JAX
side, as its training step runs them):

- sgd and momentum (with and without nesterov): bitwise. XLA's CPU backend
  contracts ``beta * m + g`` into an FMA, and the port writes it as
  ``torch.add(g, m, alpha=beta)``, whose vector path is the same FMA;
- AdamW (with weight decay) and clip + AdamW: within ``ADAM_TOL`` of the
  largest update (measured 1.2e-7 and 2.9e-7: the square root and the
  division round differently, and the clip's global norm is a reduction
  whose order differs).

Whole steps against ``repro.train.build_train_step`` on the 4x1 mesh, as
``test_torch_train_step.py`` runs them (fc_mnist, PRNGKey(2) params): SASG
with ``fold_lr=False`` and momentum, and with clip + AdamW, sends and
counters exact and params within that file's top-k tier (2e-2); SASG with
``probe_fraction=0.5`` (the rule on the first sample of each worker's two),
sends and counters exact, params within the same tier.

Selection knobs: the step's straggler mask (``force_skip``) decides per
worker as JAX's rule does for one worker, exactly; ``deadline_skip=True``
is refused (the JAX package reads it nowhere; the fault plan's straggler
fault drives ``force_skip``), with a message naming that fault.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.core.sasg import PRESETS as JAX_PRESETS
from repro.data import indexed_classification_stream, synthetic_classification
from repro.dist.strategy import choose_strategy
from repro.models import build as jax_build
from repro.optim import constant as jax_constant, optimizers as JO
from repro.optim import step_decay as jax_step_decay
from repro.train import build_train_step as jax_build_train_step
from repro_torch.configs import get_config
from repro_torch.core.sasg import PRESETS
from repro_torch.core.types import tree_leaves
from repro_torch.models import build, params_from_numpy
from repro_torch.optim import constant, step_decay
from repro_torch.optim import optimizers as TO
from repro_torch.train import build_train_step

M, LR = 4, 0.05
ADAM_TOL = 1e-6
TOPK_PARAM_TOL = 2e-2

TRANSFORMS = {
    "sgd": (lambda O: O.sgd(0.1), 0.0),
    "scale_by_lr_schedule": (lambda O: O.scale_by_lr(
        (jax_step_decay if O is JO else step_decay)(0.1, [2], 0.5)), 0.0),
    "momentum": (lambda O: O.momentum(0.02, 0.9), 0.0),
    "nesterov": (lambda O: O.momentum(0.02, 0.9, nesterov=True), 0.0),
    "adamw": (lambda O: O.adamw(1e-3, weight_decay=0.01), ADAM_TOL),
    "clip_adamw": (lambda O: O.chain(O.clip_by_global_norm(1.0), O.adamw(1e-3)), ADAM_TOL),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    make, tol = TRANSFORMS[name]
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(50, 40)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    jo, to = make(JO), make(TO)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    jupdate = jax.jit(jo.update)
    for step in range(5):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        ju, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        for k in params:
            a, b = np.asarray(ju[k]), tu[k].numpy()
            assert b.dtype == np.float32
            np.testing.assert_allclose(b, a, rtol=0, atol=tol * np.abs(a).max(),
                                       err_msg=f"{name} step {step} leaf {k}")
    for a, b in zip(jax.tree.leaves(js), tree_leaves(ts)):
        if np.asarray(a).dtype == np.int32:
            assert int(np.asarray(a)) == int(b)   # step counts


def test_fold_lr_false_needs_an_optimizer():
    scfg = dataclasses.replace(PRESETS["sasg"](), fold_lr=False)
    with pytest.raises(ValueError, match="optimizer"):
        build_train_step(build(get_config("fc_mnist")), scfg, M, constant(LR), device="cpu")


def test_force_skip_mask_matches_jax():
    """A forced worker skips unless its staleness hit the cap D; the port's
    (M,) decision equals JAX's rule evaluated for each worker."""
    from repro.core import selection as JS
    from repro_torch.core import selection as TS

    D = 4
    g_new = np.random.default_rng(0).normal(size=(M, 8)).astype(np.float32)
    g_stale = np.zeros_like(g_new)
    g_stale[1:3] = g_new[1:3]                     # workers 1, 2 under the threshold
    tau = np.array([1, 4, 2, 4], np.int32)        # workers 1, 3 at the cap
    window = np.full(D, 0.5, np.float32)
    for force in ([True] * M, [True, False, True, False], [False] * M):
        got = TS.should_send(
            TS.SelectionConfig(max_delay=D), {"w": torch.from_numpy(g_new)},
            {"w": torch.from_numpy(g_stale)},
            TS.SelectionState(torch.from_numpy(tau), torch.from_numpy(window)),
            torch.ones(D), M, torch.tensor(force), batch_dims=1)
        want = [bool(JS.should_send(
            JS.SelectionConfig(max_delay=D), {"w": jnp.asarray(g_new[m])},
            {"w": jnp.asarray(g_stale[m])},
            JS.SelectionState(jnp.asarray(tau[m]), jnp.asarray(window)),
            jnp.ones(D), M, force_skip=jnp.asarray(force[m]))) for m in range(M)]
        assert got.tolist() == want, force


def test_deadline_skip_is_refused_until_the_fault_plan_is_ported():
    scfg = PRESETS["sasg"]()
    scfg = dataclasses.replace(scfg, selection=dataclasses.replace(scfg.selection,
                                                                   deadline_skip=True))
    with pytest.raises(NotImplementedError, match="deadline_skip.*straggler"):
        build_train_step(build(get_config("fc_mnist")), scfg, M, constant(LR), device="cpu")


def _run_pair(scfg_kw, sel_kw, make_opt, steps, lr):
    jcfg, tcfg = jax_get_config("fc_mnist"), get_config("fc_mnist")
    jscfg, tscfg = JAX_PRESETS["sasg"](), PRESETS["sasg"]()
    jscfg = dataclasses.replace(jscfg, selection=dataclasses.replace(jscfg.selection, **sel_kw),
                                **scfg_kw)
    tscfg = dataclasses.replace(tscfg, selection=dataclasses.replace(tscfg.selection, **sel_kw),
                                **scfg_kw)
    mesh = compat.make_mesh((M, 1), ("data", "model"), devices=jax.devices()[:M])
    strategy = choose_strategy(mesh, sasg_enabled=True)
    jbuilt = jax_build_train_step(jax_build(jcfg), jscfg, mesh, strategy, jax_constant(lr),
                                  optimizer=make_opt(JO) if make_opt else None)
    tbuilt = build_train_step(build(tcfg), tscfg, M, constant(lr), device="cpu",
                              optimizer=make_opt(TO) if make_opt else None)
    jstate = jbuilt.init(jax.random.PRNGKey(2))
    tstate = tbuilt.init(params=params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    xs, ys = synthetic_classification(256, 10, (28, 28, 1), seed=0)
    stream = indexed_classification_stream(xs, ys, 2 * M, seed=0)
    rows = []
    for step in range(steps):
        batch = stream.batch_at(step)
        jstate, jm = jbuilt.jit_step(jstate, batch)
        tstate, tm = tbuilt.step(tstate, batch)
        diff = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
                   for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)))
        rows.append(({k: float(v) for k, v in tm.items()},
                     {k: float(v) for k, v in jm.items()}, diff))
    return rows, tstate, jstate


RUNS = {
    "momentum": ({"fold_lr": False}, {}, lambda O: O.momentum(LR, 0.9), 4, LR),
    "clip_adamw": ({"fold_lr": False}, {},
                   lambda O: O.chain(O.clip_by_global_norm(1.0), O.adamw(1e-3)), 4, LR),
    "probe_half": ({}, {"probe_fraction": 0.5}, None, 8, 0.1),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def pair(request):
    return request.param, _run_pair(*RUNS[request.param])


def test_whole_step_matches_jax(pair):
    name, (rows, tstate, jstate) = pair
    for step, (tm, jm, diff) in enumerate(rows):
        for key in ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total", "lr"):
            assert tm[key] == jm[key], (name, step, key)
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
        assert diff < TOPK_PARAM_TOL, (name, step, diff)
    np.testing.assert_array_equal(tstate.wstate.tau.numpy(), np.asarray(jstate.wstate.tau))
    if name != "probe_half":
        # the optimizer state came along: its step count is the run's
        counts = [int(x) for x in tree_leaves(tstate.opt_state) if x.dtype == torch.int32]
        assert counts and all(c == len(rows) for c in counts), counts
