"""The port's RG-LRU hybrid (recurrentgemma_9b) against the JAX package's,
on the reduced config (fp32), with params carried by ``params_from_numpy``
and numpy inputs from a seed.

Tolerances (of the reference's largest magnitude):
- ``rglru_scan``: 1e-6 of max|h|. The port writes out
  ``lax.associative_scan``'s recursion (the same pairings, in the same
  order): bitwise equal to the eager JAX scan at S = 1, 2, 37 and 64. The
  test runs the JAX scan jitted (eager, the recursion dispatches op by
  op), where XLA contracts ``a2 * b1 + b2`` into FMAs: measured up to
  1.25e-7 of max|h|.
- the block, forward logits, loss and each gradient leaf: 1e-5. The same
  fp32 algebra with the products summed in other orders; measured ~1e-6.
- the chained prefill + decode against the full forward: 1e-4, as the JAX
  package's ``test_parity_rglru_close`` (the decode step is the one-step
  recurrence, the prefill the scan).
- the engine's tokens: equal to the JAX engine's.

One test item running every check: the suite's item count sets
pytest-xdist's chunk sizes under ``--dist load``, and one more item per
file moved the long JAX pipeline tests onto one worker (see ROADMAP.md).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.models import lm as JLM
from repro.models import rglru as JR
from repro.serve import BatchedServer as JaxServer
from repro.serve import Request as JaxRequest
from repro.serve import build_serve as jax_build_serve
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.sasg import per_worker_grad_fn
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models import build, params_from_numpy
from repro_torch.models import lm as TLM
from repro_torch.models import rglru as TR
from repro_torch.serve import BatchedServer, Request, build_serve, reset_slots, select_slots
from repro_torch.serve.scheduler import DECODE, PREFILL

ARCH = "recurrentgemma_9b"
TOL = 1e-5
SCAN_TOL = 1e-6


def _close(got: torch.Tensor, want, tol=TOL) -> float:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    return err


def _pair():
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jmodel, jparams, build(tcfg), tparams


def _check_scan_and_block():
    """``rglru_scan`` with and without h0 at S = 1, 2, 37, 64 (odd and even
    lengths at every level of the recursion); then ``rglru_block_apply``
    from no state (prefill), from a state with S > 1 (a chunk continuing a
    sequence: the scan with h0 folded in) and with S = 1 (the one-step
    decode branch), outputs and new states."""
    jax_scan = jax.jit(JR.rglru_scan)     # eager, the recursion dispatches op by op
    for s in (1, 2, 37, 64):
        rng = np.random.default_rng(s)
        a = rng.uniform(0.5, 1.0, (2, s, 64)).astype(np.float32)
        b = rng.normal(size=(2, s, 64)).astype(np.float32)
        h0 = rng.normal(size=(2, 64)).astype(np.float32)
        for init in (None, h0):
            want = jax_scan(jnp.asarray(a), jnp.asarray(b),
                            None if init is None else jnp.asarray(init))
            got = TR.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                None if init is None else torch.from_numpy(init))
            _close(got, want, SCAN_TOL)

    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = JR.rglru_block_init(jax.random.PRNGKey(5), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["lam"].dtype == torch.float32 and sorted(tp) == sorted(jp)
    own = TR.rglru_block_init(torch.Generator().manual_seed(0), tcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    assert 0.7 <= float(own["lam"].min()) and float(own["lam"].max()) <= 1.3
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    state = {"h": rng.normal(size=(2, 128)).astype(np.float32),
             "conv": rng.normal(size=(2, 3, 128)).astype(np.float32)}
    jax_block = jax.jit(JR.rglru_block_apply, static_argnums=1)
    for xs, st in ((x, None), (x, state), (x[:, :1], state)):
        jst = None if st is None else jax.tree.map(jnp.asarray, st)
        tst = None if st is None else tree_map(torch.from_numpy, st)
        yj, nj = jax_block(jp, jcfg, jnp.asarray(xs), jst)
        yt, nt = TR.rglru_block_apply(tp, tcfg, torch.from_numpy(xs), tst)
        _close(yt, yj)
        _close(nt["h"], nj["h"])
        _close(nt["conv"], nj["conv"])
        assert nt["h"].dtype == torch.float32


def _check_reduced_model_and_training(pair):
    """The configs field by field; the params tree, shapes and dtypes of
    the port's own init; forward logits; loss and every gradient leaf; the
    per-worker gradients of the SASG step (``torch.func.vmap`` of
    ``grad_and_value``) over 2 stacked workers, shared and stacked params,
    each worker's equal to its own unvmapped gradient; then 1 SASG step
    through the training launcher."""
    assert ARCH in ARCH_IDS
    for reduce in (False, True):
        jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), reduce
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = pair
    assert tcfg.attn_pattern == ("rglru", "rglru", "local") and tcfg.n_layers == 6
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert [(tuple(x.shape), x.dtype) for x in jax.tree.leaves(own)] == [
        (tuple(x.shape), x.dtype) for x in jax.tree.leaves(tparams)]

    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 2, 12)).astype(np.int32)
    lj, _ = JLM.lm_forward(jparams, jcfg, jnp.asarray(toks[0]))
    lt, _ = TLM.lm_forward(tparams, tcfg, torch.from_numpy(toks[0]))
    _close(lt, lj)

    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    lj, gj = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, jax.tree.map(lambda v: jnp.asarray(v[0]), batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gt, lt = torch.func.grad_and_value(tmodel.loss_fn)(
        tparams, {k: v[0] for k, v in tbatch.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    jleaves = jax.tree.leaves(gj)
    assert len(jleaves) == len(tree_leaves(gt))
    for a, b in zip(jleaves, tree_leaves(gt)):
        _close(b, a)

    grad_fn = per_worker_grad_fn(tmodel.loss_fn)
    g1, _ = torch.func.grad_and_value(tmodel.loss_fn)(
        tparams, {k: v[1] for k, v in tbatch.items()})
    stacked = tree_map(lambda x: torch.stack([x, x]), tparams)
    for params, is_stacked in ((tparams, False), (stacked, True)):
        loss, grads = grad_fn(params, tbatch, is_stacked)
        assert loss.shape == (2,) and float(loss[0]) == pytest.approx(float(lt), rel=1e-6)
        for w, want in ((0, gt), (1, g1)):
            for a, b in zip(tree_leaves(want), tree_leaves(grads)):
                _close(b[w], a.numpy(), 1e-6)

    from repro_torch.launch import train as launch

    lines = []
    trainer, _ = launch.train(["--arch", ARCH, "--reduced", "--algo", "sasg", "--workers", "2",
                               "--global-batch", "4", "--seq-len", "8", "--steps", "1",
                               "--lr", "1.0", "--device", "cpu"], log_fn=lines.append)
    assert f"arch={ARCH}" in lines[0]
    assert np.isfinite(trainer.history[0]["loss"]) and trainer.history[0]["num_sent"] == 2


def _check_chain(pair):
    """The port's counterpart of tests/test_serve_engine.py::
    test_parity_rglru_close: an 8-token prefill at per-slot position 0
    then 4 one-token steps through ``decode_step`` from ``init_cache``,
    against the full forward (1e-4) and against the JAX chain (1e-5),
    cache leaves too. ``Model.prefill`` against the JAX package's; the
    local layers' ring is min(max_seq, 2 * window) slots; nothing to page."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = pair
    B, S, N = 2, 8, 4
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (B, S + N)).astype(np.int32)
    full, _ = TLM.lm_forward(tparams, tcfg, torch.from_numpy(toks))

    def chain(step, cache, to):
        logits, cache = step(cache, to(toks[:, :S]), to(np.zeros((B,), np.int32)))
        outs = [logits]
        for t in range(S, S + N):
            logits, cache = step(cache, to(toks[:, t:t + 1]), to(np.full((B,), t, np.int32)))
            outs.append(logits)
        return outs, cache

    touts, tcache = chain(lambda c, x, p: tmodel.decode_step(tparams, c, x, p),
                          tmodel.init_cache(B, S + N), torch.from_numpy)
    chained = torch.cat(touts, 1)
    np.testing.assert_allclose(chained.numpy(), full.numpy(), atol=1e-4, rtol=1e-4)
    jstep = jax.jit(lambda c, x, p: jmodel.decode_step(jparams, c, x, p))
    jouts, jcache = chain(jstep, jmodel.init_cache(B, S + N), jnp.asarray)
    _close(chained, np.concatenate([np.asarray(x) for x in jouts], axis=1))
    for a, b in zip(jax.tree.leaves(jcache), jax.tree.leaves(tcache)):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)

    lj, cj = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    lt, ct = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S])})
    _close(lt, lj)
    for a, b in zip(jax.tree.leaves(cj), jax.tree.leaves(ct)):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)
    cache = tmodel.init_cache(B, 1024)
    assert tuple(cache["unit"][2]["k"].shape[:3]) == (2, B, 2 * tcfg.window)
    assert tuple(cache["unit"][0]["h"].shape) == (2, B, 128)
    assert tuple(cache["unit"][0]["conv"].shape) == (2, B, 3, 128)
    assert tmodel.init_paged_cache is None


def _slot_ops_reach_every_recurrent_leaf():
    """4 layers: one stacked unit (rglru, rglru, local) and one rglru in
    ``rem``. ``reset_slots`` zeroes a recycled row's h and conv in both and
    sets its pos rows to -1; ``select_slots`` keeps a frozen row's old h
    and conv in both and takes the active row's new ones."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=4)
    model = build(cfg)
    cache = tree_map(lambda x: torch.ones_like(x) if x.dtype != torch.int32 else x + 5,
                     model.init_cache(2, 16))
    assert "h" in cache["rem"][0] and "h" in cache["unit"][0]
    reset = reset_slots(cache, torch.tensor([False, True]))
    new = tree_map(lambda x: x * 3, cache)
    sel = select_slots(new, cache, torch.tensor([True, False]))
    rows = [(st, lambda x, r: x[:, r]) for st in (0, 1)] + [("rem", lambda x, r: x[r])]
    for where, row in rows:
        for key in ("h", "conv"):
            got = reset["rem"][0][key] if where == "rem" else reset["unit"][where][key]
            assert (row(got, 1) == 0).all() and (row(got, 0) == 1).all()
            got = sel["rem"][0][key] if where == "rem" else sel["unit"][where][key]
            assert (row(got, 0) == 3).all() and (row(got, 1) == 1).all()
    assert (reset["unit"][2]["pos"][:, 1] == -1).all()
    assert (reset["unit"][2]["pos"][:, 0] == 4).all()


def _check_engine(pair, mesh2d):
    """Reduced recurrentgemma_9b through ``BatchedServer`` (``paged=None``:
    no global layer, so the dense cache) against the JAX engine: 3 slots,
    5 requests, widths 8, 4, 2, 1, with a tick that runs a prefilling slot
    and a decoding slot beside an empty row, and chunked ticks that freeze
    a decoding slot; tokens and stats equal. Then the recycled-slot case of tests/test_serve_engine.py::
    test_recycled_slot_matches_fresh_engine[recurrentgemma_9b] on the port,
    the slot ops on every recurrent leaf, ``paged=True`` refused, and the
    serving launcher."""
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = pair
    jserve = jax_build_serve(jmodel, mesh2d, fsdp="data", tp="model")
    jsrv = JaxServer(jserve, jax.device_put(jparams, jserve.param_shardings), jcfg, 3, 32)
    tsrv = BatchedServer(build_serve(tmodel), tparams, tcfg, 3, 32)
    assert not tsrv.paged and not jsrv.paged
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 5, 12, 3, 6)]
    for uid, p in enumerate(prompts):
        jsrv.submit(JaxRequest(uid, p, 4))
        tsrv.submit(Request(uid, p, 4))
    jdone, _ = jsrv.drain(strict=True)
    mixed = frozen_in_flight = 0
    while True:
        # a slot admitted at the tick is empty before it and prefills in it
        states = [PREFILL if s is None else s.state for s in tsrv.scheduler.slots]
        if not tsrv.tick():
            break
        plan = tsrv.last_tick.plan
        kinds = {states[i] for i in plan.active}
        mixed += len(plan.active) < 3 and {PREFILL, DECODE} <= kinds
        frozen_in_flight += plan.width > 1 and DECODE in states
    assert mixed and frozen_in_flight, (mixed, frozen_in_flight)
    tdone = tsrv.completed
    assert {r["uid"]: r["tokens"] for r in tdone} == {r["uid"]: r["tokens"] for r in jdone}
    assert len(tdone) == 5 and tsrv.stats == {k: jsrv.stats[k] for k in tsrv.stats}

    def req(rng, uid, plen):
        return Request(uid, rng.integers(0, tcfg.vocab_size, size=plen).astype(np.int32), 6)

    rng = np.random.default_rng(7)
    first, second = req(rng, 0, 9), req(rng, 1, 5)
    srv = BatchedServer(build_serve(tmodel), tparams, tcfg, batch_size=1, max_seq=32)
    srv.submit(first)
    srv.submit(second)   # queued; admitted into slot 0 after `first` completes
    done, pending = srv.drain(max_ticks=200)
    assert not pending and len(done) == 2
    fresh = BatchedServer(build_serve(tmodel), tparams, tcfg, batch_size=1, max_seq=32)
    fresh.submit(Request(1, second.prompt, 6))
    done_f, _ = fresh.drain(max_ticks=200)
    assert {r["uid"]: r["tokens"] for r in done}[1] == done_f[0]["tokens"]

    _slot_ops_reach_every_recurrent_leaf()
    with pytest.raises(ValueError, match="no global-attention layers to page"):
        BatchedServer(build_serve(tmodel), tparams, tcfg, 2, 32, paged=True)

    from repro_torch.launch import serve as launch

    lines = []
    srv, done = launch.serve(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                              "--prompt-len", "10", "--max-new", "3"], log_fn=lines.append)
    assert len(done) == 3 and not srv.paged and "dense cache" in lines[-1]


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread for the test: its tensors are small, and
    under pytest-xdist every worker's default pool of one thread per core
    oversubscribes the machine and slows the other workers' tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rglru_hybrid_matches_jax(mesh2d, one_thread):
    """The scan and the block; the reduced model, its gradients and SASG
    training; the chain against the full forward; the engine against the
    JAX engine (see each check)."""
    _check_scan_and_block()
    pair = _pair()
    _check_reduced_model_and_training(pair)
    _check_chain(pair)
    _check_engine(pair, mesh2d)
