"""The port's serving path against the JAX package's: the scheduler's tick
plans, the slot lifecycle ops, and the continuous-batching engine on
reduced mamba2_370m (SSD chunk 32, prefill chunk 64: tick widths 64, 32
and 1, so prefill ticks run the chunked SSD over one and two chunks and
carry a non-zero h0 between ticks).

Tokens are held equal to the JAX engine's; every tick's logits are held to
rtol/atol 1e-4 (fp32, sums in other orders) by replaying the port's tick
plans through the JAX model's ``decode_step`` in lockstep.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.serve import BatchedServer as JaxServer
from repro.serve import Request as JaxRequest
from repro.serve import Scheduler as JaxScheduler
from repro.serve import build_serve as jax_build_serve
from repro.serve import paged_cache as jax_pc
from repro.serve.engine import _allowed_widths as jax_allowed_widths
from repro.serve.paged_cache import BlockAllocator as JaxBlockAllocator
from repro_torch.configs import get_config
from repro_torch.models import build, params_from_numpy
from repro_torch.serve import (BatchedServer, BlockAllocator, Request, Scheduler,
                               build_serve, reset_slots, select_slots)
from repro_torch.serve.engine import _allowed_widths

PROMPTS = (64, 40, 32)   # 2 slots: the third request takes a recycled slot
MAX_NEW, MAX_SEQ, BATCH, PREFILL_CHUNK = 5, 128, 2, 64


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPTS]


# ---------------------------------------------------------------------------
# host-side pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_emits_the_jax_tick_plans(paged):
    """One request stream (prompts longer and shorter than the tick widths,
    more requests than slots), the same sampled tokens fed back: every
    TickPlan, completion and admission is the JAX scheduler's."""
    rng = np.random.default_rng(5)
    lens = [70, 3, 33, 64, 1, 40, 9]
    widths = (64, 32, 1)
    kw_j = {"allocator": JaxBlockAllocator(24, 16)} if paged else {}
    kw_t = {"allocator": BlockAllocator(24, 16)} if paged else {}
    js, ts = JaxScheduler(3, 128, widths, **kw_j), Scheduler(3, 128, widths, **kw_t)
    for uid, n in enumerate(lens):
        prompt = rng.integers(0, 100, size=n).astype(np.int32)
        js.submit(JaxRequest(uid, prompt, 1 + uid % 4))
        ts.submit(Request(uid, prompt, 1 + uid % 4))
    ticks = 0
    while js.n_pending:
        assert js.admit() == ts.admit()
        pj, pt = js.plan(), ts.plan()
        assert (pj.width, pj.active, pj.samplers) == (pt.width, pt.active, pt.samplers)
        np.testing.assert_array_equal(pj.tokens, pt.tokens)
        np.testing.assert_array_equal(pj.pos, pt.pos)
        sampled = rng.integers(0, 100, size=3)
        assert js.apply(pj, sampled) == ts.apply(pt, sampled)
        ticks += 1
    assert ts.n_pending == 0 and ticks > len(lens)
    if paged:
        assert kw_j["allocator"].high_water == kw_t["allocator"].high_water


def test_allowed_widths_match_jax():
    for name in ("mamba2_370m", "llama3_8b"):
        for reduced in (False, True):
            jcfg, tcfg = jax_get_config(name), get_config(name)
            if reduced:
                jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
            for chunk in (1, 8, 64, 256, 512, 1000):
                assert _allowed_widths(tcfg, chunk) == jax_allowed_widths(jcfg, chunk)
    assert _allowed_widths(get_config("mamba2_370m"), 512) == (512, 256, 1)


def test_slot_ops_match_jax():
    """select_slots / reset_slots on a stacked LM cache tree (batch axis 1
    under "unit") and on an unstacked one (batch axis 0 under "rem")."""
    rng = np.random.default_rng(0)
    tree = {"unit": [{"h": rng.normal(size=(3, 4, 2, 5)).astype(np.float32),
                      "conv": rng.normal(size=(3, 4, 2, 6)).astype(np.float32)}],
            "rem": [{"h": rng.normal(size=(4, 2, 5)).astype(np.float32),
                     "conv": rng.normal(size=(4, 2, 6)).astype(np.float32)}]}
    other = jax.tree.map(lambda a: a + 1.0, tree)
    mask = np.array([True, False, True, False])
    want = jax_pc.select_slots(jax.tree.map(jnp.asarray, tree),
                               jax.tree.map(jnp.asarray, other), jnp.asarray(mask))
    got = select_slots(params_from_numpy(tree), params_from_numpy(other), torch.from_numpy(mask))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    want = jax_pc.reset_slots(jax.tree.map(jnp.asarray, tree), jnp.asarray(mask))
    got = reset_slots(params_from_numpy(tree), torch.from_numpy(mask))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# the engine on reduced mamba2_370m
# ---------------------------------------------------------------------------

class RecordingServer(BatchedServer):
    """Keeps every tick's record for the lockstep replay."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.records = []

    def tick(self):
        ran = super().tick()
        if ran:
            self.records.append(self.last_tick)
        return ran


@pytest.fixture(scope="module")
def engines(mesh2d):
    # the JAX engine as tests/test_serve_engine.py::_mk builds it
    jcfg = jax_get_config("mamba2_370m").reduced()
    jmodel = jax_build(jcfg)
    jserve = jax_build_serve(jmodel, mesh2d, fsdp="data", tp="model")
    jparams = jax.jit(jmodel.init, out_shardings=jserve.param_shardings)(
        jax.random.PRNGKey(0))
    prompts = _prompts(jcfg.vocab_size)
    jsrv = JaxServer(jserve, jparams, jcfg, BATCH, MAX_SEQ, prefill_chunk=PREFILL_CHUNK)
    for uid, p in enumerate(prompts):
        jsrv.submit(JaxRequest(uid, p, MAX_NEW))
    jdone, _ = jsrv.drain(strict=True)

    tcfg = get_config("mamba2_370m").reduced()
    host_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_numpy(host_params)
    tsrv = RecordingServer(build_serve(build(tcfg)), tparams, tcfg, BATCH, MAX_SEQ,
                           prefill_chunk=PREFILL_CHUNK)
    for uid, p in enumerate(prompts):
        tsrv.submit(Request(uid, p, MAX_NEW))
    tdone, _ = tsrv.drain(strict=True)
    return jcfg, jmodel, host_params, jdone, tsrv, tdone


def test_engine_generates_the_jax_engines_tokens(engines):
    _, _, _, jdone, tsrv, tdone = engines
    assert len(tdone) == len(PROMPTS)
    assert {r["uid"]: r["tokens"] for r in tdone} == {r["uid"]: r["tokens"] for r in jdone}
    widths = [r.plan.width for r in tsrv.records]
    # a width-64 tick (two SSD chunks), width-32 ticks, decode ticks, and
    # a slot recycled for the third request
    assert {64, 32, 1} <= set(widths)
    assert any(r.admitted == [0] or r.admitted == [1] for r in tsrv.records[1:])
    assert tsrv.stats["decode_tokens"] == MAX_NEW * len(PROMPTS)


def test_engine_logits_match_jax_in_lockstep(engines):
    """Replay each of the port's ticks (slot resets, tokens, positions)
    through the JAX model's decode_step on its own cache."""
    jcfg, jmodel, host_params, _, tsrv, _ = engines
    jparams = jax.tree.map(jnp.asarray, host_params)
    jstep = jax.jit(jmodel.decode_step)
    cache = jmodel.init_cache(BATCH, MAX_SEQ)
    for rec in tsrv.records:
        if rec.admitted:
            mask = np.zeros((BATCH,), bool)
            mask[rec.admitted] = True
            cache = jax_pc.reset_slots(cache, jnp.asarray(mask))
        pos = jnp.asarray(rec.plan.pos)
        logits, nc = jstep(jparams, cache, jnp.asarray(rec.plan.tokens), pos)
        cache = jax_pc.select_slots(nc, cache, pos >= 0)
        active = rec.plan.active
        np.testing.assert_allclose(rec.logits.numpy()[active], np.asarray(logits)[active],
                                   rtol=1e-4, atol=1e-4)
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(tsrv.cache)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)


def test_paged_cache_is_not_ported_yet():
    """mamba2 has no global-attention layer to page: ``paged=True`` raises
    ValueError, as in the JAX engine, and ``paged=None`` resolves to the
    dense state."""
    jcfg, tcfg = jax_get_config("mamba2_370m").reduced(), get_config("mamba2_370m").reduced()
    jmodel, model = jax_build(jcfg), build(tcfg)
    assert jmodel.init_paged_cache is None and model.init_paged_cache is None
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no global-attention layers to page"):
        BatchedServer(build_serve(model), params, tcfg, 2, 64, paged=True)
    assert not BatchedServer(build_serve(model), params, tcfg, 2, 64).paged


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_on_the_cpu_when_asked():
    from repro_torch.launch import serve as launch

    lines = []
    srv, done = launch.serve(["--device", "cpu", "--reduced", "--requests", "3",
                              "--prompt-len", "40", "--max-new", "3"], log_fn=lines.append)
    assert len(done) == 3 and all(len(r["tokens"]) == 3 for r in done)
    assert "3 requests" in lines[-1] and srv.stats["prefill_tokens"] == 120
    # the prefill chunk is the SSD chunk (32): one width-32 tick feeds 32 of
    # each prompt's 40 tokens, so far fewer than 40 ticks in all
    assert srv.stats["ticks"] < 40


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import serve as launch

    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--reduced", "--requests", "1"])
