"""The port's dense-attention LMs against the JAX package's, per arch, on
the reduced configs (fp32), with params carried by ``params_from_numpy``
and numpy inputs from a seed.

Tolerances (of the reference's largest magnitude):
- forward logits, loss and each gradient leaf: 1e-5. The same fp32
  algebra with sums in other orders; measured ~1e-6.
- the chained prefill + decode against the full forward: 1e-5. The JAX
  package's own chain differs from its full forward by up to 1.9e-6
  absolute on reduced llama3_8b (fp32 summation order: the decode path
  attends over the whole cache in one block, the prefill path streams),
  so its bitwise claim (tests/test_serve_engine.py::
  test_parity_attention_bitexact) does not hold and is not copied.
- the engine's tokens: equal to the JAX dense engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import indexed_token_stream as jax_token_stream
from repro.models import build as jax_build
from repro.models import lm as JLM
from repro.serve import BatchedServer as JaxServer
from repro.serve import Request as JaxRequest
from repro.serve import build_serve as jax_build_serve
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import indexed_token_stream
from repro_torch.models import build, params_from_numpy
from repro_torch.models import lm as TLM
from repro_torch.models.model import NUM_PATCH_TOKENS
from repro_torch.serve import BatchedServer, Request, build_serve

ARCHS = ["llama3_8b", "starcoder2_3b", "chatglm3_6b", "granite_20b", "internvl2_2b"]
TOL = 1e-5
B, S, N, NP = 2, 8, 4, 8      # batch, prefill width, decode steps, VLM prefix


def _close(got: torch.Tensor, want, tol=TOL) -> float:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    peak = float(np.abs(want).max())
    assert err <= tol * peak, (err, peak)
    return err


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + N)).astype(np.int32)
    prefix = (rng.normal(size=(B, NP, jcfg.d_model)).astype(np.float32)
              if jcfg.frontend == "patch_embed" else None)
    return arch, jcfg, tcfg, jmodel, jparams, build(tcfg), tparams, toks, prefix


def test_the_five_configs_are_the_jax_packages():
    """Full and reduced configs field by field; granite stays MQA reduced."""
    assert set(ARCHS) <= set(ARCH_IDS)
    for arch in ARCHS:
        for reduce in (False, True):
            jcfg, tcfg = jax_get_config(arch), get_config(arch)
            if reduce:
                jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), (arch, reduce)
    assert get_config("granite_20b").reduced().n_kv_heads == 1
    assert get_config("chatglm3_6b").reduced().rope_style == "half"
    assert NUM_PATCH_TOKENS == 256


def test_params_carry_bitwise(pair):
    _, _, _, _, jparams, tmodel, tparams, _, _ = pair
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves = jax.tree.leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}", path
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the port's own init has the JAX package's tree, shapes and dtypes
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert [(tuple(x.shape), x.dtype) for x in jax.tree.leaves(own)] == [
        (tuple(x.shape), x.dtype) for x in tleaves]


def test_lm_forward_matches_jax(pair):
    arch, jcfg, tcfg, _, jparams, _, tparams, toks, prefix = pair
    kw_j = {} if prefix is None else {"prefix_embeds": jnp.asarray(prefix)}
    kw_t = {} if prefix is None else {"prefix_embeds": torch.from_numpy(prefix)}
    lj, _ = JLM.lm_forward(jparams, jcfg, jnp.asarray(toks), **kw_j)
    lt, _ = TLM.lm_forward(tparams, tcfg, torch.from_numpy(toks), **kw_t)
    assert lt.shape == (B, S + N + (0 if prefix is None else NP), jcfg.vocab_size)
    _close(lt, lj)
    hj, _ = JLM.lm_forward(jparams, jcfg, jnp.asarray(toks), return_hidden=True, **kw_j)
    ht, _ = TLM.lm_forward(tparams, tcfg, torch.from_numpy(toks), return_hidden=True, **kw_t)
    _close(ht, hj)


def _batch(toks, prefix):
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if prefix is not None:
        batch["patch_embeds"] = prefix
    return batch


def test_loss_and_grads_match_jax(pair):
    _, _, _, jmodel, jparams, tmodel, tparams, toks, prefix = pair
    batch = _batch(toks, prefix)
    lj, gj = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, jax.tree.map(jnp.asarray, batch))
    gt, lt = torch.func.grad_and_value(tmodel.loss_fn)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(gj)[0], jax.tree.leaves(gt)):
        _close(b, a)


def test_prefill_with_prefix_matches_jax(pair):
    """Model.prefill: the logits and the cache it leaves (for the VLM, the
    prefix counts as the first NP positions)."""
    _, _, _, jmodel, jparams, tmodel, tparams, toks, prefix = pair
    batch = _batch(toks[:, :S], prefix)
    lj, cj = jmodel.prefill(jparams, jax.tree.map(jnp.asarray, batch))
    lt, ct = tmodel.prefill(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(lt, lj)
    for a, b in zip(jax.tree.leaves(cj), jax.tree.leaves(ct)):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)


def _chain(decode_step, params, cache, toks, as_pos):
    """Prefill S tokens at per-slot position 0, then N one-token decode
    steps: the engine's access pattern (tests/test_serve_engine.py::
    _parity_case)."""
    logits, cache = decode_step(params, cache, toks[:, :S], as_pos(np.zeros((B,), np.int32)))
    steps = [logits]
    for t in range(S, S + N):
        logits, cache = decode_step(params, cache, toks[:, t:t + 1],
                                    as_pos(np.full((B,), t, np.int32)))
        steps.append(logits)
    return steps, cache


def test_chain_matches_the_full_forward_and_the_jax_chain(pair):
    _, jcfg, tcfg, jmodel, jparams, tmodel, tparams, toks, _ = pair
    full, _ = TLM.lm_forward(tparams, tcfg, torch.from_numpy(toks))
    steps, cache = _chain(tmodel.decode_step, tparams, tmodel.init_cache(B, S + N),
                          torch.from_numpy(toks), torch.from_numpy)
    chained = torch.cat(steps, dim=1)
    _close(chained, full.numpy())
    jsteps, jcache = _chain(jax.jit(jmodel.decode_step), jparams, jmodel.init_cache(B, S + N),
                            jnp.asarray(toks), jnp.asarray)
    _close(chained, np.concatenate([np.asarray(x) for x in jsteps], axis=1))
    for a, b in zip(jax.tree.leaves(jcache), jax.tree.leaves(cache)):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)


def test_frozen_rows_keep_their_cache_through_the_lm(pair):
    """A (B,) cache_pos with a negative entry: that row's K/V/pos leaves
    in every layer come back unchanged, its logits finite."""
    _, _, tcfg, _, _, tmodel, tparams, toks, _ = pair
    _, cache = _chain(tmodel.decode_step, tparams, tmodel.init_cache(B, S + N),
                      torch.from_numpy(toks), torch.from_numpy)
    logits, new = tmodel.decode_step(tparams, cache, torch.from_numpy(toks[:, :3]),
                                     torch.tensor([S + N - 3, -1], dtype=torch.int32))
    assert torch.isfinite(logits).all()
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(new)):
        assert torch.equal(a[:, 1], b[:, 1])


# ---------------------------------------------------------------------------
# the engine on the dense cache
# ---------------------------------------------------------------------------

PROMPTS = (9, 5, 12)    # 2 slots: the third request takes a recycled slot
MAX_NEW, MAX_SEQ, BATCH = 4, 32, 2


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPTS]


def test_engine_generates_the_jax_dense_engines_tokens(mesh2d):
    """Reduced llama3_8b, paged=False in both, the JAX engine's default
    prefill chunk (8): widths 8, 4, 2, 1, frozen rows while the other slot
    prefills, and a recycled slot."""
    jcfg = jax_get_config("llama3_8b").reduced()
    jmodel = jax_build(jcfg)
    jserve = jax_build_serve(jmodel, mesh2d, fsdp="data", tp="model")
    jparams = jax.jit(jmodel.init, out_shardings=jserve.param_shardings)(
        jax.random.PRNGKey(0))
    jsrv = JaxServer(jserve, jparams, jcfg, BATCH, MAX_SEQ, paged=False)
    tcfg = get_config("llama3_8b").reduced()
    tsrv = BatchedServer(build_serve(build(tcfg)), params_from_numpy(
        jax.tree.map(np.asarray, jparams)), tcfg, BATCH, MAX_SEQ, paged=False)
    for uid, p in enumerate(_prompts(jcfg.vocab_size)):
        jsrv.submit(JaxRequest(uid, p, MAX_NEW))
        tsrv.submit(Request(uid, p, MAX_NEW))
    jdone, _ = jsrv.drain(strict=True)
    tdone, _ = tsrv.drain(strict=True)
    assert {r["uid"]: r["tokens"] for r in tdone} == {r["uid"]: r["tokens"] for r in jdone}
    assert len(tdone) == len(PROMPTS)
    assert tsrv.stats == {k: jsrv.stats[k] for k in tsrv.stats}
    for a, b in zip(jax.tree.leaves(jsrv.cache), jax.tree.leaves(tsrv.cache)):
        if b.dtype == torch.int32:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            _close(b, a)


def test_recycled_slot_matches_fresh_engine():
    """tests/test_serve_engine.py's test on internvl2_2b, on the dense
    cache: a request served through a recycled slot (the previous
    occupant's K/V rows still in the cache) generates the tokens a fresh
    engine generates for it alone."""
    cfg = get_config("internvl2_2b").reduced()
    model = build(cfg)
    serve = build_serve(model)
    params = model.init(torch.Generator().manual_seed(0))

    def req(rng, uid, plen):
        return Request(uid, rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32), 6)

    rng = np.random.default_rng(7)
    first, second = req(rng, 0, 9), req(rng, 1, 5)
    srv = BatchedServer(serve, params, cfg, batch_size=1, max_seq=32, paged=False)
    srv.submit(first)
    srv.submit(second)   # queued; admitted into slot 0 after `first` completes
    done, pending = srv.drain(max_ticks=200)
    assert not pending and len(done) == 2
    fresh = BatchedServer(serve, params, cfg, batch_size=1, max_seq=32, paged=False)
    fresh.submit(Request(1, second.prompt, 6))
    done_f, _ = fresh.drain(max_ticks=200)
    assert {r["uid"]: r["tokens"] for r in done}[1] == done_f[0]["tokens"]


def test_paged_cache_raises_naming_item_10():
    """The engine serves an attention arch from the paged cache: by
    default (``paged=None``) and when asked, with the dense engine's
    tokens (the identity codec)."""
    cfg = get_config("llama3_8b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = {}
    for paged in (None, True, False):
        srv = BatchedServer(build_serve(model), params, cfg, BATCH, MAX_SEQ, paged=paged)
        assert srv.paged == (paged is not False)
        for uid, p in enumerate(_prompts(cfg.vocab_size)):
            srv.submit(Request(uid, p, MAX_NEW))
        done, _ = srv.drain(strict=True)
        tokens[paged] = {r["uid"]: r["tokens"] for r in done}
    assert tokens[None] == tokens[True] == tokens[False]


# ---------------------------------------------------------------------------
# data and launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_indexed_token_stream_is_byte_identical_to_jax(seed):
    ours, theirs = indexed_token_stream(256, 8, 64, seed=seed), jax_token_stream(256, 8, 64,
                                                                               seed=seed)
    for step in (0, 1, 7):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_train_launcher_trains_a_reduced_lm_on_the_cpu():
    from repro_torch.launch import train as launch

    lines = []
    trainer, state = launch.train(
        ["--arch", "llama3_8b", "--reduced", "--algo", "sasg", "--workers", "2",
         "--global-batch", "4", "--seq-len", "16", "--steps", "2", "--device", "cpu"],
        log_fn=lines.append)
    assert "arch=llama3_8b" in lines[0]
    assert len(trainer.history) == 2 and all(np.isfinite(r["loss"]) for r in trainer.history)
    assert trainer.history[0]["num_sent"] == 2
    assert "2 steps" in lines[-1]


def test_serve_launcher_serves_a_reduced_lm_on_the_cpu():
    from repro_torch.launch import serve as launch

    lines = []
    argv = ["--arch", "llama3_8b", "--reduced", "--device", "cpu", "--requests", "3",
            "--prompt-len", "10", "--max-new", "3"]
    srv, done = launch.serve(argv + ["--dense"], log_fn=lines.append)
    assert len(done) == 3 and all(len(r["tokens"]) == 3 for r in done)
    assert "llama3_8b: 3 requests" in lines[-1] and srv.stats["prefill_tokens"] == 30
    assert not srv.paged and "dense cache" in lines[-1]
    # without --dense: the paged cache, the same tokens
    paged, done_p = launch.serve(argv, log_fn=lines.append)
    assert paged.paged and "paged cache" in lines[-2] and "high-water" in lines[-1]
    assert {r["uid"]: r["tokens"] for r in done_p} == {r["uid"]: r["tokens"] for r in done}
