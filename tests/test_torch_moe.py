"""The port's MoE and sliding-window layers against the JAX package's, on
the reduced configs (fp32), with params carried by ``params_from_numpy``
and numpy inputs from a seed.

Tolerances (of the reference's largest magnitude):
- ``moe_apply``, ``moe_aux_loss``, forward logits, loss and each gradient
  leaf: 1e-5. The same fp32 algebra with sums in other orders; the router's
  top-k picks are compared exactly first, since a near-tie flip would be a
  discontinuity, not a round-off.
- the engine: completes, and its paged tokens equal its dense ones. MoE
  serving is completion-only (DESIGN.md §9): a tick's capacity groups
  drop other tokens than a full forward's (on reduced mixtral a one-token
  decode chain is 1.04 off the full forward at max|logits| 3.5, in either
  package), so decode steps are held to the JAX package's decode steps,
  not to the full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.sasg import PRESETS as JAX_PRESETS
from repro.dist.strategy import choose_strategy
from repro.models import build as jax_build
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.optim import constant as jax_constant
from repro.train import build_train_step as jax_build_train_step
from repro import compat
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import BatchedServer, Request, build_serve

ARCHS = ["mixtral_8x7b", "kimi_k2"]
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one intra-op thread for every test here: the tensors are
    small, and under pytest-xdist every worker's default pool of one thread
    per core oversubscribes the machine and slows the other workers'
    tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, want, tol=TOL) -> float:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    return err


def _moe_pair(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jp = JL.moe_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _jax_picks(jp, x):
    probs = jax.nn.softmax(jnp.asarray(x).astype(jnp.float32) @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, 2)[1])


def _check_configs():
    for arch in ARCHS:
        assert arch in ARCH_IDS
        for reduce in (False, True):
            jcfg, tcfg = jax_get_config(arch), get_config(arch)
            if reduce:
                jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), (arch, reduce)
    assert get_config("mixtral_8x7b").attn_pattern == ("swa",)
    assert get_config("kimi_k2").moe.num_shared_experts == 1


def _check_moe_apply(arch, shape):
    """Each input is one group (``min(moe_group_size, tokens)`` tokens),
    capacity ceil(group * 2 / 8 * 1.25), down to a single token; with a
    random router some experts overflow and drop choices, in both packages
    alike. The router's picks first, then the output."""
    jcfg, tcfg, jp, tp = _moe_pair(arch)
    x = np.random.default_rng(sum(shape)).normal(size=shape + (jcfg.d_model,)).astype(np.float32)
    _, tpicks = TL._top_k(TL._router_probs(tp, torch.from_numpy(x)), 2)
    np.testing.assert_array_equal(tpicks.numpy(), _jax_picks(jp, x))
    want = JL.moe_apply(jp, jcfg, jnp.asarray(x))
    got = TL.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, want)
    assert ("shared" in tp) == (arch == "kimi_k2")


def _check_capacity_drops():
    """capacity_factor 0.5: cap = ceil(32 * 2 / 8 * 0.5) = 4 slots per
    expert for 64 choices, so most choices drop; a token that loses both
    its choices gets zero from the experts, in both packages."""
    jcfg, tcfg, jp, tp = _moe_pair("mixtral_8x7b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=0.5))
    x = np.random.default_rng(9).normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    want = np.asarray(JL.moe_apply(jp, jcfg, jnp.asarray(x)))
    got = TL.moe_apply(tp, tcfg, torch.from_numpy(x))
    _close(got, want)
    assert (np.abs(want).sum(-1) == 0).any() and (got.abs().sum(-1) == 0).any()


def _check_router_ties():
    """A zero router gives every expert the same probability: both
    packages pick experts 0 and 1 (``jax.lax.top_k``'s rule; ``torch.topk``
    would not), and the outputs agree. Partial ties too."""
    jcfg, tcfg, jp, tp = _moe_pair("mixtral_8x7b")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(1).normal(size=(1, 8, jcfg.d_model)).astype(np.float32)
    np.testing.assert_array_equal(_jax_picks(jp, x), np.tile([0, 1], (1, 8, 1)))
    _, picks = TL._top_k(TL._router_probs(tp, torch.from_numpy(x)), 2)
    np.testing.assert_array_equal(picks.numpy(), np.tile([0, 1], (1, 8, 1)))
    _close(TL.moe_apply(tp, tcfg, torch.from_numpy(x)), JL.moe_apply(jp, jcfg, jnp.asarray(x)))
    p = torch.tensor([[0.1, 0.3, 0.3, 0.0, 0.3]])
    _, idx = TL._top_k(p, 3)
    assert idx.tolist() == [[1, 2, 4]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(p.numpy()), 3)[1]).tolist() == [[1, 2, 4]]


def _check_aux_loss(arch):
    jcfg, tcfg, jp, tp = _moe_pair(arch)
    x = np.random.default_rng(2).normal(size=(3, 10, jcfg.d_model)).astype(np.float32)
    want = float(JL.moe_aux_loss(jp, jcfg, jnp.asarray(x)))
    got = TL.moe_aux_loss(tp, tcfg, torch.from_numpy(x))
    assert got.shape == () and abs(float(got) - want) <= TOL * abs(want)
    zero = dict(tp, router=torch.zeros_like(tp["router"]))    # uniform: frac e_0 = 1
    assert float(TL.moe_aux_loss(zero, tcfg, torch.from_numpy(x))) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the reduced MoE LMs
# ---------------------------------------------------------------------------

B, S = 2, 16


def _check_reduced_lm(arch):
    """The reduced LM with params carried from the JAX init: the port's
    own init has the JAX tree, shapes and dtypes; forward logits; loss and
    every gradient leaf; then a chain of an 8-token prefill and 8
    one-token steps on the dense cache, every step's logits against the
    JAX chain's (mixtral at window 4, so its ring of 8 slots is filled by
    the prefill and wrapped by the steps; kimi also on the paged cache,
    bitwise its dense chain)."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel, tmodel = jax_build(jcfg), build(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    own = tmodel.init(torch.Generator().manual_seed(0))
    assert [(tuple(x.shape), x.dtype) for x in jax.tree.leaves(own)] == [
        (tuple(x.shape), x.dtype) for x in jax.tree.leaves(tparams)]
    paths = ["/".join(str(getattr(k, "key", k)) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert any(p.endswith("moe/experts_gate") for p in paths)

    lj, _ = JLM.lm_forward(jparams, jcfg, jnp.asarray(toks))
    lt, _ = TLM.lm_forward(tparams, tcfg, torch.from_numpy(toks))
    assert lt.shape == (B, S, jcfg.vocab_size)
    _close(lt, lj)

    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    lj, gj = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, jax.tree.map(jnp.asarray, batch))
    gt, lt = torch.func.grad_and_value(tmodel.loss_fn)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    jleaves = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(jleaves) == len(jax.tree.leaves(gt))
    for (path, a), b in zip(jleaves, jax.tree.leaves(gt)):
        _close(b, a)

    if arch == "mixtral_8x7b":
        jcfg, tcfg = (dataclasses.replace(c, window=4) for c in (jcfg, tcfg))
        jmodel, tmodel = jax_build(jcfg), build(tcfg)

    def chain(step, cache, to):
        logits, cache = step(cache, to(toks[:, :8]), to(np.zeros((B,), np.int32)))
        outs = [logits]
        for t in range(8, S):
            logits, cache = step(cache, to(toks[:, t:t + 1]), to(np.full((B,), t, np.int32)))
            outs.append(logits)
        return outs, cache

    jstep = jax.jit(lambda c, x, p: jmodel.decode_step(jparams, c, x, p))
    tstep = lambda c, x, p: tmodel.decode_step(tparams, c, x, p)   # noqa: E731
    jouts, jcache = chain(jstep, jmodel.init_cache(B, S), jnp.asarray)
    touts, tcache = chain(tstep, tmodel.init_cache(B, S), torch.from_numpy)
    for a, b in zip(jouts, touts):
        _close(b, a)
    if arch == "mixtral_8x7b":
        assert tuple(tcache["unit"][0]["k"].shape[2:3]) == (8,)    # the ring
        np.testing.assert_array_equal(tcache["unit"][0]["pos"].numpy(),
                                      np.asarray(jcache["unit"][0]["pos"]))
        return
    bt = np.arange(2 * B, dtype=np.int32).reshape(B, 2)
    pt = tmodel.init_paged_cache(B, S, 2 * B, 8)
    pt["bt"] = torch.from_numpy(bt)
    pouts, _ = chain(tstep, pt, torch.from_numpy)
    for a, b in zip(touts, pouts):      # paged == dense bitwise
        assert torch.equal(a, b)


def _check_swa_equals_global():
    """tests/test_archs_smoke.py::test_swa_equals_global_within_window on
    the port: a sliding window wider than the sequence is full attention."""
    base = get_config("mixtral_8x7b").reduced()
    cfg_swa = dataclasses.replace(base, window=64)
    cfg_glob = dataclasses.replace(base, attn_pattern=("global",))
    params = build(cfg_swa).init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, base.vocab_size, (2, 16)).astype(np.int32))
    l1, _ = TLM.lm_forward(params, cfg_swa, toks)
    l2, _ = TLM.lm_forward(params, cfg_glob, toks)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-3, atol=1e-3)
    narrow = dataclasses.replace(base, window=4)
    l3, _ = TLM.lm_forward(params, narrow, toks)
    assert not torch.allclose(l3, l2, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# serving and training
# ---------------------------------------------------------------------------

def _check_engine_completes(arch):
    """tests/test_serve_engine.py::test_moe_engine_completes's stream (2
    slots, 3 requests of 5 tokens, 3 new): every request completes with
    tokens in the vocabulary; mixtral on the dense cache (its swa pattern
    has nothing to page), kimi on the paged cache, whose tokens equal its
    dense cache's (``_check_reduced_lm`` holds the steps to the JAX
    package's)."""
    cfg = get_config(arch).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = {}
    for paged in (None, False):
        srv = BatchedServer(build_serve(model), params, cfg, 2, 32, paged=paged)
        assert srv.paged == (paged is None and arch == "kimi_k2")
        rng = np.random.default_rng(0)
        for uid in range(3):
            srv.submit(Request(uid, rng.integers(0, cfg.vocab_size, size=5).astype(np.int32), 3))
        done, pending = srv.drain(strict=True)
        assert len(done) == 3 and not pending
        assert all(0 <= t < cfg.vocab_size for r in done for t in r["tokens"])
        tokens[paged] = {r["uid"]: r["tokens"] for r in done}
    assert tokens[None] == tokens[False]


def _check_sasg_through_the_launcher():
    """Reduced mixtral_8x7b, SASG, 2 workers x 2 sequences of 16 tokens,
    lr 1.0, 2 steps through ``launch.train``'s trainer (params carried from
    the JAX init): sends, rounds and bits each step equal to the JAX
    step's on a 2x1 mesh. The expert leaves (E, d, f) go through the
    grouped EF + top-k path among the other segments."""
    from repro_torch.launch import train as launch

    argv = ["--arch", "mixtral_8x7b", "--reduced", "--algo", "sasg", "--workers", "2",
            "--global-batch", "4", "--seq-len", "16", "--steps", "2", "--lr", "1.0",
            "--device", "cpu"]
    args = launch.parse_args(argv)
    lines = []
    trainer = launch.build_trainer(args, log_fn=lines.append)
    jcfg = jax_get_config("mixtral_8x7b").reduced()
    mesh = compat.make_mesh((2, 1), ("data", "model"), devices=jax.devices()[:2])
    jbuilt = jax_build_train_step(jax_build(jcfg), JAX_PRESETS["sasg"](k_ratio=0.01,
                                                                       max_delay=10),
                                  mesh, choose_strategy(mesh, sasg_enabled=True),
                                  jax_constant(1.0))
    assert (trainer.built.bits_paper, trainer.built.bits_wire) == (jbuilt.bits_paper,
                                                                  jbuilt.bits_wire)
    jstate = jbuilt.init(jax.random.PRNGKey(2))
    state = trainer.run(state=trainer.built.init(
        params=params_from_numpy(jax.tree.map(np.asarray, jstate.params))))
    assert "arch=mixtral_8x7b" in lines[0] and len(trainer.history) == 2
    for step, rec in enumerate(trainer.history):
        jstate, jm = jbuilt.jit_step(jstate, trainer.data.batch_at(step))
        assert rec["num_sent"] == float(jm["num_sent"]), step
        for key in ("rounds_total", "bits_paper_total", "bits_wire_total"):
            np.testing.assert_allclose(rec[key], float(jm[key]), rtol=1e-6)
        np.testing.assert_allclose(rec["loss"], float(jm["loss"]), rtol=1e-4)
    assert float(state.counters.rounds) == float(jstate.counters.rounds)


def _check_launchers(arch):
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch

    lines = []
    srv, done = serve_launch.serve(["--arch", arch, "--reduced", "--device", "cpu",
                                    "--requests", "3", "--prompt-len", "6", "--max-new", "2"],
                                   log_fn=lines.append)
    assert len(done) == 3 and srv.paged == (arch == "kimi_k2")
    trainer, _ = train_launch.train(["--arch", arch, "--reduced", "--algo", "sasg",
                                     "--workers", "2", "--global-batch", "4", "--seq-len", "8",
                                     "--steps", "1", "--device", "cpu"], log_fn=lines.append)
    assert np.isfinite(trainer.history[0]["loss"]) and trainer.history[0]["num_sent"] == 2


# ---------------------------------------------------------------------------
# the tests: few items, each running a group of the checks above (see
# tests/test_torch_paged_cache.py: many short items shift pytest-xdist's
# chunks of the whole suite)
# ---------------------------------------------------------------------------

def test_moe_and_swa_layers_match_jax():
    """The configs; ``moe_apply`` down to a single token, with capacity
    drops and with router ties; ``moe_aux_loss``; swa == global within the
    window."""
    _check_configs()
    for arch, shape in (("mixtral_8x7b", (2, 16)), ("mixtral_8x7b", (1, 3)),
                        ("kimi_k2", (4, 32)), ("kimi_k2", (2, 1))):
        _check_moe_apply(arch, shape)
    _check_capacity_drops()
    _check_router_ties()
    for arch in ARCHS:
        _check_aux_loss(arch)
    _check_swa_equals_global()


def test_reduced_moe_lms_match_jax_and_serve():
    for arch in ARCHS:
        _check_reduced_lm(arch)
        _check_engine_completes(arch)


def test_moe_trains_and_serves_through_the_launchers():
    _check_sasg_through_the_launcher()
    for arch in ARCHS:
        _check_launchers(arch)
