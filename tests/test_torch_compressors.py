"""The port's baseline compressors (randk, qsgd, signsgd_ef, terngrad), its
bit accounting of them and its standalone error feedback, against the JAX
package's.

JAX's threefry and torch's Philox draw different numbers, so parity is
held where the draws are the same or do not enter:

- randk: given the indices JAX chose (``jax.random.choice``), the port's
  values (scaled by d/k, cast to the wire dtype) are bitwise equal;
- qsgd and terngrad: given JAX's uniforms (``jax.random.uniform`` on the
  same split keys, taken to numpy), the outputs agree to ``QUANT_RTOL``
  except on at most 1e-4 of the coordinates, where a uniform or a level
  sits within rounding of its threshold and the two round to neighbouring
  levels: each such mismatch is exactly one quantum (qsgd: ||x|| / s,
  terngrad: max |x|). The rest differ because qsgd's norm is a reduction
  whose order differs between the packages (measured: 2.98e-8 absolute,
  3.6e-7 relative to the largest output; terngrad's max is exact and its
  outputs are bitwise equal);
- signsgd_ef: deterministic; signs exact, payload and residual within
  ``SIGN_RTOL`` of the largest payload (the scale mean |corr| is a
  reduction: measured 1.4e-6 on a 2,304-element leaf);
- whole steps against ``repro.train.build_train_step`` on the 4x1 mesh, as
  ``test_torch_train_step.py`` runs them (fc_mnist, PRNGKey(2) params):
  signsgd_ef under Sparse and SASG with sends and counters exact and
  params within 1e-5 of JAX's (a dense exchange: ``test_torch_train_step``'s
  dense tier); randk, qsgd and terngrad with selection off, counters exact.

In the port alone: unbiasedness of randk, qsgd and terngrad (every
coordinate of the mean of 4,000 seeded draws within 5 standard errors,
computed from the compressor's own variance), and ``ef_apply``'s invariant
compressed + residual == corrected input, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.comm import bits as jax_bits
from repro.configs import get_config as jax_get_config
from repro.core import compressors as JC
from repro.core import topk as jax_topk
from repro.core.error_feedback import ef_apply as jax_ef_apply, ef_init as jax_ef_init
from repro.core.sasg import PRESETS as JAX_PRESETS
from repro.data import indexed_classification_stream, synthetic_classification
from repro.dist.strategy import choose_strategy
from repro.models import build as jax_build
from repro.optim import constant as jax_constant
from repro.train import build_train_step as jax_build_train_step
from repro_torch.comm import bits
from repro_torch.configs import get_config
from repro_torch.core import compressors as TC
from repro_torch.core import topk
from repro_torch.core.error_feedback import ef_apply, ef_init
from repro_torch.core.sasg import PRESETS
from repro_torch.core.types import tree_leaves
from repro_torch.models import build, params_from_numpy
from repro_torch.optim import constant
from repro_torch.train import build_train_step

M, STEPS, LR = 4, 3, 0.05
QUANT_RTOL = 1e-6
SIGN_RTOL = 5e-6
RANDOMIZED = ("randk", "qsgd", "terngrad")
SHAPES = [(3, 3, 16, 16), (64,), (5, 7)]


def _leaves(seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=(M,) + s)).astype(np.float32) for s in SHAPES]


def _jax_per_worker(jcomp, x, key):
    """JAX's compress of a one-leaf tree, worker m with key fold_in(key, m),
    vmapped over the workers (one compile per leaf shape); returns the
    payload leaf and the uniforms of shape x[m] that the compress drew
    from (split(fold_in(key, m), 1)[0])."""
    keys = jax.vmap(lambda m: jax.random.fold_in(key, m))(jnp.arange(M))

    def one(xm, k):
        out = jcomp.compress((), {"a": xm}, k)[0]["a"]
        return out, jax.random.uniform(jax.random.split(k, 1)[0], xm.shape)

    return jax.jit(jax.vmap(one))(jnp.asarray(x), keys)


# ---------------------------------------------------------------------------
# per leaf, given the same draws
# ---------------------------------------------------------------------------

def test_randk_values_bitwise_given_jax_indices():
    """JAX's fp32 payload, and its values on a bf16 wire (the cast the JAX
    compressor makes with ``wire_dtype="bfloat16"``)."""
    jcomp = JC.build_compressor(JC.CompressorConfig(name="randk", k_ratio=0.05))
    for x in _leaves():
        k = TC.CompressorConfig(k_ratio=0.05).leaf_k(x[0].size)
        jp = _jax_per_worker(jcomp, x, jax.random.PRNGKey(7))[0]
        idx = torch.from_numpy(np.array(jp.indices))
        assert idx.shape == (M, k)
        tp = topk.random_k_at(torch.from_numpy(x.reshape(M, -1)), idx)
        assert np.array_equal(tp.indices.numpy(), np.asarray(jp.indices))
        for wdtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            got = tp.values.to(wdtype).float().numpy()
            want = np.asarray(jp.values.astype(jdtype).astype(jnp.float32))
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (x.shape, wdtype)


def test_randk_draws_a_uniform_subset_per_worker():
    gen = torch.Generator().manual_seed(0)
    x = torch.arange(1, 1001, dtype=torch.float32).expand(M, 1000)
    p = topk.random_k(x, 50, gen)
    assert p.values.shape == (M, 50) and p.size == 1000
    for m in range(M):
        assert len(set(p.indices[m].tolist())) == 50          # without replacement
    assert not torch.equal(p.indices[0], p.indices[1])         # workers draw apart
    np.testing.assert_array_equal(p.values.numpy(), (p.indices.float() + 1).numpy() * 20.0)


@pytest.mark.parametrize("name", ["qsgd", "terngrad"])
def test_quantizers_given_jax_uniforms(name):
    jcomp = JC.build_compressor(JC.CompressorConfig(name=name))
    total = flips = 0
    for x in _leaves(1):
        want, u = (np.array(a) for a in _jax_per_worker(jcomp, x, jax.random.PRNGKey(3)))
        xt, u = torch.from_numpy(x), torch.from_numpy(u)
        if name == "qsgd":
            got = TC._qsgd_leaf(xt, u, 256).numpy()
            quantum = np.linalg.norm(x.reshape(M, -1), axis=1) / 256
        else:
            got = TC._terngrad_leaf(xt, u).numpy()
            quantum = np.abs(x.reshape(M, -1)).max(axis=1)
            assert np.array_equal(got, want)   # the max is exact: bitwise
        quantum = quantum.reshape((M,) + (1,) * (x.ndim - 1)) * np.ones_like(x)
        diff = np.abs(got - want)
        flip = diff > QUANT_RTOL * np.abs(want).max()
        np.testing.assert_allclose(diff[flip], quantum[flip], rtol=1e-5)
        total += x.size
        flips += int(flip.sum())
    assert flips <= 1e-4 * total, (flips, total)


def test_signsgd_ef_within_the_scale_reduction_tolerance():
    jcomp = JC.build_compressor(JC.CompressorConfig(name="signsgd_ef"))
    tcomp = TC.build_compressor(TC.CompressorConfig(name="signsgd_ef"))
    rng = np.random.default_rng(2)
    for x in _leaves(2):
        e = (0.01 * rng.normal(size=x.shape)).astype(np.float32)
        tp, te = tcomp.compress({"a": torch.from_numpy(e)}, {"a": torch.from_numpy(x)})
        tp, te = tp["a"].numpy(), te["a"].numpy()
        for m in range(M):
            jp, je = jcomp.compress({"a": jnp.asarray(e[m])}, {"a": jnp.asarray(x[m])}, None)
            jp, je = np.asarray(jp["a"]), np.asarray(je["a"])
            np.testing.assert_array_equal(np.sign(tp[m]), np.sign(jp))
            tol = SIGN_RTOL * np.abs(jp).max()
            np.testing.assert_allclose(tp[m], jp, rtol=0, atol=tol)
            np.testing.assert_allclose(te[m], je, rtol=0, atol=tol)


def test_compressors_need_a_generator_when_they_draw():
    x = {"a": torch.ones((M, 8))}
    for name in RANDOMIZED:
        comp = TC.build_compressor(TC.CompressorConfig(name=name))
        with pytest.raises(ValueError, match="Generator"):
            comp.compress(comp.init(x), x)
    with pytest.raises(ValueError, match="unknown compressor"):
        TC.build_compressor(TC.CompressorConfig(name="nope"))


# ---------------------------------------------------------------------------
# unbiasedness and error feedback, in the port
# ---------------------------------------------------------------------------

def _std_per_draw(name, x, k):
    """Standard deviation of one draw of each coordinate."""
    a = x.abs().double()
    if name == "randk":
        return a * np.sqrt(x.numel() / k - 1)
    if name == "qsgd":
        q = x.double().norm() / 256
        p = a / q - torch.floor(a / q)
        return q * torch.sqrt(p * (1 - p))
    s = a.max()
    return s * torch.sqrt(a / s * (1 - a / s))


@pytest.mark.parametrize("name", RANDOMIZED)
def test_port_compressors_are_unbiased(name):
    draws, k_ratio = 4000, 0.125
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32))
    comp = TC.build_compressor(TC.CompressorConfig(name=name, k_ratio=k_ratio))
    stacked = {"w": x.expand((draws,) + tuple(x.shape))}
    out, _ = comp.compress(comp.init(stacked), stacked, torch.Generator().manual_seed(5))
    dense = out["w"].densify().reshape(stacked["w"].shape) if name == "randk" else out["w"]
    est = dense.double().mean(0)
    se = _std_per_draw(name, x, int(round(k_ratio * x.numel()))) / np.sqrt(draws)
    err = (est - x.double()).abs()
    assert bool((err <= 5 * se + 1e-6 * x.abs().max()).all()), float((err / se).max())


def test_ef_apply_invariant_is_exact():
    rng = np.random.default_rng(4)
    g = {"a": torch.from_numpy(rng.normal(size=(6, 9)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))}

    def top5(v):
        return topk.exact_topk(v, 5).densify()

    state = ef_init(g)
    for _ in range(3):
        corrected = {k: v.reshape(-1) + e.reshape(-1)
                     for (k, v), e in zip(sorted(g.items()), tree_leaves(state.error))}
        out, state = ef_apply(state, g, top5)
        for (k, c), e in zip(sorted(corrected.items()), tree_leaves(state.error)):
            assert torch.equal(out[k].reshape(-1) + e.reshape(-1), c)


def test_ef_apply_matches_jax():
    rng = np.random.default_rng(6)
    g = [rng.normal(size=(6, 9)).astype(np.float32) for _ in range(3)]
    tstate, jstate = ef_init({"a": torch.zeros(6, 9)}), jax_ef_init({"a": jnp.zeros((6, 9))})
    for x in g:
        tout, tstate = ef_apply(tstate, {"a": torch.from_numpy(x)},
                                lambda v: topk.exact_topk(v, 7).densify())
        jout, jstate = jax_ef_apply(jstate, {"a": jnp.asarray(x)},
                                    lambda v: jax_topk.exact_topk(v, 7).densify())
        assert np.array_equal(tout["a"].numpy(), np.asarray(jout["a"]))
        assert np.array_equal(tstate.error["a"].numpy(), np.asarray(jstate.error["a"]))


# ---------------------------------------------------------------------------
# bit accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["identity", "topk_ef", "randk", "qsgd", "signsgd_ef",
                                  "terngrad"])
@pytest.mark.parametrize("layout", ["per_shard", "flat"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_bits_account_matches_jax(name, layout, wire):
    kw = dict(name=name, layout=layout, wire_dtype=wire,
              k_ratio_per_layer=(("stem", 0.05), ("s3b", 0.005)))
    jcfg = jax.eval_shape(jax_build(jax_get_config("cnn_cifar")).init, jax.random.PRNGKey(0))
    template = build(get_config("cnn_cifar")).init(torch.Generator().manual_seed(0), "cpu")
    want = jax_bits.account(JC.CompressorConfig(**kw), jcfg)
    got = bits.account(TC.CompressorConfig(**kw), template)
    assert got.rows() == want.rows()
    assert (got.paper, got.wire) == (want.paper, want.wire)
    if name == "randk":
        assert TC.build_compressor(TC.CompressorConfig(**kw)).layout == (
            "flat" if layout == "flat" else "per_tensor")


# ---------------------------------------------------------------------------
# whole steps against the JAX package
# ---------------------------------------------------------------------------

def _run_pair(preset, compressor, steps=STEPS):
    jcfg, tcfg = jax_get_config("fc_mnist"), get_config("fc_mnist")
    jscfg, tscfg = JAX_PRESETS[preset](), PRESETS[preset]()
    jscfg = dataclasses.replace(jscfg, compressor=dataclasses.replace(jscfg.compressor,
                                                                       name=compressor))
    tscfg = dataclasses.replace(tscfg, compressor=dataclasses.replace(tscfg.compressor,
                                                                       name=compressor))
    mesh = compat.make_mesh((M, 1), ("data", "model"), devices=jax.devices()[:M])
    strategy = choose_strategy(mesh, sasg_enabled=True)
    jbuilt = jax_build_train_step(jax_build(jcfg), jscfg, mesh, strategy, jax_constant(LR))
    tbuilt = build_train_step(build(tcfg), tscfg, M, constant(LR), device="cpu")
    assert (tbuilt.bits_paper, tbuilt.bits_wire) == (jbuilt.bits_paper, jbuilt.bits_wire)
    jstate = jbuilt.init(jax.random.PRNGKey(2))
    tstate = tbuilt.init(params=params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    xs, ys = synthetic_classification(256, 10, (28, 28, 1), seed=0)
    stream = indexed_classification_stream(xs, ys, 2 * M, seed=0)
    rows = []
    for step in range(steps):
        batch = stream.batch_at(step)
        jstate, jm = jbuilt.jit_step(jstate, batch)
        tstate, tm = tbuilt.step(tstate, batch)
        rows.append(({k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm.items()}))
    return rows, tstate, jstate


@pytest.fixture(scope="module", params=["sparse", "sasg"])
def signsgd_pair(request):
    return _run_pair(request.param, "signsgd_ef")


def test_signsgd_ef_whole_step_matches_jax(signsgd_pair):
    rows, tstate, jstate = signsgd_pair
    for step, (tm, jm) in enumerate(rows):
        for key in ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total"):
            assert tm[key] == jm[key], (step, key)
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    diff = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
               for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)))
    assert diff < 1e-5, diff


@pytest.mark.parametrize("name", RANDOMIZED)
def test_randomized_whole_step_counters_match_jax(name):
    """Selection off: every worker sends every step, so the counters do not
    depend on the draws and are exact."""
    rows, tstate, _ = _run_pair("sparse", name)
    for step, (tm, jm) in enumerate(rows):
        for key in ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total"):
            assert tm[key] == jm[key], (name, step, key)
        assert np.isfinite(tm["loss"])
    np.testing.assert_allclose(rows[0][0]["loss"], rows[0][1]["loss"], rtol=1e-4)
    assert all(torch.isfinite(x).all() for x in tree_leaves(tstate.params))
