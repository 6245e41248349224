"""The port's Mamba-2 SSD path against the JAX package's, on the same numpy
inputs and the same params (carried over by ``params_from_numpy``).

- The chunk kernel's plain version (``kernels/ssd_scan/ref.py``, what a CPU
  tensor runs and what the CUDA kernel is held to on the card) against the
  Pallas kernel in interpret mode, and ``ops.ssd_chunked`` against the JAX
  oracle, at tests/test_kernels.py's shapes and tolerance (2e-4), plus one
  shape of the serving slice (Q=256, P=64, N=128).
- ``ssd_block_apply`` and ``lm_forward`` of reduced mamba2_370m in fp32 at
  rtol/atol 1e-4 (fp32 sums in other orders), through both SSD paths.
- The same in bf16 params and compute: both packages round at the same
  cast points, but XLA's CPU backend evaluates bf16 elementwise chains in
  fp32 and rounds once, where PyTorch rounds every op; held to 4 bf16 ulps
  at the output's largest magnitude (4 * 2**(e - 7) for max|out| in
  [2**e, 2**(e+1))).
- The decode chain (one token per step, the recurrent update) against the
  parallel chunked forward, as tests/test_archs_smoke.py holds the JAX
  package, and against the JAX package's decode chain.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.kernels.ssd_scan.ssd_scan import ssd_chunk_pallas
from repro.models import build as jax_build
from repro.models import lm as JLM
from repro.models import ssd as JS
from repro_torch.configs import get_config
from repro_torch.models import build, params_from_numpy
from repro_torch.models import lm as TLM
from repro_torch.models import ssd as TS
from repro_torch.kernels import checks
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

TOL = 2e-4

# (b, s, h, p, g, n, chunk): tests/test_kernels.py's shapes, and the
# serving slice's chunk geometry at two heads
SHAPES = [
    (2, 128, 4, 16, 1, 16, 32),
    (1, 64, 2, 8, 2, 8, 16),
    (2, 96, 6, 8, 3, 4, 32),
    (1, 256, 2, 64, 1, 128, 256),
]


def _seq_inputs(b, s, h, p, g, n, seed):
    """tests/test_kernels.py's input distribution, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, size=(b, s, h)).astype(np.float32)
    a_log = rng.uniform(-1, 1, size=(h,)).astype(np.float32)
    bm = (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    h0 = (rng.normal(size=(b, h, p, n)) * 0.1).astype(np.float32)
    return x, dt, a_log, bm, cm, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_chunk_plain_matches_pallas_interpret(shape):
    b, s, h, p, g, n, chunk = shape
    x, dt, a_log, bm, cm, _ = _seq_inputs(b, s, h, p, g, n, seed=b + s + h)
    nc = s // chunk
    da = (-np.exp(a_log))[None, None, :] * dt
    ins = [a.reshape((b, nc, chunk) + a.shape[2:]) for a in (x, dt, da, bm, cm)]
    y_j, st_j = ssd_chunk_pallas(*map(jnp.asarray, ins), interpret=True)
    y_t, st_t = ssd_chunk_ref(*_t(*ins))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_ssd_chunked_matches_jax_oracle(shape, with_h0):
    b, s, h, p, g, n, chunk = shape
    x, dt, a_log, bm, cm, h0 = _seq_inputs(b, s, h, p, g, n, seed=b + s + h)
    h0 = h0 if with_h0 else None
    y_j, h_j = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm)), chunk,
                              None if h0 is None else jnp.asarray(h0))
    y_t, h_t = ops.ssd_chunked(*_t(x, dt, a_log, bm, cm), chunk,
                               None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=TOL, atol=TOL)
    # the port's own oracle is the same function
    y_o, h_o = TS.ssd_chunked(*_t(x, dt, a_log, bm, cm), chunk,
                              None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y_o.numpy(), np.asarray(y_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h_o.numpy(), np.asarray(h_j), rtol=TOL, atol=TOL)


def test_jax_kernel_wrapper_agrees_with_the_port_entry():
    """The JAX package's kernel entry (Pallas, interpret) and the port's
    ops.ssd_chunked on one input with h0."""
    x, dt, a_log, bm, cm, h0 = _seq_inputs(1, 64, 2, 8, 1, 8, seed=9)
    y_j, h_j = jax_ssd_ops.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm)), 16,
                                       jnp.asarray(h0))
    y_t, h_t = ops.ssd_chunked(*_t(x, dt, a_log, bm, cm), 16, torch.from_numpy(h0))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the block and the LM on reduced mamba2_370m
# ---------------------------------------------------------------------------

def _cfgs(dtype="float32", chunk=None):
    jcfg, tcfg = jax_get_config("mamba2_370m").reduced(), get_config("mamba2_370m").reduced()
    kw = {"param_dtype": dtype, "compute_dtype": dtype}
    jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    if chunk:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk_size=chunk))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk_size=chunk))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm_pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return request.param, jcfg, tcfg, jparams, tparams


def _torch_dtype(dtype):
    return torch.float32 if dtype == "float32" else torch.bfloat16


def _bf16_tol(ref: np.ndarray) -> float:
    """4 bf16 ulps at the largest magnitude of ``ref``."""
    return 4 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _close(dtype, got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_tol(want))


def test_params_carry_bitwise(lm_pair):
    dtype, _, _, jparams, tparams = lm_pair
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves = jax.tree.leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for (jp, jl), tl in zip(jleaves, tleaves):
        assert str(tl.dtype) == f"torch.{jl.dtype}", (jp, tl.dtype, jl.dtype)
        np.testing.assert_array_equal(tl.float().numpy(), np.asarray(jl.astype(jnp.float32)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_block_apply_matches_jax(lm_pair, use_kernel):
    dtype, jcfg, tcfg, jparams, tparams = lm_pair
    rng = np.random.default_rng(3)
    xin = rng.normal(size=(2, 64, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["unit"][0]["ssd"])
    tp = {k: v[0] for k, v in tparams["unit"][0]["ssd"].items()}
    dt = jnp.dtype(dtype)
    out_j, st_j = JS.ssd_block_apply(jp, jcfg, jnp.asarray(xin).astype(dt))
    out_t, st_t = TS.ssd_block_apply(tp, tcfg, torch.from_numpy(xin).to(_torch_dtype(dtype)),
                                     use_kernel=use_kernel)
    assert out_t.dtype == _torch_dtype(dtype) and st_t["h"].dtype == torch.float32
    _close(dtype, out_t, out_j)
    _close(dtype, st_t["conv"], st_j["conv"])
    if dtype == "float32":
        _close(dtype, st_t["h"], st_j["h"])
    else:  # fp32 state from bf16 operands: rounding flips upstream, bf16-sized
        np.testing.assert_allclose(st_t["h"].numpy(), np.asarray(st_j["h"]), rtol=0,
                                   atol=_bf16_tol(np.asarray(st_j["h"])))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lm_forward_matches_jax(lm_pair, use_kernel):
    dtype, jcfg, tcfg, jparams, tparams = lm_pair
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    logits_j, _ = JLM.lm_forward(jparams, jcfg, jnp.asarray(toks))
    logits_t, _ = TLM.lm_forward(tparams, tcfg, torch.from_numpy(toks), use_kernel=use_kernel)
    assert logits_t.shape == (2, 64, jcfg.vocab_size)
    _close(dtype, logits_t, logits_j)


def test_decode_chain_matches_parallel_forward_and_jax():
    """Step-by-step SSD decode == chunked parallel forward (duality), as
    tests/test_archs_smoke.py holds the JAX package (rtol/atol 2e-2); and
    the port's chain equals the JAX package's chain to fp32 tolerance."""
    jcfg, tcfg = _cfgs()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tmodel = build(tcfg)
    B, S = 1, 32
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    full, _ = TLM.lm_forward(tparams, tcfg, torch.from_numpy(toks))
    cache = tmodel.init_cache(B, S)
    jcache = jmodel.init_cache(B, S)
    jstep = jax.jit(jmodel.decode_step)
    outs, jouts = [], []
    for t in range(S):
        lg, cache = tmodel.decode_step(tparams, cache, torch.from_numpy(toks[:, t:t + 1]),
                                       torch.tensor(t))
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t))
        outs.append(lg[:, 0].numpy())
        jouts.append(np.asarray(jlg[:, 0]))
    step = np.stack(outs, axis=1)
    np.testing.assert_allclose(step, full.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(step, np.stack(jouts, axis=1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cache["unit"][0]["h"].numpy(),
                               np.asarray(jcache["unit"][0]["h"]), rtol=1e-4, atol=1e-4)


def test_prefill_then_decode_carries_state():
    """A chunked prefill with a cache, then decode steps, equals the
    parallel forward over the whole sequence (chunk 4, as
    tests/test_serve_engine.py::test_parity_ssd_close), through the kernel
    path's h0 hand-off."""
    _, tcfg = _cfgs(chunk=4)
    tmodel = build(tcfg)
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32))
    full, _ = TLM.lm_forward(tparams, tcfg, toks)
    logits, cache = tmodel.prefill(tparams, {"tokens": toks[:, :8]})
    outs = [logits]
    for t in range(8, 12):
        lg, cache = tmodel.decode_step(tparams, cache, toks[:, t:t + 1], torch.full((2,), t))
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


def test_layer_kinds_not_ported_raise():
    """Every layer kind of the JAX package is ported (an unknown one is a
    ``ValueError``, as there), and an SSD stack trains: its loss is finite
    (tests/test_torch_ssd_train.py holds it and its gradients to JAX)."""
    cfg = dataclasses.replace(get_config("mamba2_370m").reduced(), attn_pattern=("mlstm",))
    with pytest.raises(ValueError, match="mlstm"):
        build(cfg).init(torch.Generator().manual_seed(0))
    model = build(get_config("mamba2_370m").reduced())
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 32), dtype=torch.int32)
    assert torch.isfinite(model.loss_fn(params, {"tokens": toks, "labels": toks}))


def test_plain_version_fp32_error_budget_at_full_width():
    """The error budget behind ``checks.SSD_TOL``: at the serving slice's
    chunk geometry (Q=256, P=64, N=128) with full-width inputs (cum falls
    to ~-3e3 over a chunk), the fp32 plain version stays within a fifth of
    SSD_TOL of a float64 evaluation, so two fp32 evaluations in different
    sum orders (kernel and plain) stay within SSD_TOL of each other."""
    case = checks.SsdCase("budget", 1, 512, 4, 64, 1, 128, 256, "model")
    ins = checks.ssd_chunk_inputs(case, "cpu")
    assert float(torch.cumsum(ins[2], dim=2).min()) < -1000
    y32, st32 = ssd_chunk_ref(*ins)
    y64, st64 = ssd_chunk_ref(*[t.double() for t in ins])
    for a, b in ((y32, y64), (st32, st64)):
        rel = float((a.double() - b).abs().max() / b.abs().max())
        assert rel < checks.SSD_TOL / 5, rel


def test_ssd_kernel_head_slice_and_grid():
    """The CUDA wrapper's head slice (its arithmetic runs without a card):
    at the serving slice's shape on an H100's 132 SMs, 6 heads per block,
    so C B^T is computed 6 times per (batch*chunk, group) instead of 32,
    in 288 blocks; at the tensor-parallel shapes (16 heads a rank, B*NC =
    4: ``checks.ssd_tp_cases()``) 1, in 384 blocks; never more heads than
    a group has, nor than 6."""
    from repro_torch.kernels.ssd_scan.ssd_scan import (MAX_HEADS_PER_BLOCK, grid_blocks,
                                                       head_slice)

    assert head_slice(8, 256, 32, 1, 128, 132) == 6
    assert grid_blocks(8, 256, 32, 1, 128, 6) == 8 * 6 * (4 + 2)
    for case in checks.ssd_tp_cases():
        bnc = case.b * (case.s // case.chunk)
        assert head_slice(bnc, case.chunk, case.h, case.g, case.n, 132) == 1, case.name
        assert grid_blocks(bnc, case.chunk, case.h, case.g, case.n, 1) == 4 * 16 * (4 + 2)
    for bnc, q, h, g, n in ((1, 1, 2, 2, 3), (2, 64, 40, 2, 32), (8, 256, 32, 1, 128),
                            (64, 256, 48, 1, 128), (1, 200, 3, 3, 3)):
        hs = head_slice(bnc, q, h, g, n, 132)
        assert 1 <= hs <= min(MAX_HEADS_PER_BLOCK, h // g)


@pytest.mark.parametrize("case", checks.ssd_cases(), ids=lambda c: c.name.replace(" ", "-"))
def test_card_check_cases_hold_on_the_cpu(case):
    """The cases chip_smoke.py and tests/test_torch_gpu.py run on the card,
    with the plain chunk term in place of the kernel: ``ops.ssd_chunked``
    vs the oracle within ``SSD_TOL``, finite where exp(cum_i - cum_j)
    overflows above the diagonal."""
    checks.check_ssd_chunked(case, "cpu", with_h0=True)
