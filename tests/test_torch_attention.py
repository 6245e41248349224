"""The port's attention, RoPE and MLP layers against the JAX package's, on
the same numpy inputs and the same params (carried by ``params_from_numpy``).

Tolerances:
- fp32: 1e-5 of the reference's largest magnitude. Both packages compute
  the same algebra in fp32 with sums in other orders (~1e-7 relative).
- bf16 params and compute: 2 bf16 ulps at the reference's largest
  magnitude. Both packages cast at the same points (RoPE promotes a bf16
  q/k to fp32, the cache stores bf16, the products run in fp32, the output
  is cast before ``wo``); a change of fp32 summation order can move a
  bf16 rounding by one step, and the residual path adds one more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.serve import paged_cache as jax_pc
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import params_from_numpy
from repro_torch.serve import reset_slots, select_slots

FP32_TOL = 1e-5
BF16_ULPS = 2


def _cfgs(arch="llama3_8b", dtype="float32", **kw):
    kw.update(param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _tdtype(dtype):
    return torch.float32 if dtype == "float32" else torch.bfloat16


def _close(got: torch.Tensor, want, dtype="float32") -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    if dtype == "float32":
        tol = FP32_TOL * peak
    else:
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(peak)) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True], ids=["positions-S", "positions-BS"])
@pytest.mark.parametrize("style", ["full", "half"])
def test_rope_matches_jax(style, per_row):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = (np.stack([np.arange(5, 12), np.arange(100, 107)]) if per_row
           else np.arange(3, 10)).astype(np.int32)
    dim = 32 if style == "full" else 16
    cj, sj = JL.rope_angles(jnp.asarray(pos), dim, 500000.0)
    ct, st = TL.rope_angles(torch.from_numpy(pos), dim, 500000.0)
    _close(ct, cj)
    _close(st, sj)
    _close(TL.apply_rope(torch.from_numpy(x), ct, st, style),
           JL.apply_rope(jnp.asarray(x), cj, sj, style))
    if style == "half":   # the second half of each head passes through
        out = TL.apply_rope(torch.from_numpy(x), ct, st, style)
        np.testing.assert_array_equal(out[..., 16:].numpy(), x[..., 16:])


def test_rope_of_bf16_is_fp32_in_both_packages():
    x = np.random.default_rng(1).normal(size=(1, 4, 2, 32)).astype(np.float32)
    cj, sj = JL.rope_angles(jnp.arange(4), 32, 10000.0)
    ct, st = TL.rope_angles(torch.arange(4), 32, 10000.0)
    yj = JL.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), cj, sj, "full")
    yt = TL.apply_rope(torch.from_numpy(x).to(torch.bfloat16), ct, st, "full")
    assert yj.dtype == jnp.float32 and yt.dtype == torch.float32
    _close(yt, yj)


# ---------------------------------------------------------------------------
# the streaming softmax
# ---------------------------------------------------------------------------

def _qkv(b, sq, skv, hkv, g, dh, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, sq, hkv, g, dh)) / np.sqrt(dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_chunk", [4, 16], ids=["kv_chunk<S-padded", "one-chunk"])
def test_chunked_softmax_attend_matches_jax(kv_chunk, causal, window):
    """S = 13 keys: kv_chunk 4 streams four chunks, the last padded by 3."""
    q, k, v = _qkv(2, 13, 13, 2, 2, 16, seed=kv_chunk + 2 * causal + window)
    want = JL._chunked_softmax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0,
                                      causal, window, kv_chunk)
    got = TL._chunked_softmax_attend(*map(torch.from_numpy, (q, k, v)), 0, causal,
                                     window, kv_chunk)
    assert got.shape == (2, 13, 2, 2, 16)
    _close(got, want)


def test_chunked_softmax_attend_with_a_query_offset():
    """Queries at positions 6.. over 10 keys (a tensor offset, as the ring
    prefill passes it): the causal mask is taken on absolute positions."""
    q, k, v = _qkv(1, 4, 10, 1, 3, 8, seed=4)
    want = JL._chunked_softmax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.int32(6), True, 0, 4)
    got = TL._chunked_softmax_attend(*map(torch.from_numpy, (q, k, v)), torch.tensor(6),
                                     True, 0, 4)
    _close(got, want)


@pytest.mark.parametrize("window", [0, 3])
def test_attend_masked_matches_jax_with_frozen_rows(window):
    """Row 0 live at positions 4..6 over keys 0..7 with two empty slots;
    row 1 frozen (every position negative): every score is masked, so the
    row comes out as the mean of its V rows in both packages, finite,
    never NaN."""
    q, k, v = _qkv(2, 3, 8, 2, 2, 16, seed=7 + window)
    q_pos = np.array([[4, 5, 6], [-(2 ** 30), -(2 ** 30) + 1, -(2 ** 30) + 2]], np.int32)
    kv_pos = np.array([[0, 1, 2, 3, 4, 5, 6, -1], [0, 1, 2, -1, -1, -1, -1, -1]], np.int32)
    want = JL._attend_masked(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)), window)
    got = TL._attend_masked(*map(torch.from_numpy, (q, k, v, q_pos, kv_pos)), window)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_attend_masked_is_one_chunk_of_the_streaming_softmax():
    """DESIGN.md §9: the decode path's attention over a full cache is the
    prefill path's one-chunk case (causal, positions 0..S-1)."""
    q, k, v = _qkv(2, 6, 6, 2, 2, 8, seed=3)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    a = TL._attend_masked(*map(torch.from_numpy, (q, k, v, pos, pos)), 0)
    b = TL._chunked_softmax_attend(*map(torch.from_numpy, (q, k, v)), 0, True, 0, 1024)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=FP32_TOL)


# ---------------------------------------------------------------------------
# attention_apply: no cache and both dense-cache branches
# ---------------------------------------------------------------------------

def _attn_pair(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = JL.attention_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _cache(cfg, b, length, filled, seed):
    rng = np.random.default_rng(seed)
    shape = (b, length, cfg.n_kv_heads, cfg.head_dim)
    pos = np.full((b, length), -1, np.int32)
    pos[:, :filled] = np.arange(filled)
    return {"k": rng.normal(size=shape).astype(np.float32),
            "v": rng.normal(size=shape).astype(np.float32), "pos": pos}


def _as_jax(cache, dtype):
    return {k: jnp.asarray(v).astype(jnp.dtype(dtype)) if k != "pos" else jnp.asarray(v)
            for k, v in cache.items()}


def _as_torch(cache, dtype):
    return {k: torch.from_numpy(v).to(_tdtype(dtype)) if k != "pos" else torch.from_numpy(v)
            for k, v in cache.items()}


BRANCHES = ["no-cache", "ring-prefill", "incremental", "decode"]


@pytest.mark.parametrize("arch,dtype,branch", [
    ("llama3_8b", dtype, branch) for dtype in ("float32", "bfloat16") for branch in BRANCHES
] + [("chatglm3_6b", "float32", "incremental"), ("granite_20b", "float32", "incremental")])
def test_attention_apply_matches_jax(arch, dtype, branch):
    """``ring-prefill``: 10 tokens into an 8-slot cache (keeps the last 8);
    ``incremental``: a 3-token chunk at per-row positions 5.. into a
    16-slot cache, row 2 frozen; ``decode``: one token per row at a
    scalar position."""
    jcfg, tcfg, jp, tp = _attn_pair(arch, dtype)
    b, s, length, pos = {
        "no-cache": (2, 6, None, np.arange(6)),
        "ring-prefill": (2, 10, 8, np.arange(10)),
        "incremental": (3, 3, 16, np.stack([np.arange(5, 8), np.arange(9, 12),
                                            -(2 ** 30) + np.arange(3)])),
        "decode": (2, 1, 16, np.array([5])),
    }[branch]
    pos = pos.astype(np.int32)
    x = np.random.default_rng(5).normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), _tdtype(dtype)
    cache = None if length is None else _cache(jcfg, b, length, 5, seed=6)
    out_j, nc_j = JL.attention_apply(jp, jcfg, jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                                     cache=None if cache is None else _as_jax(cache, dtype))
    out_t, nc_t = TL.attention_apply(tp, tcfg, torch.from_numpy(x).to(tdt),
                                     torch.from_numpy(pos),
                                     cache=None if cache is None else _as_torch(cache, dtype))
    assert out_t.dtype == tdt and torch.isfinite(out_t.float()).all()
    live = slice(0, 2)   # row 2 of "incremental" is frozen: its output is discarded
    _close(out_t[live], np.asarray(out_j.astype(jnp.float32))[live], dtype)
    if cache is None:
        assert nc_t is None and nc_j is None
        return
    for key in ("k", "v"):
        assert nc_t[key].dtype == tdt
        _close(nc_t[key], nc_j[key], dtype)
    np.testing.assert_array_equal(nc_t["pos"].numpy(), np.asarray(nc_j["pos"]))


def test_frozen_rows_write_nothing():
    """A frozen row's K/V/pos rows come back exactly as they went in (the
    JAX package drops them at an out-of-range index; the port writes the
    old values back), and live rows land at pos % cache_len."""
    jcfg, tcfg, _, tp = _attn_pair("llama3_8b", "float32")
    cache = _cache(jcfg, 2, 8, 5, seed=1)
    pos = np.stack([np.arange(6, 9), -(2 ** 30) + np.arange(3)]).astype(np.int32)
    x = np.random.default_rng(2).normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    _, nc = TL.attention_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                               cache=_as_torch(cache, "float32"))
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(nc[key][1].numpy(), cache[key][1])
    np.testing.assert_array_equal(nc["pos"][0].numpy(), [8, 1, 2, 3, 4, -1, 6, 7])
    np.testing.assert_array_equal(nc["k"][0, 3:5].numpy(), cache["k"][0, 3:5])


def test_paged_and_cross_attention_are_not_ported():
    """The paged half runs: a paged call (one row's blocks 2, 0 in an
    unordered 4-block pool of 4 slots each, a 3-token chunk at positions
    5..7) equals the dense call on the same keys bitwise, and a frozen row
    writes nothing to the pools. Cross-attention is ported too (item 8d;
    tests/test_torch_encdec.py holds it to the JAX package): given a cache,
    it neither reads nor writes it."""
    jcfg, tcfg, _, tp = _attn_pair("llama3_8b", "float32")
    dense = _as_torch(_cache(jcfg, 2, 8, 5, seed=1), "float32")
    pool = {"pk": torch.zeros((4, 4, jcfg.n_kv_heads, jcfg.head_dim)),
            "pv": torch.zeros((4, 4, jcfg.n_kv_heads, jcfg.head_dim)),
            "ppos": torch.full((4, 4), -1, dtype=torch.int32)}
    bt = torch.tensor([[2, 0], [-1, -1]], dtype=torch.int32)
    for key, pkey in (("k", "pk"), ("v", "pv"), ("pos", "ppos")):
        pool[pkey][2], pool[pkey][0] = dense[key][0, :4], dense[key][0, 4:]
    pos = torch.stack([torch.arange(5, 8), -(2 ** 30) + torch.arange(3)]).to(torch.int32)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 3, jcfg.d_model)).astype(np.float32))
    out_d, nc_d = TL.attention_apply(tp, tcfg, x, pos, cache=dense)
    out_p, nc_p = TL.attention_apply(tp, tcfg, x, pos, cache=pool, block_table=bt)
    assert torch.equal(out_p[0], out_d[0]) and torch.isfinite(out_p).all()
    for key, pkey in (("k", "pk"), ("v", "pv"), ("pos", "ppos")):
        assert torch.equal(torch.cat([nc_p[pkey][2], nc_p[pkey][0]]), nc_d[key][0])
        assert torch.equal(nc_p[pkey][[1, 3]], pool[pkey][[1, 3]])
    with pytest.raises(ValueError, match="block table"):
        TL.attention_apply(tp, tcfg, x, pos, cache=pool)
    kv = x.reshape(2, 3, -1, jcfg.head_dim)[:, :, :jcfg.n_kv_heads]
    out_x, nc_x = TL.attention_apply(tp, tcfg, x, pos, cache=pool, block_table=bt,
                                     cross_kv=(kv, kv))
    out_n, _ = TL.attention_apply(tp, tcfg, x, torch.arange(3), cross_kv=(kv, kv))
    assert nc_x is None and torch.equal(out_x, out_n) and torch.isfinite(out_x).all()


# ---------------------------------------------------------------------------
# MLPs, params and slot ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(variant, dtype):
    jcfg, tcfg = _cfgs("llama3_8b", dtype, mlp_variant=variant)
    jp = JL.mlp_init(jax.random.PRNGKey(4), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert sorted(tp) == (["w_down", "w_gate", "w_up"] if variant != "gelu"
                          else ["w_down", "w_up"])
    x = np.random.default_rng(6).normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    want = JL.mlp_apply(jp, jcfg, jnp.asarray(x).astype(jnp.dtype(dtype)))
    got = TL.mlp_apply(tp, tcfg, torch.from_numpy(x).to(_tdtype(dtype)))
    assert got.dtype == _tdtype(dtype)
    _close(got, want, dtype)


def test_params_from_numpy_carries_bf16_attention_and_mlp_leaves_bitwise():
    jcfg, _ = _cfgs("llama3_8b", "bfloat16")
    tree = {"attn": JL.attention_init(jax.random.PRNGKey(0), jcfg),
            "mlp": JL.mlp_init(jax.random.PRNGKey(1), jcfg)}
    got = params_from_numpy(jax.tree.map(np.asarray, tree))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(got)):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape, path
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a.astype(jnp.float32)))


def test_slot_ops_on_a_kv_cache_match_jax():
    """reset_slots sets a recycled slot's pos rows to -1 and leaves K/V;
    select_slots passes KV leaves through; on a stacked ("unit", batch
    axis 1) and an unstacked ("rem") tree."""
    rng = np.random.default_rng(0)

    def layer(*lead):
        return {"k": rng.normal(size=lead + (4, 6, 2, 3)).astype(np.float32),
                "v": rng.normal(size=lead + (4, 6, 2, 3)).astype(np.float32),
                "pos": rng.integers(-1, 6, size=lead + (4, 6)).astype(np.int32)}

    tree = {"unit": [layer(3)], "rem": [layer()]}
    other = jax.tree.map(lambda a: a + 1, tree)
    mask = np.array([True, False, True, False])
    for jfn, tfn, args in (
        (jax_pc.reset_slots, reset_slots, (tree,)),
        (jax_pc.select_slots, select_slots, (tree, other)),
    ):
        want = jfn(*[jax.tree.map(jnp.asarray, t) for t in args], jnp.asarray(mask))
        got = tfn(*[params_from_numpy(t) for t in args], torch.from_numpy(mask))
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
