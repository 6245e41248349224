"""The port's paged KV cache against the JAX package's, on the same numpy
inputs and the same params (carried by ``params_from_numpy``).

- host-side pieces: the block allocator, the slot lifecycle ops with the
  pools in the tree, the cache codec, bits per token and ``cache_bytes``,
  equal to JAX's;
- the paged branch of ``attention_apply`` with a frozen row and -1 table
  entries: outputs and the new pools within 1e-6 of the reference's
  largest magnitude (fp32, sums in other orders; the K/V written are the
  same projections), positions equal;
- the paged engine: tokens equal to the port's dense engine's and to the
  JAX paged engine's on reduced internvl2_2b and llama3_8b, its
  ``cache_stats`` equal to JAX's (the high-water at or below the dense
  bytes), a pool of 8 blocks that forces recycling, a bf16 cache within
  the JAX test's 0.15 of the fp32 chain (``tests/test_paged_cache.py``),
  and the launcher's ``--block-size`` / ``--cache-dtype``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bits as jax_bits
from repro.comm.transport import ActivationLayout as JaxLayout
from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.models import layers as JL
from repro.serve import BatchedServer as JaxServer
from repro.serve import Request as JaxRequest
from repro.serve import build_serve as jax_build_serve
from repro.serve import paged_cache as jax_pc
from repro_torch.comm import bits
from repro_torch.comm.transport import ActivationLayout
from repro_torch.configs import get_config
from repro_torch.models import build, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.serve import (BatchedServer, BlockAllocator, Request, build_serve,
                               cache_bytes, cache_layout, paged_bits_per_token,
                               release_blocks, reset_slots, select_slots)

TOL = 1e-6
BATCH, MAX_SEQ, MAX_NEW = 2, 32, 4


def _leaves_equal(got, want):
    jl, tl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# host-side pieces
# ---------------------------------------------------------------------------

def _check_allocator():
    """The same allocate / free sequence hands out the same ids, with the
    same high-water mark and exhaustion; the port refuses a double free
    with ValueError where the JAX package asserts."""
    ja, ta = jax_pc.BlockAllocator(6, 8), BlockAllocator(6, 8)
    for n in (1, 8, 9, 17):
        assert ta.blocks_for(n) == ja.blocks_for(n)
    seq = [("a", 3), ("a", 2), ("f", 0), ("a", 4), ("f", 1), ("a", 1)]
    got = {}
    for op, arg in seq:
        if op == "a":
            ids = ta.allocate(arg)
            assert ids == ja.allocate(arg)
            got[len(got)] = ids
        else:
            ta.free(got[arg])
            ja.free(got[arg])
        assert (ta.used_blocks, ta.free_blocks, ta.high_water) == (
            ja.used_blocks, ja.free_blocks, ja.high_water)
    for al in (ja, ta):
        with pytest.raises(RuntimeError, match="exhausted"):
            al.allocate(al.free_blocks + 1)
    with pytest.raises(ValueError, match="not an allocated block"):
        ta.free([ta._free[0]])


def _toy_cache(rng):
    """A stacked ("unit") dense layer with a recurrent state, an unstacked
    ("rem") paged layer and a stacked paged layer, and the block table."""
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def i(*shape):
        return rng.integers(-1, 8, size=shape).astype(np.int32)

    return {
        "unit": [{"k": f(2, 3, 4, 1, 2), "pos": i(2, 3, 4), "h": f(2, 3, 5)},
                 {"pk": f(2, 6, 2, 1, 2), "pv": f(2, 6, 2, 1, 2), "ppos": i(2, 6, 2)}],
        "rem": [{"pk": f(6, 2, 1, 2), "pv": f(6, 2, 1, 2), "ppos": i(6, 2)}],
        "bt": i(3, 3),
    }


def _check_slot_ops():
    """reset_slots masks only pos and recurrent rows and passes the pools
    and the block table through untouched (the same tensors);
    select_slots takes recurrent rows only; release_blocks poisons the
    freed blocks' positions in stacked and flat pools, from a list or a
    tensor of ids."""
    rng = np.random.default_rng(0)
    tree, other = _toy_cache(rng), _toy_cache(rng)
    mask = np.array([True, False, True])
    jt, jo = (jax.tree.map(jnp.asarray, t) for t in (tree, other))
    tt, to = params_from_numpy(tree), params_from_numpy(other)
    got = reset_slots(tt, torch.from_numpy(mask))
    _leaves_equal(got, jax_pc.reset_slots(jt, jnp.asarray(mask)))
    for key in ("pk", "pv", "ppos"):
        assert got["rem"][0][key] is tt["rem"][0][key]
        assert got["unit"][1][key] is tt["unit"][1][key]
    assert got["bt"] is tt["bt"]
    _leaves_equal(select_slots(tt, to, torch.from_numpy(mask)),
                  jax_pc.select_slots(jt, jo, jnp.asarray(mask)))
    want = jax_pc.release_blocks(jt, jnp.asarray([1, 4, 6, 6]))   # 6 = JAX's OOB pad
    _leaves_equal(release_blocks(tt, [1, 4]), want)
    _leaves_equal(release_blocks(tt, torch.tensor([4, 1])), want)
    assert torch.equal(release_blocks(tt, [])["rem"][0]["ppos"], tt["rem"][0]["ppos"])
    np.testing.assert_array_equal(tree["rem"][0]["ppos"], tt["rem"][0]["ppos"].numpy())


def _check_activation_layout(k_ratio, block, wire_dtype):
    """Bits for every k_ratio and block (u8 / u16 / u32 indices); the
    dtype-cast codec bitwise; the blocked top-k encode (the pipeline
    ring's) bitwise the JAX encode, values and indices, and its decode."""
    jl, tl = JaxLayout(wire_dtype, k_ratio, block), ActivationLayout(wire_dtype, k_ratio, block)
    assert tl.is_identity == jl.is_identity
    for elems in (1, 255, 4096, 100_003):
        assert tl.payload_bits(elems) == jl.payload_bits(elems)
        assert bits.activation_payload_bits(wire_dtype, k_ratio, block, elems) == \
            jax_bits.activation_payload_bits(wire_dtype, k_ratio, block, elems)
    x = np.random.default_rng(1).normal(size=(3, 5, 7)).astype(np.float32)
    if k_ratio > 0:
        (jv, ji), (tv, ti) = jl.encode(jnp.asarray(x)), tl.encode(torch.from_numpy(x))
        assert str(tv.dtype) == f"torch.{jv.dtype}" and str(ti.dtype) == f"torch.{ji.dtype}"
        np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
        np.testing.assert_array_equal(ti.long().numpy(), np.asarray(ji).astype(np.int64))
        np.testing.assert_array_equal(tl.decode((tv, ti), x.shape).numpy(),
                                      np.asarray(jl.decode((jv, ji), x.shape)))
        return
    (jw,), (tw,) = jl.encode(jnp.asarray(x)), tl.encode(torch.from_numpy(x))
    assert str(tw.dtype) == f"torch.{jw.dtype}"
    back = tl.decode((tw,), x.shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jl.decode((jw,), x.shape)))


def _check_cache_tree(arch, cache_dtype):
    """``Model.init_paged_cache``: the same tree, shapes, dtypes and
    contents (pools zero, positions and table -1) as JAX's; the codec,
    bits per token and ``cache_bytes`` equal; the full configs' bits per
    token too."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    want = jax_build(jcfg).init_paged_cache(3, 32, 10, 8, cache_dtype=cache_dtype)
    got = build(tcfg).init_paged_cache(3, 32, 10, 8, cache_dtype)
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = jax.tree.leaves(got)
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}", path
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, dtype=np.float32))
    assert cache_bytes(got) == jax_pc.cache_bytes(want)
    for full in (False, True):
        jc, tc = (jax_get_config(arch), get_config(arch)) if full else (jcfg, tcfg)
        jlay, tlay = jax_pc.cache_layout(jc, cache_dtype), cache_layout(tc, cache_dtype)
        assert (tlay.wire_dtype, tlay.k_ratio) == (jlay.wire_dtype, jlay.k_ratio)
        assert paged_bits_per_token(tc, tlay) == jax_pc.paged_bits_per_token(jc, jlay)
    # llama3_8b: 32 layers x (2 x 8 x 128 x 16 + 32) bits = 131,200 bytes a token
    if arch == "llama3_8b":
        full = get_config(arch)
        assert paged_bits_per_token(full, cache_layout(full)) / 8 == 131_200


def _check_nothing_to_page():
    for arch in ("mamba2_370m", "mixtral_8x7b"):
        assert build(get_config(arch).reduced()).init_paged_cache is None
        assert jax_build(jax_get_config(arch).reduced()).init_paged_cache is None


# ---------------------------------------------------------------------------
# the paged branch of attention_apply
# ---------------------------------------------------------------------------

def _check_paged_attention(dtype):
    """3 rows over a 7-block pool of 4 slots, tables of 4 entries: row 0
    at positions 6..8 (blocks 5, 2, 0, -1), row 1 at 1..3 with an
    unassigned second entry (its positions 4.. would go nowhere) and row
    2 frozen. The pools hold random stale K/V and positions of other
    blocks; the last block's positions are poisoned (a free block), since
    the JAX package reads a -1 entry as that block
    (``_check_unassigned_entries``). fp32: outputs and pools
    within 1e-6 of max; bf16: the pools' values bitwise (the codec's cast
    of K/V within fp32 round-off of each other), outputs within 2 bf16
    ulps."""
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jcfg = dataclasses.replace(jax_get_config("llama3_8b").reduced(), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(get_config("llama3_8b").reduced(), param_dtype=dtype,
                               compute_dtype=dtype)
    jp = JL.attention_init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(4)
    nb, bs, hkv, dh = 7, 4, jcfg.n_kv_heads, jcfg.head_dim
    pool = {"pk": rng.normal(size=(nb, bs, hkv, dh)).astype(np.float32),
            "pv": rng.normal(size=(nb, bs, hkv, dh)).astype(np.float32),
            "ppos": rng.integers(-1, 16, size=(nb, bs)).astype(np.int32)}
    bt = np.array([[5, 2, 0, -1], [3, -1, -1, -1], [1, 4, -1, -1]], np.int32)
    pool["ppos"][5], pool["ppos"][2], pool["ppos"][3] = range(4), range(4, 8), [0, -1, -1, -1]
    pool["ppos"][nb - 1] = -1
    pos = np.stack([np.arange(6, 9), np.arange(1, 4), -(2 ** 30) + np.arange(3)]).astype(np.int32)
    x = rng.normal(size=(3, 3, jcfg.d_model)).astype(np.float32)
    jcache = {k: jnp.asarray(v).astype(jnp.dtype(dtype)) if k != "ppos" else jnp.asarray(v)
              for k, v in pool.items()}
    tcache = {k: torch.from_numpy(v).to(tdt) if k != "ppos" else torch.from_numpy(v)
              for k, v in pool.items()}
    out_j, nc_j = JL.attention_apply(jp, jcfg, jnp.asarray(x).astype(jnp.dtype(dtype)),
                                     jnp.asarray(pos), cache=jcache, block_table=jnp.asarray(bt))
    out_t, nc_t = TL.attention_apply(tp, tcfg, torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                                     cache=tcache, block_table=torch.from_numpy(bt))
    assert torch.isfinite(out_t.float()).all()
    np.testing.assert_array_equal(nc_t["ppos"].numpy(), np.asarray(nc_j["ppos"]))
    live = slice(0, 2)
    want = np.asarray(out_j.astype(jnp.float32))[live]
    peak = float(np.abs(want).max())
    tol = TOL * peak if dtype == "float32" else 2 * 2.0 ** (np.floor(np.log2(peak)) - 7)
    np.testing.assert_allclose(out_t[live].float().numpy(), want, rtol=0, atol=tol)
    for key in ("pk", "pv"):
        assert nc_t[key].dtype == tdt
        a, b = np.asarray(nc_j[key].astype(jnp.float32)), nc_t[key].float().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL * float(np.abs(a).max())
                                   if dtype == "float32" else 0.0)
        # the frozen row and the blocks no table entry reaches keep their values
        np.testing.assert_array_equal(b[[1, 4, 6]], np.asarray(jcache[key].astype(
            jnp.float32))[[1, 4, 6]])


def _check_unassigned_entries():
    """A -1 table entry reads as zeros at position -1, whatever the pool's
    last block holds: the output is the same with that block live (here
    positions 0..3 of another sequence) or poisoned. This is the JAX
    package's stated contract (``jnp.take(..., mode="fill")``); the
    installed JAX (0.9.0) wraps -1 to the last block instead, so the
    reference would attend to another sequence's keys once the pool's last
    block is live (ROADMAP, faults observed in the reference)."""
    cfg = get_config("llama3_8b").reduced()
    tp = TL.attention_init(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    nb, bs = 4, 4
    pool = {"pk": torch.randn((nb, bs, cfg.n_kv_heads, cfg.head_dim), generator=g),
            "pv": torch.randn((nb, bs, cfg.n_kv_heads, cfg.head_dim), generator=g),
            "ppos": torch.full((nb, bs), -1, dtype=torch.int32)}
    pool["ppos"][0] = torch.arange(4)
    bt = torch.tensor([[0, -1]], dtype=torch.int32)
    x = torch.randn((1, 1, cfg.d_model), generator=g)
    pos = torch.tensor([[4]], dtype=torch.int32)    # its own block 0 holds 0..3
    poisoned, _ = TL.attention_apply(tp, cfg, x, pos, cache=pool, block_table=bt)
    live = dict(pool, ppos=pool["ppos"].clone())
    live["ppos"][nb - 1] = torch.arange(4)
    got, nc = TL.attention_apply(tp, cfg, x, pos, cache=live, block_table=bt)
    assert torch.equal(got, poisoned)
    # the write through the -1 entry (position 4 -> entry 1) went nowhere
    assert torch.equal(nc["ppos"], live["ppos"]) and torch.equal(nc["pk"], live["pk"])


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

PROMPTS = (9, 5, 12, 20)    # 2 slots: requests 2 and 3 take recycled slots and blocks


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPTS]


def _drain(srv, prompts, req=Request):
    for uid, p in enumerate(prompts):
        srv.submit(req(uid, p, MAX_NEW))
    done, pending = srv.drain(strict=True)
    assert not pending
    return {r["uid"]: r["tokens"] for r in done}


def _check_paged_engine(arch, mesh2d):
    """The JAX paged engine and the port's paged and dense engines on the
    same params and requests (block 8): tokens equal in all three, the
    stats and the final block table the JAX engine's, every block back;
    the high-water at or below the dense bytes; then pools of 3 and 8
    blocks (the largest request's worth, and two 32-token rows' worth)
    force later requests to wait for recycled blocks, and the tokens still
    equal the dense run's."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel = jax_build(jcfg)
    jserve = jax_build_serve(jmodel, mesh2d, fsdp="data", tp="model")
    jparams = jax.jit(jmodel.init, out_shardings=jserve.param_shardings)(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    prompts = _prompts(jcfg.vocab_size)
    jsrv = JaxServer(jserve, jparams, jcfg, BATCH, MAX_SEQ, paged=True, block_size=8)
    jtok = _drain(jsrv, prompts, JaxRequest)
    serve = build_serve(build(tcfg))
    psrv, dsrv = (BatchedServer(serve, tparams, tcfg, BATCH, MAX_SEQ, paged=paged, block_size=8)
                  for paged in (True, False))
    ptok, dtok = _drain(psrv, prompts), _drain(dsrv, prompts)
    assert psrv.paged and len(ptok) == len(PROMPTS)
    assert ptok == dtok == jtok
    assert psrv.stats == jsrv.stats
    assert psrv.allocator.free_blocks == psrv.allocator.num_blocks
    np.testing.assert_array_equal(psrv.cache["bt"].numpy(), np.asarray(jsrv.cache["bt"]))

    st = psrv.cache_stats()
    assert st == jsrv.cache_stats()
    assert st["high_water_bytes"] <= st["dense_equiv_bytes"]
    assert st["block_high_water"] <= st["num_blocks"] == BATCH * MAX_SEQ // 8
    assert st["dense_equiv_bytes"] == BATCH * MAX_SEQ * st["kv_bits_per_token"] / 8
    # the pools hold the dense-equivalent bytes; the table adds its int32s
    assert st["cache_bytes"] == st["dense_equiv_bytes"] + BATCH * MAX_SEQ // 8 * 4
    assert dsrv.cache_stats()["paged"] is False

    for blocks in (3, 8):
        small = BatchedServer(serve, tparams, tcfg, BATCH, MAX_SEQ, paged=True, block_size=8,
                              num_blocks=blocks)
        assert _drain(small, prompts) == dtok
        assert small.allocator.free_blocks == blocks >= small.allocator.high_water


def _check_bf16_cache():
    """tests/test_paged_cache.py::test_quantized_cache_blocks_parity_tolerance
    on the port: a bf16-block chain within 0.15 of the fp32-block chain,
    the pools in bf16 and smaller; and the port's bf16 chain against the
    JAX package's."""
    jcfg, tcfg = jax_get_config("llama3_8b").reduced(), get_config("llama3_8b").reduced()
    jmodel, tmodel = jax_build(jcfg), build(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    b, s, n = 2, 8, 4
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (b, s + n)).astype(np.int32)
    bt = np.array([[0, 1], [2, 3]], np.int32)

    def chain(model, params, cache_dtype, to):
        cache = (model.init_paged_cache(b, 16, 4, 8, cache_dtype) if to is torch.from_numpy
                 else model.init_paged_cache(b, 16, num_blocks=4, block_size=8,
                                             cache_dtype=cache_dtype))
        cache["bt"] = to(bt)
        logits, cache = model.decode_step(params, cache, to(toks[:, :s]),
                                          to(np.zeros((b,), np.int32)))
        outs = [np.asarray(logits)]
        for t in range(s, s + n):
            logits, cache = model.decode_step(params, cache, to(toks[:, t:t + 1]),
                                              to(np.full((b,), t, np.int32)))
            outs.append(np.asarray(logits))
        return np.concatenate(outs, axis=1), cache

    f32, c32 = chain(tmodel, tparams, None, torch.from_numpy)
    bf16, c16 = chain(tmodel, tparams, "bfloat16", torch.from_numpy)
    pools = [c16["unit"][0][k] for k in ("pk", "pv")]
    assert all(x.dtype == torch.bfloat16 for x in pools)
    assert cache_bytes(c16) < cache_bytes(c32)
    np.testing.assert_allclose(bf16, f32, atol=0.15, rtol=0.15)
    jbf16, _ = chain(jmodel, jparams, "bfloat16", jnp.asarray)
    err = float(np.abs(bf16 - jbf16).max()) / float(np.abs(jbf16).max())
    assert err <= 1e-2, err


def _check_launcher():
    from repro_torch.launch import serve as launch

    lines = []
    argv = ["--arch", "internvl2_2b", "--reduced", "--device", "cpu", "--requests", "3",
            "--prompt-len", "10", "--max-new", "3", "--max-seq", "64"]
    srv, done = launch.serve(argv + ["--block-size", "8", "--cache-dtype", "bfloat16"],
                             log_fn=lines.append)
    st = srv.cache_stats()
    assert srv.paged and st["cache_dtype"] == "bfloat16" and srv.allocator.block_size == 8
    assert st["num_blocks"] == 4 * 64 // 8 and st["block_high_water"] == 3 * 2
    assert srv.cache["unit"][0]["pk"].dtype == torch.bfloat16
    assert f"block high-water 6/{st['num_blocks']}" in lines[-1] and "bfloat16" in lines[-2]
    assert len(done) == 3
    with pytest.raises(SystemExit):
        launch.parse_args(argv + ["--cache-dtype", "int8"])
    with pytest.raises(ValueError, match="block_size"):
        launch.serve(argv + ["--block-size", "24"], log_fn=lines.append)


def _check_serve_bench(tmp_path):
    """``benchmarks.run --serve --smoke --device cpu``: internvl2_2b at
    concurrency 2, dense and paged, the paged cell bitwise its dense
    twin's tokens and below its bytes, written into the output directory."""
    import json

    from repro_torch.benchmarks import run as bench

    assert bench.main(["--serve", "--smoke", "--device", "cpu",
                       "--out-dir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "serve.json").read_text())
    assert rec["device"] == "cpu" and rec["smoke"]
    dense, paged = rec["cells"]
    assert (dense["paged"], paged["paged"]) == (False, True)
    assert paged["bitexact_vs_dense"] and paged["arch"] == "internvl2_2b"
    assert paged["high_water_bytes"] <= paged["dense_equiv_bytes"]


# ---------------------------------------------------------------------------
# the tests: few items, each running a group of the checks above.
# pytest-xdist's load scheduler sizes its chunks by the count of pending
# items, and many short items here shift which worker gets the long JAX
# pipeline tests: the suite's wall time on 6 workers grew by half
# ---------------------------------------------------------------------------

def test_host_pieces_match_jax(tmp_path):
    """The allocator, the slot ops with pools, the codec's bits and cast for
    every layout, the paged cache tree and its bytes, the models with
    nothing to page, the launcher's flags and the serve bench."""
    _check_allocator()
    _check_slot_ops()
    for wire_dtype in ("float32", "bfloat16"):
        for k_ratio, block in ((0.0, 256), (0.05, 64), (0.3, 300), (0.01, 70000)):
            _check_activation_layout(k_ratio, block, wire_dtype)
    for arch, cache_dtype in (("llama3_8b", None), ("llama3_8b", "bfloat16"),
                              ("kimi_k2", None), ("internvl2_2b", "float32")):
        _check_cache_tree(arch, cache_dtype)
    _check_nothing_to_page()
    _check_launcher()
    _check_serve_bench(tmp_path)


def test_paged_attention_matches_jax():
    """The paged branch against JAX in fp32 and bf16, unassigned entries
    read as empty, and the bf16 codec's chain against the fp32 one."""
    for dtype in ("float32", "bfloat16"):
        _check_paged_attention(dtype)
    _check_unassigned_entries()
    _check_bf16_cache()


def test_paged_engine_matches_dense_and_jax(mesh2d):
    for arch in ("internvl2_2b", "llama3_8b"):
        _check_paged_engine(arch, mesh2d)
