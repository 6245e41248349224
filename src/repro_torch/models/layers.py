"""LM building blocks: RMSNorm, RoPE, GQA attention on a dense or paged KV
cache (and cross-attention on an encoder's K/V), the MLPs, the
GShard-style MoE, token embedding and the LM head.

Port of the corresponding parts of ``repro/models/layers.py``. Params are
nested dicts of tensors in the JAX package's shapes; every module is an
``(init, apply)`` pair of functions. Compute runs in ``cfg.compute_dtype``,
normalization statistics, softmax, the router and the attention products
in fp32, with every cast where the JAX package has it.

Attention is the JAX package's streaming softmax written in plain tensor
ops (running max / normalizer / accumulator over KV chunks; a Python loop
where the JAX package scans), so the decode path's ``_attend_masked`` is
one chunk of the same algebra (DESIGN.md §9). It uses no fused attention
operator.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import dtype_of

Params = Any
NEG_INF = -1e30


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


def init_normal(gen: torch.Generator, shape, scale: float, dtype, device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 from ``gen``, cast to ``dtype``
    (scaled in place: one fp32 buffer, not two, for a 128k-vocab table)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype_of(dtype), device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """cos/sin tables for ``dim`` rotary dims at integer positions (..., S)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv   # (..., S, dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, style: str) -> torch.Tensor:
    """x: (B, S, H, Dh). style: 'full' rotates all dims; 'half' (ChatGLM 2d
    RoPE) rotates only the first half of head dims and passes the rest.
    Rotate-half pairing (dims (i, i + rot/2)), as the JAX package. A bf16
    ``x`` times the fp32 tables gives fp32, in both packages."""
    dh = x.shape[-1]
    rot = dh if style == "full" else dh // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    c = cos[..., None, :]   # (..., S, 1, rot/2)
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, xp.to(out.dtype)], dim=-1) if rot < dh else out


# ---------------------------------------------------------------------------
# attention (GQA): chunk-streamed softmax
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = 1.0 / math.sqrt(d)
    pdt = _pdtype(cfg)
    return {
        "wq": init_normal(gen, (d, hq * dh), sc, pdt, device),
        "wk": init_normal(gen, (d, hkv * dh), sc, pdt, device),
        "wv": init_normal(gen, (d, hkv * dh), sc, pdt, device),
        "wo": init_normal(gen, (hq * dh, d), 1.0 / math.sqrt(hq * dh), pdt, device),
    }


def _gqa_expand(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B,S,Hq,Dh) -> (B,S,Hkv,G,Dh) grouping query heads onto kv heads."""
    b, s, hq, dh = q.shape
    return q.reshape(b, s, hkv, hq // hkv, dh)


def _chunked_softmax_attend(
    q: torch.Tensor,     # (B, Sq, Hkv, G, Dh) fp32-scaled
    k: torch.Tensor,     # (B, Skv, Hkv, Dh)
    v: torch.Tensor,     # (B, Skv, Hkv, Dh)
    q_offset,            # scalar (int or 0-d tensor): absolute position of q[0]
    causal: bool,
    window: int,         # 0 = unbounded
    kv_chunk: int,
) -> torch.Tensor:
    """Flash-semantics streaming attention over KV chunks: the JAX
    package's ``lax.scan`` body as a loop. Never materializes (Sq, Skv);
    peak extra memory is (B, H, Sq, kv_chunk)."""
    b, sq, hkv, g, dh = q.shape
    skv = k.shape[1]
    kv_chunk = min(kv_chunk, skv)
    n_chunks = -(-skv // kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kblk = k[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        vblk = v[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        kv_pos = ci * kv_chunk + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q, kblk.to(q.dtype))
        mask = kv_pos[None, :] < skv
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vblk.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4)   # (B, Sq, Hkv, G, Dh)


def _attend_masked(
    qg: torch.Tensor,      # (B, Sq, Hkv, G, Dh) scaled queries
    k: torch.Tensor,       # (B, Skv, Hkv, Dh)
    v: torch.Tensor,       # (B, Skv, Hkv, Dh)
    q_pos: torch.Tensor,   # (B, Sq) absolute query positions
    kv_pos: torch.Tensor,  # (B, Skv) absolute key positions, -1 = empty slot
    window: int,           # 0 = unbounded
) -> torch.Tensor:
    """Single-block flash-form attention with explicit position masks: the
    one-chunk specialization of ``_chunked_softmax_attend`` (the same
    m / l / acc algebra). Fully-masked rows (frozen slots, q_pos < 0) come
    out finite, never NaN."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    mask = (kv_pos[:, None, :] <= q_pos[:, :, None]) & (kv_pos[:, None, :] >= 0)
    if window:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4)   # (B, Sq, Hkv, G, Dh)


def _write_dense(cache: dict, k: torch.Tensor, v: torch.Tensor, pos2d: torch.Tensor) -> dict:
    """Scatter each token's K/V at slot ``pos % cache_len`` of its row, as
    new tensors. Rows with pos < 0 (frozen slots) keep what they had: the
    JAX package drops their writes at an out-of-range index, which torch
    refuses (a device-side assert on CUDA), so they write the old values
    back at slot 0. Within a row positions are all >= 0 (consecutive, so
    distinct slots) or all < 0 (every write the same old value)."""
    b, cache_len = cache["pos"].shape
    live = pos2d >= 0
    slot = torch.where(live, pos2d % cache_len, 0)
    bidx = torch.arange(b, device=pos2d.device)[:, None]
    keep = live[..., None, None]
    ck, cv, cp = cache["k"].clone(), cache["v"].clone(), cache["pos"].clone()
    ck[bidx, slot] = torch.where(keep, k.to(ck.dtype), cache["k"][bidx, slot])
    cv[bidx, slot] = torch.where(keep, v.to(cv.dtype), cache["v"][bidx, slot])
    cp[bidx, slot] = torch.where(live, pos2d, cache["pos"][bidx, slot])
    return {"k": ck, "v": cv, "pos": cp}


class PagedIndex(NamedTuple):
    """Where a tick's tokens go in the block pools and which table entries
    are assigned. The same for every paged layer of a forward, so
    ``lm_forward`` computes it once (``paged_index``)."""

    blk: torch.Tensor        # (B, S) block of each token; nb_pool = the scratch block
    off: torch.Tensor        # (B, S) offset of each token in its block
    idx: torch.Tensor        # (B, nb) the block table, -1 entries clamped to 0
    assigned: torch.Tensor   # (B, nb) table entry >= 0


def paged_index(block_table: torch.Tensor, pos2d: torch.Tensor, nb_pool: int,
                block_size: int) -> PagedIndex:
    """Token t of row b lives at block ``bt[b, t // block]``, offset ``t %
    block``. Writes of frozen rows (pos < 0) and writes through a -1 table
    entry go to block ``nb_pool``: one scratch block joined on for the
    scatter only (the JAX package drops them at that out-of-range id).
    Pool blocks are shared across rows, so writing an old value back at a
    clamped place, as the dense cache does, could meet a live row's write
    to it in the same ``index_put_``, whose result is undefined for
    duplicate indices. Live writes never collide: the allocator hands out
    distinct blocks and a row's positions are consecutive. No host sync and
    no branch on values."""
    nb_seq = block_table.shape[1]
    live = pos2d >= 0
    blk_idx = torch.where(live, pos2d // block_size, 0).clamp(0, nb_seq - 1).long()
    blk = torch.gather(block_table, 1, blk_idx)
    blk = torch.where(live & (blk >= 0), blk, nb_pool).long()
    off = torch.where(live, pos2d % block_size, 0).long()
    return PagedIndex(blk, off, block_table.clamp(min=0).long(), block_table >= 0)


def _write_paged(cache: dict, k: torch.Tensor, v: torch.Tensor, pos2d: torch.Tensor,
                 ix: PagedIndex) -> tuple:
    """Scatter each token's K/V/pos into the block pools at ``ix``, then
    gather each row's view back. Returns ``(new_cache, k, v, kv_pos)``, the
    views (B, nb * block, Hkv, Dh) and (B, nb * block). The gather reads a
    -1 table entry as zeros at position -1, the contract of the JAX
    package's ``jnp.take(mode="fill")`` (indexing would wrap -1 to the last
    block)."""
    nb_pool, bs_blk = cache["ppos"].shape
    b, nb_seq = ix.idx.shape

    def put(pool, val):
        ext = torch.cat([pool, pool.new_zeros((1,) + tuple(pool.shape[1:]))])
        ext.index_put_((ix.blk, ix.off), val.to(pool.dtype))
        return ext[:nb_pool]

    new = {"pk": put(cache["pk"], k), "pv": put(cache["pv"], v),
           "ppos": put(cache["ppos"], pos2d)}
    kv_shape = (b, nb_seq * bs_blk) + tuple(k.shape[2:])
    has = ix.assigned[..., None, None, None]
    kg = torch.where(has, new["pk"][ix.idx], 0).reshape(kv_shape)
    vg = torch.where(has, new["pv"][ix.idx], 0).reshape(kv_shape)
    pg = torch.where(ix.assigned[..., None], new["ppos"][ix.idx], -1).reshape(b, nb_seq * bs_blk)
    return new, kg, vg, pg


def positions_2d(positions: torch.Tensor, b: int) -> torch.Tensor:
    """(S,) or (B, S) positions as (B, S) int32."""
    pos = positions if positions.dim() == 2 else positions[None].expand(b, positions.shape[0])
    return pos.to(torch.int32)


def attention_apply(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                   # (B, S, d)
    positions: torch.Tensor,           # (S,) or (B, S) absolute positions
    kind: str = "global",              # "global" | "swa" | "local"
    cache: Optional[dict] = None,      # decode cache: dense or paged, see below
    cross_kv: Optional[tuple] = None,  # encdec cross-attention: precomputed (k, v)
    causal: bool = True,
    kv_chunk: int = 1024,
    block_table=None,                  # paged cache: (B, nb) block ids, or its PagedIndex
    tp=None,                           # tensor-parallel: a dist.tensor_parallel.ModelAxis
):
    """Attention with an optional decode cache (DESIGN.md §9):

    - dense: ``{"k","v"}`` (B, L, Hkv, Dh) + ``"pos"`` (B, L) absolute
      positions (-1 = empty). A prefill of at least L tokens keeps the last
      L; shorter chunks and decode ticks scatter each token at slot
      ``pos % L`` (the windowed kinds' caches are rings);
    - paged: ``{"pk","pv"}`` (NB, block, Hkv, Dh) + ``"ppos"`` (NB, block),
      written and read through ``block_table`` (B, nb; -1 = unassigned),
      always incrementally (``_write_paged``); ``lm_forward`` passes the
      table's ``PagedIndex``, computed once for all layers.

    K/V are stored at the cache's dtype (the codec's cast) and read back in
    fp32 by ``_attend_masked``, the dense path's order, so a paged cache at
    the compute dtype equals the dense one bitwise. ``positions`` may be
    per-row (B, S); rows with negative positions are frozen slots: their
    cache writes are dropped and their outputs are finite garbage,
    discarded by the caller.

    Cross-attention (``cross_kv``, the encoder's K/V (B, S_src, Hkv, Dh)):
    only q is projected, neither q nor k is rotated, no cache is read or
    written, and every query attends to every source position.

    Tensor-parallel (``tp``): ``cfg`` counts this rank's query heads and
    the params are its shards. Where the model axis divides the KV heads
    the rank's KV heads are its own and the form is the plain one. A
    single KV head (``wk`` / ``wv`` hold 1 / t of its dims) the rank
    gathers whole (``gather_for_local``: the ranks' query heads differ,
    so their cotangents are summed and each keeps its slice) and caches
    whole, as the JAX package's ``cache_specs`` keeps a head it cannot
    split."""
    if cross_kv is not None:
        cache = None
    paged = cache is not None and "pk" in cache
    if paged and block_table is None:
        raise ValueError("a paged KV cache needs its block table")
    b, s, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    x = x.to(dt)

    q = (x @ params["wq"].to(dt)).reshape(b, s, hq, dh)
    whole_kv = tp is not None and params["wk"].shape[-1] * tp.size == hkv * dh
    if cross_kv is None:
        k, v = x @ params["wk"].to(dt), x @ params["wv"].to(dt)
        if whole_kv:
            k, v = tp.gather_for_local(k, -1), tp.gather_for_local(v, -1)
        k, v = k.reshape(b, s, hkv, dh), v.reshape(b, s, hkv, dh)
        cos, sin = rope_angles(positions, dh if cfg.rope_style == "full" else dh // 2,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin, cfg.rope_style)
        k = apply_rope(k, cos, sin, cfg.rope_style)
    else:
        k, v = cross_kv

    new_cache = None
    incremental = False
    if cache is not None:
        pos2d = positions_2d(positions, b)
        if paged:
            incremental = True
            ix = block_table
            if not isinstance(ix, PagedIndex):
                ix = paged_index(block_table, pos2d, *cache["ppos"].shape)
            new_cache, k, v, kv_pos = _write_paged(cache, k, v, pos2d, ix)
        elif s > 1 and s >= cache["k"].shape[1]:
            # prefill into a bounded cache: keep only the last cache_len
            # keys/values; attention below runs on the full sequence
            cache_len = cache["k"].shape[1]
            new_cache = {"k": k[:, s - cache_len:].to(cache["k"].dtype),
                         "v": v[:, s - cache_len:].to(cache["v"].dtype),
                         "pos": pos2d[:, s - cache_len:]}
        else:
            # incremental write (decode tick or chunked-prefill continuation)
            incremental = True
            new_cache = _write_dense(cache, k, v, pos2d)
            k, v, kv_pos = new_cache["k"], new_cache["v"], new_cache["pos"]

    qg = _gqa_expand(q, hkv) * (1.0 / math.sqrt(dh))
    window = cfg.window if kind in ("swa", "local") else 0
    if incremental:
        out = _attend_masked(qg, k, v, pos2d, kv_pos, window)
    else:
        if cross_kv is not None:
            q_off, causal = 0, False
        else:
            q_off = positions[0] if positions.dim() == 1 else positions[0, 0]
        out = _chunked_softmax_attend(qg.float(), k, v, q_off, causal=causal,
                                      window=window, kv_chunk=kv_chunk)
    out = out.reshape(b, s, hq * dh).to(dt)
    return out @ params["wo"].to(dt), new_cache


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None,
             device=None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    pdt = _pdtype(cfg)
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {
            "w_gate": init_normal(gen, (d, ff), sc_in, pdt, device),
            "w_up": init_normal(gen, (d, ff), sc_in, pdt, device),
            "w_down": init_normal(gen, (ff, d), sc_out, pdt, device),
        }
    return {
        "w_up": init_normal(gen, (d, ff), sc_in, pdt, device),
        "w_down": init_normal(gen, (ff, d), sc_out, pdt, device),
    }


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_apply(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = _dtype(cfg)
    x = x.to(dt)
    if cfg.mlp_variant in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_variant == "swiglu" else _gelu_tanh
        h = act(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
    else:
        h = _gelu_tanh(x @ params["w_up"].to(dt))
    return h @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Mixture of Experts: GShard-style dense dispatch with per-group capacity
# ---------------------------------------------------------------------------

def moe_group_size(cfg: ModelConfig) -> int:
    # keep the dispatch one-hot ~ T_local * group * k * cf bounded
    return 256 if cfg.moe.top_k >= 4 else 1024


def moe_capacity(cfg: ModelConfig, tokens: int) -> tuple:
    """``(group, cap)`` of a call over ``tokens`` tokens: the tokens are
    routed in groups of ``group``, each expert taking at most ``cap`` of a
    group's choices."""
    m = cfg.moe
    group = min(moe_group_size(cfg), tokens)
    return group, max(1, int(math.ceil(group * m.top_k / m.num_experts * m.capacity_factor)))


def moe_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_expert
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    pdt = _pdtype(cfg)
    p = {
        "router": init_normal(gen, (d, e), sc_in, torch.float32, device),
        "experts_gate": init_normal(gen, (e, d, f), sc_in, pdt, device),
        "experts_up": init_normal(gen, (e, d, f), sc_in, pdt, device),
        "experts_down": init_normal(gen, (e, f, d), sc_out, pdt, device),
    }
    if m.num_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=m.d_expert * m.num_shared_experts, device=device)
    return p


def _top_k(x: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k`` over the last dim: the k largest in descending
    order, the lower index first among equal values. ``torch.topk`` does
    not keep that tie rule (on the CPU it returns ids 6, 5 of 8 equal
    probabilities); a stable descending sort does."""
    vals, idx = torch.sort(x, stable=True, dim=-1, descending=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(params: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x.float() @ params["router"].float(), dim=-1)


def moe_router_logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      tp=None) -> torch.Tensor:
    """The router's fp32 logits over all ``cfg.moe.num_experts`` experts.

    Tensor-parallel (``tp``), expert-parallel (the router holds this
    rank's E / t columns): the rank's logits gathered over the experts
    with ``gather_for_local``. Softmax couples every expert and each
    rank's combine reads only its own experts, so each rank's cotangent of
    the full logits is a partial; the gather's reduce-scatter backward
    adds the ranks' partials and keeps the rank's columns. A whole router
    (the experts split over ``d_expert``) enters through ``tp.copy_to``:
    each rank's cotangent comes from its slice of ``d_expert``, and the
    router's gradient is the sum over the ranks."""
    router = params["router"]
    if tp is None:
        return x.float() @ router.float()
    if router.shape[-1] < cfg.moe.num_experts:
        return tp.gather_for_local(x.float() @ router.float(), -1)
    return x.float() @ tp.copy_to(router).float()


def moe_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x: (B, S, d). Dense (GShard) dispatch: tokens grouped into blocks of
    ``group`` with a per-group expert capacity C = group * k / E * cf; a
    token's choice past its expert's capacity is dropped. The one-hots are
    comparisons against ``arange`` (vmap-safe), the dispatch and combine
    einsums the JAX package's.

    Tensor-parallel (``tp``, a ``dist.tensor_parallel.ModelAxis``): the
    params are this rank's shards (``dist.sharding.param_specs``), in one
    of two forms read off their shapes. Where the model axis divides E the
    rank holds E / t whole experts (expert-parallel); else it holds a
    slice of every expert's ``d_expert`` (``experts_gate`` / ``experts_up``
    column-parallel, ``experts_down`` row-parallel). Every rank routes
    every token from the full probabilities (``moe_router_logits``), so
    the top-k, the capacity slots and the one-hots are the same on every
    rank and E stays global; an expert-parallel rank keeps its experts'
    columns of the one-hots. A shared expert is column / row-parallel by
    its leaf names. The result is this rank's partial sum of the output,
    for the caller's ``tp.reduce``."""
    m = cfg.moe
    dt = _dtype(cfg)
    b, s, d = x.shape
    t = b * s
    group, cap = moe_capacity(cfg, t)
    if t % group:
        raise ValueError(f"tokens {t} not divisible by moe group {group}")
    g = t // group
    e, k = m.num_experts, m.top_k
    dev = x.device
    local_e = params["experts_gate"].shape[-3]
    if tp is not None and local_e == e and params["experts_gate"].shape[-1] == m.d_expert:
        raise ValueError(f"{cfg.name}: the experts are whole on a model-axis rank: neither "
                         f"{e} experts nor d_expert {m.d_expert} split over {tp.size} ranks")

    xt = x.reshape(g, group, d)
    probs = torch.softmax(moe_router_logits(params, cfg, xt, tp), dim=-1)
    topw, tope = _top_k(probs, k)                               # (g, t, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert's per-group queue,
    # ranked over the flattened (t, k) in priority order
    sel = (tope[..., None] == torch.arange(e, device=dev)).to(torch.int32)   # (g, t, k, e)
    flat_sel = sel.reshape(g, group * k, e)
    pos = torch.cumsum(flat_sel, dim=1) - flat_sel
    slot = torch.sum(pos * flat_sel, dim=-1).reshape(g, group, k)
    keep = slot < cap
    slot = torch.clamp(slot, max=cap - 1)

    # dispatch / combine one-hots (g, t, e, cap), collapsed over k
    slot_oh = (slot[..., None] == torch.arange(cap, device=dev)).to(dt)      # (g, t, k, cap)
    disp = torch.einsum("gtke,gtkc->gtec", sel.to(dt) * keep[..., None].to(dt), slot_oh)
    comb = torch.einsum("gtke,gtkc,gtk->gtec", sel.to(dt), slot_oh, (topw * keep).to(dt))
    if local_e < e:   # expert-parallel: this rank's experts
        disp, comb = tp.own(disp, 2), tp.own(comb, 2)

    buf = torch.einsum("gtd,gtec->gecd", xt.to(dt), disp)                   # (g, e, cap, d)
    h = torch.einsum("gecd,edf->gecf", buf, params["experts_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", buf, params["experts_up"].to(dt))
    h = F.silu(h) * u
    out_e = torch.einsum("gecf,efd->gecd", h, params["experts_down"].to(dt))
    y = torch.einsum("gecd,gtec->gtd", out_e, comb).reshape(b, s, d)
    if m.num_shared_experts:
        y = y + mlp_apply(params["shared"], cfg, x)
    return y


def moe_aux_loss(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss. The reference computes
    it but adds it to no loss; so does the port."""
    e = cfg.moe.num_experts
    probs = _router_probs(params, x.reshape(-1, x.shape[-1]))
    top1 = torch.argmax(probs, dim=-1)       # the first of equal maxima, as jnp.argmax
    frac = (top1[:, None] == torch.arange(e, device=x.device)).float().mean(0)
    return e * torch.sum(frac * probs.mean(0))


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    return {"embed": init_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0,
                                 _pdtype(cfg), device)}


def embed_apply(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast: the same values as the JAX package's cast-then-gather
    return params["embed"][tokens.long()].to(_dtype(cfg))


def lm_head_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    return {"lm_head": init_normal(gen, (cfg.d_model, cfg.vocab_size),
                                   1.0 / math.sqrt(cfg.d_model), _pdtype(cfg), device)}


def lm_head_apply(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = _dtype(cfg)
    return x.to(dt) @ params["lm_head"].to(dt)
