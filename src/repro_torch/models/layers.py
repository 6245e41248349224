"""LM building blocks: RMSNorm, RoPE, GQA attention, the MLPs, token
embedding and the LM head.

Port of the corresponding parts of ``repro/models/layers.py``. Params are
nested dicts of tensors in the JAX package's shapes; every module is an
``(init, apply)`` pair of functions. Compute runs in ``cfg.compute_dtype``,
normalization statistics, softmax and the attention products in fp32,
with every cast where the JAX package has it. MoE comes with ROADMAP item
8b.

Attention is the JAX package's streaming softmax written in plain tensor
ops (running max / normalizer / accumulator over KV chunks; a Python loop
where the JAX package scans), so the decode path's ``_attend_masked`` is
one chunk of the same algebra (DESIGN.md §9). It uses no fused attention
operator.
"""
from __future__ import annotations

import math
from typing import Any, Optional

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


def attention_apply(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                   # (B, S, d)
    positions: torch.Tensor,           # (S,) or (B, S) absolute positions
    kind: str = "global",              # "global" | "swa" | "local"
    cache: Optional[dict] = None,      # dense decode cache: {"k", "v", "pos"}
    cross_kv: Optional[tuple] = None,
    causal: bool = True,
    kv_chunk: int = 1024,
    block_table: Optional[torch.Tensor] = None,
):
    """Attention with an optional dense decode cache (DESIGN.md §9):
    ``{"k","v"}`` (B, L, Hkv, Dh) + ``"pos"`` (B, L) absolute positions
    (-1 = empty). A prefill of at least L tokens keeps the last L; shorter
    chunks and decode ticks scatter each token at slot ``pos % L``.
    ``positions`` may be per-row (B, S); rows with negative positions are
    frozen slots: their cache writes are dropped and their outputs are
    finite garbage, discarded by the caller. The paged cache (ROADMAP item
    10) and cross-attention (item 8d) are not ported."""
    if block_table is not None or (cache is not None and "pk" in cache):
        raise NotImplementedError(
            "the paged KV cache is not ported to repro_torch yet (ROADMAP item 10)")
    if cross_kv is not None:
        raise NotImplementedError(
            "cross-attention (encoder-decoder) is not ported to repro_torch yet "
            "(ROADMAP item 8d)")
    b, s, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    x = x.to(dt)

    q = (x @ params["wq"].to(dt)).reshape(b, s, hq, dh)
    k = (x @ params["wk"].to(dt)).reshape(b, s, hkv, dh)
    v = (x @ params["wv"].to(dt)).reshape(b, s, hkv, dh)
    cos, sin = rope_angles(positions, dh if cfg.rope_style == "full" else dh // 2,
                           cfg.rope_theta)
    q = apply_rope(q, cos, sin, cfg.rope_style)
    k = apply_rope(k, cos, sin, cfg.rope_style)

    new_cache = None
    incremental = False
    if cache is not None:
        pos2d = (positions if positions.dim() == 2
                 else positions[None].expand(b, s)).to(torch.int32)
        cache_len = cache["k"].shape[1]
        if s > 1 and s >= cache_len:
            # prefill into a bounded cache: keep only the last cache_len
            # keys/values; attention below runs on the full sequence
            new_cache = {"k": k[:, s - cache_len:].to(cache["k"].dtype),
                         "v": v[:, s - cache_len:].to(cache["v"].dtype),
                         "pos": pos2d[:, s - cache_len:]}
        else:
            # incremental write (decode tick or chunked-prefill continuation)
            incremental = True
            new_cache = _write_dense(cache, k, v, pos2d)
            k, v = new_cache["k"], new_cache["v"]

    qg = _gqa_expand(q, hkv) * (1.0 / math.sqrt(dh))
    window = cfg.window if kind in ("swa", "local") else 0
    if incremental:
        out = _attend_masked(qg, k, v, pos2d, new_cache["pos"], window)
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
