"""Encoder-decoder transformer (SeamlessM4T-v2 backbone).

Port of ``repro/models/encdec.py``. The encoder consumes precomputed frame
embeddings (the audio frontend is a stub: (B, S_src, d) frames). The
decoder is a causal transformer with cross-attention; decode mode carries
the self-attention KV caches (stacked over layers, with a scalar write
position) and reuses the cross-attention K/V computed once from the
encoder's output. The layer stacks are loops over a leading layer dim
where the JAX package scans (and vmaps, in ``cross_kv``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import tree_map

from . import layers as L
from . import remat as REMAT
from .lm import _positions, _stack, _stacked_init

Params = Any


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    return {
        "norm1": L.rmsnorm_init(cfg.d_model, torch.float32, device),
        "attn": L.attention_init(gen, cfg, device),
        "norm2": L.rmsnorm_init(cfg.d_model, torch.float32, device),
        "mlp": L.mlp_init(gen, cfg, device=device),
    }


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    return {
        "norm1": L.rmsnorm_init(cfg.d_model, torch.float32, device),
        "attn": L.attention_init(gen, cfg, device),
        "norm_x": L.rmsnorm_init(cfg.d_model, torch.float32, device),
        "xattn": L.attention_init(gen, cfg, device),
        "norm2": L.rmsnorm_init(cfg.d_model, torch.float32, device),
        "mlp": L.mlp_init(gen, cfg, device=device),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    params: dict = dict(L.embed_init(gen, cfg, device))
    params.update(L.lm_head_init(gen, cfg, device))
    params["enc_stack"] = _stacked_init(lambda: _enc_layer_init(gen, cfg, device),
                                        cfg.encoder_layers)
    params["dec_stack"] = _stacked_init(lambda: _dec_layer_init(gen, cfg, device),
                                        cfg.n_layers)
    params["enc_norm"] = L.rmsnorm_init(cfg.d_model, torch.float32, device)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, torch.float32, device)
    return params


def _layer(stack: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], stack)


def _remat(remat: str) -> str:
    """The JAX package checkpoints the whole layer body for any ``remat``
    other than ``"none"`` (no dots policy here): ``"full"``."""
    return "none" if remat == "none" else "full"


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           remat: str = "none") -> torch.Tensor:
    """frames: (B, S_src, d) precomputed frontend embeddings. Non-causal
    self-attention with RoPE at positions 0..S_src-1, then ``enc_norm``.
    ``remat`` other than ``"none"`` recomputes each layer in the backward
    (``models/remat.py``)."""
    def body(x, lp):
        # made inside the body: a recompute reads no captured tensor
        positions = torch.arange(x.shape[1], device=x.device)
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        out, _ = L.attention_apply(lp["attn"], cfg, h, positions, kind="global", causal=False)
        x = x + out
        h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        return x + L.mlp_apply(lp["mlp"], cfg, h)

    body = REMAT.checkpoint(body, _remat(remat))
    x = frames.to(L._dtype(cfg))
    for i in range(cfg.encoder_layers):
        x = body(x, _layer(params["enc_stack"], i))
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def cross_kv(params: Params, cfg: ModelConfig, enc_out: torch.Tensor) -> dict:
    """Each decoder layer's cross-attention K/V from the encoder's output,
    stacked: ``{"k", "v"}`` (L, B, S_src, Hkv, Dh)."""
    dt = L._dtype(cfg)
    b, s, _ = enc_out.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    xattn = params["dec_stack"]["xattn"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        ks.append((enc_out @ xattn["wk"][i].to(dt)).reshape(b, s, hkv, dh))
        vs.append((enc_out @ xattn["wv"][i].to(dt)).reshape(b, s, hkv, dh))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,              # (B, S_tgt)
    xkv: dict,                         # stacked {"k", "v"} (L, B, S_src, Hkv, Dh)
    cache: Optional[dict] = None,      # self-attention caches, stacked over layers
    cache_pos=None,                    # scalar write position (None = 0)
    remat: str = "none",
):
    """Returns ``(logits, new_cache_or_None)``. The self-attention cache
    (``encdec_init_cache``) is written at ``cache_pos + arange(S_tgt)``, a
    scalar position shared by every row. ``remat`` recomputes each layer
    in the backward, as in ``encode``; a forward with a cache takes no
    gradient and ignores it."""
    x = L.embed_apply(params, cfg, tokens)
    if _positions(x.shape[1], cache_pos, x.device).dim() != 1:
        raise ValueError("encoder-decoder decode takes a scalar position")

    def body(x, lp, lxkv, lcache):
        # made inside the body: a recompute reads no captured tensor
        positions = _positions(x.shape[1], cache_pos, x.device)
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        out, ns = L.attention_apply(lp["attn"], cfg, h, positions, kind="global", cache=lcache)
        x = x + out
        h = L.rmsnorm(lp["norm_x"], x, cfg.norm_eps)
        # cross-attention: q only; K/V precomputed from the encoder
        out, _ = L.attention_apply(lp["xattn"], cfg, h, positions, kind="global",
                                   cross_kv=(lxkv["k"], lxkv["v"]), causal=False)
        x = x + out
        h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        return x + L.mlp_apply(lp["mlp"], cfg, h), ns

    if cache is None and remat != "none":
        rbody = REMAT.checkpoint(lambda x, lp, lxkv: body(x, lp, lxkv, None)[0],
                                 _remat(remat))
        for i in range(cfg.n_layers):
            x = rbody(x, _layer(params["dec_stack"], i), _layer(xkv, i))
        states = None
    else:
        states = []
        for i in range(cfg.n_layers):
            lcache = None if cache is None else _layer(cache, i)
            x, ns = body(x, _layer(params["dec_stack"], i), _layer(xkv, i), lcache)
            states.append(ns)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_head_apply(params, cfg, x), None if cache is None else _stack(states)


def encdec_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> dict:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = L._dtype(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((cfg.n_layers, batch, max_seq), -1, dtype=torch.int32,
                          device=device),
    }
