"""Decoder-only LM assembly: a loop over stacked layer units, with decode
caches. Port of ``repro/models/lm.py``.

Layers are grouped into repeating *units* (``cfg.attn_pattern``); the
params of unit position j are stacked over the ``n_units`` repeats along a
new leading dim (``params["unit"][j]``), as in the JAX package, and the
forward loops over that dim where the JAX package scans. Layers left over
after the last full unit sit unstacked in ``params["rem"]``.

Only the ``"ssd"`` layer kind (Mamba-2) is ported; attention, RG-LRU and
the MLP/MoE layers raise ``NotImplementedError`` (ROADMAP item 8), and so
does the VLM prefix-embedding stub.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import tree_map

from . import layers as L
from . import ssd as S

Params = Any


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"layer kind {kind!r} is not ported to repro_torch yet (ROADMAP item 8)"
    )


# ---------------------------------------------------------------------------
# layer unit
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig, kind: str, device=None) -> Params:
    if kind != "ssd":  # mamba2 blocks have no separate MLP
        raise _not_ported(kind)
    return {"norm1": L.rmsnorm_init(cfg.d_model, torch.float32, device),
            "ssd": S.ssd_block_init(gen, cfg, device)}


def _layer_state_init(cfg: ModelConfig, kind: str, batch: int, max_seq: int, device=None):
    """Decode-time per-layer state."""
    if kind != "ssd":
        raise _not_ported(kind)
    return S.ssd_init_state(cfg, batch, device)


def _layer_apply(params: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 state=None, use_kernel: bool = False):
    if kind != "ssd":
        raise _not_ported(kind)
    h = L.rmsnorm(params["norm1"], x, cfg.norm_eps)
    out, new_state = S.ssd_block_apply(params["ssd"], cfg, h, state, use_kernel)
    return x + out, new_state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _unit_layout(cfg: ModelConfig):
    u = len(cfg.attn_pattern)
    n_units = cfg.n_layers // u
    rem = cfg.n_layers - n_units * u
    return u, n_units, rem


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def lm_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend stub is not ported (ROADMAP item 8)")
    u, n_units, rem = _unit_layout(cfg)
    params: dict = dict(L.embed_init(gen, cfg, device))
    # stacked unit params: for each position j in the unit, leaves stacked
    # over n_units along a new leading dim
    params["unit"] = [
        _stack([_layer_init(gen, cfg, cfg.attn_pattern[j], device) for _ in range(n_units)])
        for j in range(u)
    ]
    params["rem"] = [_layer_init(gen, cfg, cfg.attn_pattern[j], device) for j in range(rem)]
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, torch.float32, device)
    if not cfg.tie_embeddings:
        params.update(L.lm_head_init(gen, cfg, device))
    return params


def lm_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> Any:
    u, n_units, rem = _unit_layout(cfg)
    unit = [
        tree_map(lambda x: x.expand((n_units,) + x.shape).contiguous(),
                 _layer_state_init(cfg, cfg.attn_pattern[j], batch, max_seq, device))
        for j in range(u)
    ]
    remst = [_layer_state_init(cfg, cfg.attn_pattern[j], batch, max_seq, device)
             for j in range(rem)]
    return {"unit": unit, "rem": remst}


def lm_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,               # (B, S)
    cache: Optional[Any] = None,
    cache_pos=None,                     # decode write position: scalar or (B,)
    use_kernel: bool = False,
):
    """Returns ``(logits, new_cache_or_None)``.

    ``cache_pos`` is the JAX package's per-slot write position (scalar or
    ``(B,)``; rows with ``cache_pos[b] < 0`` are frozen and their outputs
    are discarded by the caller). Only attention layers read positions, and
    none is ported yet, so the SSD stack takes it and does not read it: a
    recurrent layer's frozen rows are restored by the serving engine
    (``serve.paged_cache.select_slots``). ``use_kernel`` selects the SSD
    chunk kernel path of ``models/ssd.py``.
    """
    del cache_pos
    x = L.embed_apply(params, cfg, tokens)
    u, n_units, rem = _unit_layout(cfg)

    states = [[] for _ in range(u)]     # states[j][i]: unit i, position j
    for i in range(n_units):
        for j in range(u):
            lp = tree_map(lambda a: a[i], params["unit"][j])
            st = None if cache is None else tree_map(lambda a: a[i], cache["unit"][j])
            x, ns = _layer_apply(lp, cfg, cfg.attn_pattern[j], x, st, use_kernel)
            states[j].append(ns)
    new_unit_cache = None
    if cache is not None:
        new_unit_cache = [_stack(s) for s in states] if n_units else []

    new_rem = []
    for j in range(rem):
        st = None if cache is None else cache["rem"][j]
        x, ns = _layer_apply(params["rem"][j], cfg, cfg.attn_pattern[j], x, st, use_kernel)
        new_rem.append(ns)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_cache = None if cache is None else {"unit": new_unit_cache, "rem": new_rem}
    if cfg.tie_embeddings:
        logits = x.float() @ params["embed"].t().float()
    else:
        logits = L.lm_head_apply(params, cfg, x)
    return logits, new_cache
