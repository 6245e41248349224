"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of ``repro/models/rglru.py``. Recurrence (per channel):

    r_t = sigmoid(W_a x_t + b_a)                      (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                      (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)            (learned decay, c=8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill run ``rglru_scan``, the JAX package's
``lax.associative_scan`` recursion written out (the same pairings in the
same order, so the same roundings, and log-depth on the card); decode is
the one-step recurrence with a carried (B, W) state. The block is the
Griffin recurrent block: linear-in -> causal depthwise conv -> RG-LRU,
gated by a parallel GELU branch, linear-out. The gates run in fp32.

Everything is functional (no in-place writes into a result), so the block
runs under ``torch.func.vmap(grad(...))``.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import _dtype, _pdtype, init_normal

C_DECAY = 8.0


def rglru_block_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Any:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    conv = cfg.rglru.d_conv
    pdt = _pdtype(cfg)
    sc = 1.0 / math.sqrt(d)
    p = {
        "w_in": init_normal(gen, (d, w), sc, pdt, device),
        "w_gate": init_normal(gen, (d, w), sc, pdt, device),
        "conv_w": init_normal(gen, (conv, w), 1.0 / math.sqrt(conv), pdt, device),
        "wa": init_normal(gen, (w, w), 1.0 / math.sqrt(w), pdt, device),
        "wx": init_normal(gen, (w, w), 1.0 / math.sqrt(w), pdt, device),
    }
    # Lambda ~ U[0.7, 1.3] in fp32 whatever param_dtype is (a ~ U[0.9,
    # 0.999] at init, paper App. A)
    p["lam"] = torch.rand((w,), generator=gen, dtype=torch.float32, device=device) * 0.6 + 0.7
    p["w_out"] = init_normal(gen, (w, d), 1.0 / math.sqrt(w), pdt, device)
    return p


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """x: (B, S, W); w: (K, W). Returns ``(y, new_state)`` with causal
    padding; ``state`` (decode): (B, K-1, W) trailing inputs of the
    previous steps, kept in x's dtype."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    # depthwise conv as a sum of shifted scalings, in the JAX package's order
    s_out = x.shape[1]
    y = sum(xp[:, i:i + s_out, :] * w[i][None, None, :] for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):, :] if k > 1 else None
    return y, new_state


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Merge along dim 1: even[0], odd[0], even[1], ... (``even`` is as
    long as ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2)
    merged = pairs.reshape(pairs.shape[:1] + (2 * n,) + pairs.shape[3:])
    return merged if even.shape[1] == n else torch.cat([merged, even[:, n:]], dim=1)


def _combine(left: tuple, right: tuple) -> tuple:
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``jax.lax.associative_scan(_combine, (a, b), axis=1)``: combine
    adjacent pairs, scan the half-length sequence (the odd outputs), then
    combine each odd output with the next even input (the even outputs),
    and interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                               (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ev_a, ev_b = _combine((odd_a[:, :-1], odd_b[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ev_a, ev_b = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    ev_a, ev_b = torch.cat([a[:, :1], ev_a], dim=1), torch.cat([b[:, :1], ev_b], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over dim 1 (time), from ``h0`` (B, W) or
    zeros. a, b: (B, S, W)."""
    if h0 is not None:
        # fold the initial state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(b.dtype)[:, None], b[:, 1:]], dim=1)
    _, h = _associative_scan(a, b)
    return h


def rglru_block_apply(
    params: Any,
    cfg: ModelConfig,
    x: torch.Tensor,               # (B, S, d)
    state: Optional[dict] = None,  # decode: {"h": (B, W), "conv": (B, K-1, W)}
    tp=None,
):
    """The block; with ``tp`` (a ``dist.tensor_parallel.ModelAxis``) one
    rank's tensor-parallel form on its W / t channels: ``w_in``, ``w_gate``,
    ``conv_w`` and the gates' ``wa`` / ``wx`` split by output channel,
    ``w_out`` by rows. The conv and the scan work per channel and stay
    local; the gates' products take the whole conv output
    (``gather_for_local``, a reduce-scatter backward) and ``lam`` enters
    through ``local_slice``. The output is this rank's partial of
    ``w_out``'s product (the caller sums it); the decode state holds the
    rank's channels."""
    dt = _dtype(cfg)
    x = x.to(dt)
    gate = F.gelu(x @ params["w_gate"].to(dt), approximate="tanh")
    u = x @ params["w_in"].to(dt)
    u, conv_state = _causal_depthwise_conv(
        u, params["conv_w"].to(dt), None if state is None else state["conv"])

    u32 = u.float()
    uw = u32 if tp is None else tp.gather_for_local(u32, -1)
    r = torch.sigmoid(uw @ params["wa"].float())
    i = torch.sigmoid(uw @ params["wx"].float())
    # softplus as jax.nn.softplus computes it: logaddexp(lam, 0)
    lam = params["lam"] if tp is None else tp.local_slice(params["lam"])
    log_a = -C_DECAY * torch.logaddexp(lam, torch.zeros_like(lam))[None, None, :] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * (i * u32)

    if state is None or x.shape[1] > 1:
        h = rglru_scan(a, b, None if state is None else state["h"])
    else:
        h = (a[:, 0] * state["h"].float() + b[:, 0])[:, None, :]

    new_state = {"h": h[:, -1, :], "conv": conv_state}
    y = (h.to(dt) * gate) @ params["w_out"].to(dt)
    return y, new_state


def rglru_init_state(cfg: ModelConfig, batch: int, device=None, tp_size: int = 1) -> dict:
    """The decode state; ``tp_size`` > 1: one model-axis rank's share
    (its channels)."""
    w = (cfg.rglru.lru_width or cfg.d_model) // tp_size
    k = cfg.rglru.d_conv
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, k - 1, w), dtype=_dtype(cfg), device=device),
    }
