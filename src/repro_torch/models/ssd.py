"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Port of ``repro/models/ssd.py``. Chunked "discrete dual" form: the
sequence is split into chunks of Q; within a chunk the output is a masked
(causal, decay-weighted) quadratic contraction; across chunks the SSM
state h in R^{H x P x N} is carried by a linear recurrence (a loop over
the S/Q chunks). Decode is the O(1) recurrent update.

Cast points are the JAX package's: the projections and the depthwise conv
in the compute dtype, the SSD in fp32, the gated RMSNorm in fp32, and the
cast back to the compute dtype before ``w_out``. ``use_kernel=True`` runs
the chunked form through ``repro_torch.kernels.ssd_scan.ops`` (the CUDA
kernel on the card); ``False`` runs this file's oracle ``ssd_chunked``.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops

from .layers import _dtype, _pdtype, init_normal


def ssd_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = cfg.d_model * s.expand
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads


def ssd_block_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Any:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, h = ssd_dims(cfg)
    n, g = s.d_state, s.n_groups
    sc = 1.0 / math.sqrt(d)
    pd = _pdtype(cfg)
    # fused input projection: [x (d_inner), z gate (d_inner), B (g*n), C (g*n), dt (h)]
    proj_out = 2 * d_inner + 2 * g * n + h
    a = torch.empty((h,), dtype=torch.float32, device=device).uniform_(1.0, 16.0, generator=gen)
    return {
        "w_in": init_normal(gen, (d, proj_out), sc, pd, device),
        "conv_w": init_normal(gen, (s.d_conv, d_inner + 2 * g * n), 0.5, pd, device),
        "a_log": torch.log(a),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_inner,), dtype=pd, device=device),
        "w_out": init_normal(gen, (d_inner, d), 1.0 / math.sqrt(d_inner), pd, device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum': L[..., i, j] = sum_{j < m <= i} a[..., m], with
    -inf above the diagonal. a: (..., Q) -> (..., Q, Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    causal = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(causal, diff, torch.full((), -math.inf, dtype=a.dtype, device=a.device))


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)   softplus'd step sizes
    a_log: torch.Tensor,  # (H,)
    b: torch.Tensor,      # (B, S, G, N)
    c: torch.Tensor,      # (B, S, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
):
    """Chunked SSD, the oracle. Returns (y: (B,S,H,P), h_final: (B,H,P,N))."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    rep = h // g
    f32 = torch.float32

    da = (-torch.exp(a_log))[None, None, :] * dt             # (B, S, H) log-decay
    xr = x.reshape(bsz, nc, chunk, h, p).to(f32)
    br = b.reshape(bsz, nc, chunk, g, n).to(f32)
    cr = c.reshape(bsz, nc, chunk, g, n).to(f32)
    dtr = dt.reshape(bsz, nc, chunk, h)
    dar = da.reshape(bsz, nc, chunk, h)

    # intra-chunk (diagonal) term
    lmat = torch.exp(_segsum(dar.permute(0, 1, 3, 2)))      # (B, nc, H, Q, Q)
    cb = torch.einsum("bzqgn,bzkgn->bzgqk", cr, br)          # (B, nc, G, Q, Q)
    cb = cb.repeat_interleave(rep, dim=2)                   # (B, nc, H, Q, Q)
    y_diag = torch.einsum("bzhij,bzjh,bzjhp->bzihp", cb * lmat, dtr, xr)

    # per-chunk final states (B expanded from groups to heads)
    cum = torch.cumsum(dar, dim=2)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)        # (B, nc, Q, H)
    brh = br.repeat_interleave(rep, dim=3)                  # (B, nc, Q, H, N)
    states = torch.einsum("bzqhn,bzqh,bzqhp->bzhpn", brh, decay_states * dtr, xr)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B, nc, H)
    hcur = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    hprevs = []
    for z in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, z, :, None, None] + states[:, z]
    hprevs = torch.stack(hprevs, dim=1)                     # (B, nc, H, P, N)

    # off-diagonal (state) contribution
    state_decay = torch.exp(cum)                            # (B, nc, Q, H)
    ch = cr.repeat_interleave(rep, dim=3)                   # (B, nc, Q, H, N)
    y_off = torch.einsum("bzqhn,bzhpn,bzqh->bzqhp", ch, hprevs, state_decay)
    return (y_diag + y_off).reshape(bsz, s, h, p), hcur


def ssd_step(
    x: torch.Tensor,      # (B, 1, H, P)
    dt: torch.Tensor,     # (B, 1, H)
    a_log: torch.Tensor,
    b: torch.Tensor,      # (B, 1, G, N)
    c: torch.Tensor,      # (B, 1, G, N)
    h0: torch.Tensor,     # (B, H, P, N)
):
    """O(1) recurrent decode step."""
    rep = x.shape[2] // b.shape[2]
    da = torch.exp((-torch.exp(a_log))[None, :] * dt[:, 0])      # (B, H)
    bh = b[:, 0].repeat_interleave(rep, dim=1)                  # (B, H, N)
    ch = c[:, 0].repeat_interleave(rep, dim=1)
    upd = torch.einsum("bhn,bh,bhp->bhpn", bh.float(), dt[:, 0], x[:, 0].float())
    hnew = h0 * da[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", ch.float(), hnew)
    return y[:, None], hnew


def ssd_block_apply(
    params: Any,
    cfg: ModelConfig,
    xin: torch.Tensor,              # (B, S, d)
    state: Optional[dict] = None,   # decode: {"h": (B,H,P,N), "conv": (B,K-1,C)}
    use_kernel: bool = False,
    tp=None,
):
    """The block; with ``tp`` (a ``dist.tensor_parallel.ModelAxis``) one
    rank's tensor-parallel form on its shards of ``param_specs``: ``w_in``
    and ``conv_w`` split by columns where the fused layout falls (not by
    heads), ``w_out`` by rows (by heads), the vectors whole. The rank
    gathers the projection and ``conv_w`` over the axis
    (``gather_for_local``: the backward is a reduce-scatter, which also
    adds the ranks' partial gradients of the shared B and C), convolves
    every channel, and runs the SSD and the gated RMSNorm on its own heads
    (H / t; its vectors' entries through ``local_slice``); the norm's
    variance sums the ranks' partials (``tp.total``). The output is this
    rank's partial of ``w_out``'s product (the caller sums it). The decode
    state is the rank's: ``h`` of its heads, ``conv`` whole, the same on
    every rank."""
    s = cfg.ssm
    dt_ = _dtype(cfg)
    bsz, seq, _ = xin.shape
    d_inner, h = ssd_dims(cfg)
    g, n, p = s.n_groups, s.d_state, s.head_dim
    a_log, dt_bias, d_skip, norm_scale = (params[k] for k in ("a_log", "dt_bias", "d_skip",
                                                              "norm_scale"))

    proj = xin.to(dt_) @ params["w_in"].to(dt_)
    if tp is not None:
        proj = tp.gather_for_local(proj, -1)
    x, z, bmat, cmat, dt_raw = torch.split(
        proj, [d_inner, d_inner, g * n, g * n, h], dim=-1)

    # causal depthwise conv over concat([x, B, C])
    conv_in = torch.cat([x, bmat, cmat], dim=-1)
    k = s.d_conv
    if state is None:
        cpad = F.pad(conv_in, (0, 0, k - 1, 0))
    else:
        cpad = torch.cat([state["conv"].to(conv_in.dtype), conv_in], dim=1)
    w = params["conv_w"].to(dt_)
    if tp is not None:
        w = tp.gather_for_local(w, -1)
    conv = sum(cpad[:, i : i + seq, :] * w[i][None, None, :] for i in range(k))
    conv = F.silu(conv)
    new_conv_state = cpad[:, -(k - 1):, :]
    x, bmat, cmat = torch.split(conv, [d_inner, g * n, g * n], dim=-1)
    if tp is not None:   # this rank's heads, and the groups they read
        h //= tp.size
        lo, per_group = tp.rank * h, h * tp.size // g
        g0, g1 = lo // per_group, -(-(lo + h) // per_group)
        x, z, dt_raw = (tp.own(v) for v in (x, z, dt_raw))
        bmat, cmat = bmat[..., g0 * n:g1 * n], cmat[..., g0 * n:g1 * n]
        a_log, dt_bias, d_skip, norm_scale = (tp.local_slice(v) for v in (
            a_log, dt_bias, d_skip, norm_scale))
        g = g1 - g0

    xh = x.reshape(bsz, seq, h, p)
    bh = bmat.reshape(bsz, seq, g, n)
    ch = cmat.reshape(bsz, seq, g, n)
    dt = F.softplus(dt_raw.float() + dt_bias)

    if state is not None and seq == 1:
        y, hfin = ssd_step(xh, dt, a_log, bh, ch, state["h"])
    else:
        h0 = None if state is None else state["h"]
        chunked = ssd_ops.ssd_chunked if use_kernel else ssd_chunked
        y, hfin = chunked(xh, dt, a_log, bh, ch, s.chunk_size, h0)

    y = y + d_skip[None, None, :, None] * xh.float()
    y = y.reshape(bsz, seq, h * p)
    # gated RMS norm (Mamba-2 uses normalization before out-proj), its
    # mean over the whole d_inner
    y32 = y * F.silu(z.float())
    if tp is None:
        var = y32.square().mean(dim=-1, keepdim=True)
    else:
        var = tp.total(y32.square().sum(dim=-1, keepdim=True)) / d_inner
    y32 = y32 * torch.rsqrt(var + 1e-6) * norm_scale.float()
    out = y32.to(dt_) @ params["w_out"].to(dt_)
    return out, {"h": hfin, "conv": new_conv_state}


def ssd_init_state(cfg: ModelConfig, batch: int, device=None, tp_size: int = 1) -> dict:
    """The decode state; ``tp_size`` > 1: one model-axis rank's (its heads
    of ``h``; ``conv`` whole)."""
    s = cfg.ssm
    d_inner, h = ssd_dims(cfg)
    return {
        "h": torch.zeros((batch, h // tp_size, s.head_dim, s.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, d_inner + 2 * s.n_groups * s.d_state),
                            dtype=_dtype(cfg), device=device),
    }
