"""Full chunked SSD through the intra-chunk kernel, signature-compatible
with the model's oracle (``repro_torch.models.ssd.ssd_chunked``). Port of
``repro/kernels/ssd_scan/ops.py``.

A CPU tensor runs the chunk term's plain version (``ref.py``); a CUDA
tensor launches the kernel (``ssd_scan.py``), which raises on anything it
does not take. There is no fallback from one to the other. The
inter-chunk recurrence (a loop over the chunks) and the off-diagonal term
stay in PyTorch, as they stay in jnp in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import ssd_chunk_ref
from .ssd_scan import ssd_chunk_cuda


def ssd_chunk(x, dt, da, b, c):
    """``(y_diag, states)`` of one (B,NC,Q,H,P) call, by device."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, da, b, c)
    return ssd_chunk_cuda(x, dt, da, b, c)


def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)   softplus'd
    a_log: torch.Tensor,  # (H,)
    b: torch.Tensor,      # (B, S, G, N)
    c: torch.Tensor,      # (B, S, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N)
):
    """Chunked SSD. Returns ``(y (B,S,H,P) fp32, h_final (B,H,P,N) fp32)``."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    rep = h // g

    da = (-torch.exp(a_log))[None, None, :] * dt
    f32 = torch.float32
    xr = x.reshape(bsz, nc, chunk, h, p).to(f32).contiguous()
    br = b.reshape(bsz, nc, chunk, g, n).to(f32).contiguous()
    cr = c.reshape(bsz, nc, chunk, g, n).to(f32).contiguous()
    dtr = dt.reshape(bsz, nc, chunk, h).to(f32).contiguous()
    dar = da.reshape(bsz, nc, chunk, h).to(f32).contiguous()

    # intra-chunk diagonal + per-chunk state deltas: the kernel
    y_diag, states = ssd_chunk(xr, dtr, dar, br, cr)

    # inter-chunk recurrence + off-diagonal term
    cum = torch.cumsum(dar, dim=2)
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B, nc, H)
    hcur = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    hprevs = []
    for z in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, z, :, None, None] + states[:, z]
    hprevs = torch.stack(hprevs, dim=1)                 # (B, nc, H, P, N)

    state_decay = torch.exp(cum)                        # (B, nc, Q, H)
    ch = cr.repeat_interleave(rep, dim=3)               # (B, nc, Q, H, N)
    y_off = torch.einsum("bzqhn,bzhpn,bzqh->bzqhp", ch, hprevs, state_decay)
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, hcur
