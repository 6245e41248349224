"""Plain PyTorch version of the SSD chunk kernel's function.

The function of ``repro/kernels/ssd_scan/ssd_scan.py::_ssd_chunk_kernel``
for every (batch, chunk, head) of one call at once: the intra-chunk
(diagonal) output and each chunk's state delta. Heads read B/C group
``h // (H / G)``. CPU tensors of the port take this path, and the CUDA
kernel (``csrc/ssd_scan.cu``) is held to it on the card.
"""
from __future__ import annotations

import torch


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor):
    """x (B,NC,Q,H,P), dt/da (B,NC,Q,H), b/c (B,NC,Q,G,N), fp32 ->
    ``(y (B,NC,Q,H,P), st (B,NC,H,P,N))``."""
    q, h = x.shape[2], x.shape[3]
    rep = h // b.shape[3]
    cum = torch.cumsum(da, dim=2).transpose(2, 3)            # (B,NC,H,Q)
    seg = cum[..., :, None] - cum[..., None, :]              # (B,NC,H,Q,Q)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # a select, not a product with the mask: exp(seg) is inf above the
    # diagonal when cum falls steeply
    lmat = torch.where(causal, torch.exp(seg), torch.zeros((), dtype=seg.dtype, device=x.device))
    cb = torch.einsum("bzign,bzjgn->bzgij", c, b).repeat_interleave(rep, dim=2)
    w = cb * lmat * dt.transpose(2, 3)[..., None, :]         # dt_j
    y = torch.einsum("bzhij,bzjhp->bzihp", w, x)
    decay = torch.exp(cum[..., -1:] - cum).transpose(2, 3) * dt   # (B,NC,Q,H)
    bh = b.repeat_interleave(rep, dim=3) * decay[..., None]       # (B,NC,Q,H,N)
    st = torch.einsum("bzjhn,bzjhp->bzhpn", bh, x)
    return y, st
