"""Plain PyTorch version of the SSD chunk kernel's function.

The function of ``repro/kernels/ssd_scan/ssd_scan.py::_ssd_chunk_kernel``
for every (batch, chunk, head) of one call at once: the intra-chunk
(diagonal) output and each chunk's state delta. Heads read B/C group
``h // (H / G)``. CPU tensors of the port take this path, and the CUDA
kernel (``csrc/ssd_scan.cu``) is held to it on the card.
"""
from __future__ import annotations

import math

import torch


def _causal_exp(seg: torch.Tensor, q: int) -> torch.Tensor:
    """``L = exp(seg)`` on and below the diagonal, 0 above it."""
    causal = torch.ones((q, q), dtype=torch.bool, device=seg.device).tril()
    return torch.exp(torch.where(causal, seg, torch.full((), -math.inf, dtype=seg.dtype,
                                                          device=seg.device)))


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor):
    """x (B,NC,Q,H,P), dt/da (B,NC,Q,H), b/c (B,NC,Q,G,N), fp32 ->
    ``(y (B,NC,Q,H,P), st (B,NC,H,P,N))``."""
    q, h = x.shape[2], x.shape[3]
    rep = h // b.shape[3]
    cum = torch.cumsum(da, dim=2).transpose(2, 3)            # (B,NC,H,Q)
    seg = cum[..., :, None] - cum[..., None, :]              # (B,NC,H,Q,Q)
    # a select on the exponent, not a product with the mask: exp(seg) is
    # inf above the diagonal when cum falls steeply (and autograd through
    # a select after the exp would meet 0 * inf)
    lmat = _causal_exp(seg, q)
    cb = torch.einsum("bzign,bzjgn->bzgij", c, b).repeat_interleave(rep, dim=2)
    w = cb * lmat * dt.transpose(2, 3)[..., None, :]         # dt_j
    y = torch.einsum("bzhij,bzjhp->bzihp", w, x)
    decay = torch.exp(cum[..., -1:] - cum).transpose(2, 3) * dt   # (B,NC,Q,H)
    bh = b.repeat_interleave(rep, dim=3) * decay[..., None]       # (B,NC,Q,H,N)
    st = torch.einsum("bzjhn,bzjhp->bzhpn", bh, x)
    return y, st


def ssd_chunk_bwd_ref(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, gy: torch.Tensor, gst: torch.Tensor):
    """The vector-Jacobian product of ``ssd_chunk_ref``'s function, written
    out per (batch, chunk, head): given the cotangents gy (B,NC,Q,H,P) of y
    and gst (B,NC,H,P,N) of st, returns ``(dx, ddt, dda, db, dc)`` shaped as
    the inputs. With ``W_ij = (c_i.b_j) L_ij dt_j``, ``E_j = exp(cum_{Q-1}
    - cum_j)`` and ``decay_j = E_j dt_j``:

    - ``gW = gy x^T`` on the causal half;
    - ``dx = W^T gy + decay . (b gst^T)``;
    - ``dCB = gW . L . dt_j``, summed over the heads of a group;
      ``dc = dCB b`` and ``db = dCB^T c + decay . (x gst)``;
    - ``ddt_j = sum_i gW_ij CB_ij L_ij + E_j r_j``, ``r_j = x_j^T gst b_j``;
    - ``dcum_i = sum_j S_ij - sum_k S_ki`` with ``S = gW . W`` (off the
      diagonal, where the two terms cancel exactly); the state
      term adds ``R_j = decay_j r_j`` to ``dcum_{Q-1}`` and ``-R_j`` to
      ``dcum_j``;
    - ``dda`` is the reverse cumulative sum of ``dcum``.

    The CUDA backward (``csrc/ssd_scan_bwd.cu``) computes this function."""
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    rep = h // g
    cum = torch.cumsum(da, dim=2).transpose(2, 3)            # (B,NC,H,Q)
    seg = cum[..., :, None] - cum[..., None, :]              # (B,NC,H,Q,Q)
    lmat = _causal_exp(seg, q)
    cb = torch.einsum("bzign,bzjgn->bzgij", c, b).repeat_interleave(rep, dim=2)
    dtj = dt.transpose(2, 3)[..., None, :]                   # (B,NC,H,1,Q): dt_j
    gl = torch.einsum("bzihp,bzjhp->bzhij", gy, x) * lmat    # gW . L, causal
    w = cb * lmat * dtj
    # gW . W off the diagonal: S_ii enters dcum_i twice with opposite signs
    s = (gl * cb * dtj).tril(-1)
    e = torch.exp(cum[..., -1:] - cum).transpose(2, 3)       # (B,NC,Q,H)
    decay = e * dt
    bh = b.repeat_interleave(rep, dim=3)                     # (B,NC,Q,H,N)
    u = torch.einsum("bzjhn,bzhpn->bzjhp", bh, gst)          # gst b_j
    r = torch.einsum("bzjhp,bzjhp->bzjh", x, u)              # x_j^T gst b_j
    dx = torch.einsum("bzhij,bzihp->bzjhp", w, gy) + decay[..., None] * u
    ddt = (gl * cb).sum(dim=3).transpose(2, 3) + e * r
    rr = decay * r                                           # R_j
    dcum = s.sum(dim=4).transpose(2, 3) - s.sum(dim=3).transpose(2, 3) - rr
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + rr.sum(dim=2, keepdim=True)], dim=2)
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    dcb = (gl * dtj).reshape(bsz, nc, g, rep, q, q).sum(dim=3)       # (B,NC,G,Q,Q)
    dbs = (decay[..., None] * torch.einsum("bzjhp,bzhpn->bzjhn", x, gst))
    dbs = dbs.reshape(bsz, nc, q, g, rep, n).sum(dim=4)
    dc = torch.einsum("bzgij,bzjgn->bzign", dcb, b)
    db = torch.einsum("bzgij,bzign->bzjgn", dcb, c) + dbs
    return dx, ddt, dda, db, dc
