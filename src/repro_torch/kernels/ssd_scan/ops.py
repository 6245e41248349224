"""Full chunked SSD through the intra-chunk kernel, signature-compatible
with the model's oracle (``repro_torch.models.ssd.ssd_chunked``). Port of
``repro/kernels/ssd_scan/ops.py``.

The chunk term is ``SsdChunk``, a ``torch.autograd.Function``: a CPU
tensor runs its plain version (``ref.py``) both ways, a CUDA tensor the
forward kernel (``ssd_scan.py``) and the backward kernel
(``ssd_scan_bwd.py``), which raise on anything they do not take. There is
no fallback from one to the other. Both Functions carry a ``vmap`` rule
that folds the mapped dim into the batch, so that ``torch.func.vmap`` over
the workers launches each kernel once. The inter-chunk recurrence (a loop
over the chunks) and the off-diagonal term stay in PyTorch, as they stay
in jnp in the JAX package, and autograd differentiates them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref
from .ssd_scan import ssd_chunk_cuda
from .ssd_scan_bwd import ssd_chunk_bwd_cuda


def _fold(info, in_dims, args):
    """The vmapped dim of each arg moved to the front (an unbatched arg
    expanded) and folded into the batch dim, contiguous; returns the folded
    args and the map size."""
    v = info.batch_size
    out = []
    for a, d in zip(args, in_dims):
        a = a.unsqueeze(0).expand(v, *a.shape) if d is None else a.movedim(d, 0)
        out.append(a.reshape(v * a.shape[1], *a.shape[2:]).contiguous())
    return out, v


def _unfold(outs, v):
    return tuple(o.reshape(v, o.shape[0] // v, *o.shape[1:]) for o in outs), (0,) * len(outs)


class SsdChunk(torch.autograd.Function):
    """``(y_diag, states)`` of one (B,NC,Q,H,P) call, by device, with the
    backward through ``SsdChunkBwd``."""

    @staticmethod
    def forward(x, dt, da, b, c):
        if x.device.type == "cpu":
            return ssd_chunk_ref(x, dt, da, b, c)
        return ssd_chunk_cuda(x, dt, da, b, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy, gst):
        return SsdChunkBwd.apply(*ctx.saved_tensors, gy, gst)

    @staticmethod
    def vmap(info, in_dims, *args):
        folded, v = _fold(info, in_dims, args)
        return _unfold(SsdChunk.apply(*folded), v)


class SsdChunkBwd(torch.autograd.Function):
    """``(dx, ddt, dda, db, dc)`` of ``SsdChunk``'s inputs from the
    cotangents of its outputs, by device. A Function of its own so that
    the backward launch, which runs at the level of ``torch.func.vmap``
    when the gradient is taken inside it, gets a ``vmap`` rule too. It has
    no backward of its own (no double backward through the chunk term)."""

    @staticmethod
    def forward(x, dt, da, b, c, gy, gst):
        gy, gst = gy.contiguous(), gst.contiguous()
        if x.device.type == "cpu":
            return ssd_chunk_bwd_ref(x, dt, da, b, c, gy, gst)
        return ssd_chunk_bwd_cuda(x, dt, da, b, c, gy, gst)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("ssd_chunk: no double backward through the SSD chunk term")

    @staticmethod
    def vmap(info, in_dims, *args):
        folded, v = _fold(info, in_dims, args)
        return _unfold(SsdChunkBwd.apply(*folded), v)


# (x, dt, da, b, c) -> (y_diag, states) of one (B,NC,Q,H,P) call
ssd_chunk = SsdChunk.apply


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
