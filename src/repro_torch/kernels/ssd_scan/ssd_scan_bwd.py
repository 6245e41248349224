"""CUDA launch wrapper of the backward of the SSD intra-chunk kernel.

Replaces no Pallas kernel: the JAX package differentiates its jnp oracle
(``repro/models/ssd.py::ssd_chunked``) under ``jax.grad``. The kernel,
``csrc/ssd_scan_bwd.cu``, computes the function of ``ref.py::
ssd_chunk_bwd_ref``, the vector-Jacobian product of the forward kernel's
function, for every (batch, chunk, head) in one call: C Bᵀ per (batch *
chunk, group) into scratch, then one block per (batch * chunk, head) for
dx, ddt, dda and the head's dCB, then the sums over each group's heads in
head order, then db and dc per (batch * chunk, group). No atomics: repeat
launches are bitwise equal. fp32 on the CUDA cores (the kernel's notes
give its bound and what is left for later).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ssd_scan import MAX_N, MAX_P, MAX_Q, TILE

LAUNCHES = build.LaunchCounter()

_SIGNATURES = {
    "repro_ssd_chunk_bwd": (
        [ctypes.c_void_p] * 16
        + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def library() -> ctypes.CDLL:
    """The built kernel library (compiled by nvcc at first use)."""
    return build.load("ssd_scan_bwd", _SIGNATURES)


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"ssd_chunk_bwd: {name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"ssd_chunk_bwd: {name} is {t.dtype}, expected float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"ssd_chunk_bwd: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"ssd_chunk_bwd: {name} is not contiguous")


def ssd_chunk_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, gy: torch.Tensor, gst: torch.Tensor):
    """Launch the backward on the forward's inputs x (B,NC,Q,H,P), dt/da
    (B,NC,Q,H), b/c (B,NC,Q,G,N) and the cotangents gy (B,NC,Q,H,P), gst
    (B,NC,H,P,N), all fp32 contiguous on one card. Returns ``(dx, ddt,
    dda, db, dc)`` shaped as the inputs."""
    if x.dim() != 5 or b.dim() != 5:
        raise ValueError("ssd_chunk_bwd: x and b must be 5-D (B,NC,Q,H,P) / (B,NC,Q,G,N)")
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    dev = x.device
    for name, t, shape in (("x", x, (bsz, nc, q, h, p)), ("dt", dt, (bsz, nc, q, h)),
                           ("da", da, (bsz, nc, q, h)), ("b", b, (bsz, nc, q, g, n)),
                           ("c", c, (bsz, nc, q, g, n)), ("gy", gy, (bsz, nc, q, h, p)),
                           ("gst", gst, (bsz, nc, h, p, n))):
        _check(name, t, shape, dev)
    if not (1 <= q <= MAX_Q and 1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"ssd_chunk_bwd: (Q, P, N) = {(q, p, n)} outside "
                         f"[1, {MAX_Q}] x [1, {MAX_P}] x [1, {MAX_N}]")
    if g < 1 or h % g:
        raise ValueError(f"ssd_chunk_bwd: {h} heads do not split into {g} groups")
    dx, ddt, dda = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(da)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    bnc = bsz * nc
    if bnc == 0:
        return dx, ddt, dda, db, dc
    qp = -(-q // TILE) * TILE
    f32 = dict(dtype=torch.float32, device=dev)
    cb = torch.empty((bnc, g, qp, qp), **f32)      # scratch: C Bᵀ, then dCB's group sum
    dcb = torch.empty((bnc, h, qp, qp), **f32)     # scratch: each head's dCB
    dbs = torch.empty((bnc, h, qp, n), **f32)      # scratch: each head's state term of db
    dbsum = torch.empty((bnc, g, qp, n), **f32)    # scratch: its sum over the group's heads
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().repro_ssd_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
            gy.data_ptr(), gst.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dda.data_ptr(),
            db.data_ptr(), dc.data_ptr(), cb.data_ptr(), dcb.data_ptr(), dbs.data_ptr(),
            dbsum.data_ptr(), bnc, q, h, p, g, n, stream,
        )
    build.check(rc, "ssd_chunk_bwd")
    LAUNCHES.count += 1
    return dx, ddt, dda, db, dc
