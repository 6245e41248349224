"""CUDA launch wrapper of the Mamba-2 SSD intra-chunk kernel.

Replaces the Pallas kernel ``repro/kernels/ssd_scan/ssd_scan.py::
_ssd_chunk_kernel``; the kernel itself is ``csrc/ssd_scan.cu`` (its notes
give the bound and the design). One call computes, for every (batch,
chunk, head), the intra-chunk output ``y`` and the chunk's state delta
``st`` stored ``(P, N)``, in one CUDA launch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

MAX_Q, MAX_P, MAX_N = 256, 64, 128
LAUNCHES = build.LaunchCounter()

_SIGNATURES = {
    "repro_ssd_chunk": (
        [ctypes.c_void_p] * 7
        + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def library() -> ctypes.CDLL:
    """The built kernel library (compiled by nvcc at first use)."""
    return build.load("ssd_scan", _SIGNATURES)


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"ssd_chunk: {name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: {name} is {t.dtype}, expected float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"ssd_chunk: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"ssd_chunk: {name} is not contiguous")


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor):
    """Launch the kernel on x (B,NC,Q,H,P), dt/da (B,NC,Q,H), b/c
    (B,NC,Q,G,N), all fp32 contiguous on one card. Returns ``(y, st)``:
    (B,NC,Q,H,P) and (B,NC,H,P,N) fp32."""
    if x.dim() != 5 or b.dim() != 5:
        raise ValueError("ssd_chunk: x and b must be 5-D (B,NC,Q,H,P) / (B,NC,Q,G,N)")
    bsz, nc, q, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    dev = x.device
    _check("x", x, (bsz, nc, q, h, p), dev)
    _check("dt", dt, (bsz, nc, q, h), dev)
    _check("da", da, (bsz, nc, q, h), dev)
    _check("b", b, (bsz, nc, q, g, n), dev)
    _check("c", c, (bsz, nc, q, g, n), dev)
    if not (1 <= q <= MAX_Q and 1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"ssd_chunk: (Q, P, N) = {(q, p, n)} outside "
                         f"[1, {MAX_Q}] x [1, {MAX_P}] x [1, {MAX_N}]")
    if g < 1 or h % g:
        raise ValueError(f"ssd_chunk: {h} heads do not split into {g} groups")
    y = torch.empty_like(x)
    st = torch.empty((bsz, nc, h, p, n), dtype=torch.float32, device=dev)
    if bsz * nc == 0:
        return y, st
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().repro_ssd_chunk(
            x.data_ptr(), dt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), st.data_ptr(), bsz * nc, q, h, p, g, n, stream,
        )
    build.check(rc, "ssd_chunk")
    LAUNCHES.count += 1
    return y, st
