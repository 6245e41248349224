"""CUDA launch wrapper of the Mamba-2 SSD intra-chunk kernel.

Replaces the Pallas kernel ``repro/kernels/ssd_scan/ssd_scan.py::
_ssd_chunk_kernel``; the kernel itself is ``csrc/ssd_scan.cu``. One call
computes, for every (batch, chunk, head), the intra-chunk output ``y`` and
the chunk's state delta ``st`` stored ``(P, N)``, in one CUDA launch.

Design (the kernel's notes give the details): a block owns a 64-row tile
of y, or a 64-column half of the state, for one (batch, chunk, group) and
a slice of the group's heads. A y block computes ``C_i B_{0..i}^T`` once
for the slice, not once per head, then walks each head's causal column
tiles; every product runs on the tensor cores in 3xTF32 (each operand split
into a TF32 big part and its remainder, three TF32 products summed in
fp32), so the result keeps fp32-class accuracy (``checks.SSD_TOL``; one
TF32 pass misses it); the exponentials, the causal select and the dt
scaling stay in fp32. Tiles arrive through cp.async double buffers.
Bound: the products at the TF32 tensor-core rate, three passes each,
about level with the bytes at the HBM rate (``chip_smoke.py`` phase 7
prints it beside the fp32 CUDA-core bound).
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

MAX_Q, MAX_P, MAX_N = 256, 64, 128
MAX_HEADS_PER_BLOCK = 6   # kMaxHeads in csrc/ssd_scan.cu: HEAD_SLICES[0]
HEAD_SLICES = (6, 3, 2, 1)
TILE = 64                 # rows of a y tile, columns of a state block
LAUNCHES = build.LaunchCounter()

_SIGNATURES = {
    "repro_ssd_chunk": (
        [ctypes.c_void_p] * 7
        + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def library() -> ctypes.CDLL:
    """The built kernel library (compiled by nvcc at first use)."""
    return build.load("ssd_scan", _SIGNATURES)


def grid_blocks(bnc: int, q: int, h: int, g: int, n: int, hs: int) -> int:
    """Blocks of one launch with ``hs`` heads per block: per (batch*chunk,
    group, head slice) one block per 64-row tile of y and per 64-column
    half of the state."""
    slices = -(-(h // g) // hs)
    return bnc * g * slices * (-(-q // TILE) + -(-n // TILE))


def head_slice(bnc: int, q: int, h: int, g: int, n: int, sms: int) -> int:
    """Heads per block by default: the most heads of a group, of 6, 3, 2
    and 1 (a block's three warpgroups take a head each in turn), with which
    the grid still gives every one of ``sms`` SMs two blocks (one runs at a
    time), so that the short causal walks can fill in behind the long ones;
    fewer heads per block recompute C B^T more often. At the serving
    slice's shape on 132 SMs: 6 (PERF.md has the times of each)."""
    cands = [hs for hs in HEAD_SLICES if hs <= min(MAX_HEADS_PER_BLOCK, h // g)]
    for hs in cands:
        if grid_blocks(bnc, q, h, g, n, hs) >= 2 * sms:
            return hs
    return cands[-1]


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
                   b: torch.Tensor, c: torch.Tensor, heads_per_block: int | None = None):
    """Launch the kernel on x (B,NC,Q,H,P), dt/da (B,NC,Q,H), b/c
    (B,NC,Q,G,N), all fp32 contiguous on one card. Returns ``(y, st)``:
    (B,NC,Q,H,P) and (B,NC,H,P,N) fp32. ``heads_per_block`` (1 to
    ``min(6, H/G)``) is the checks' hook: it overrides ``head_slice`` so
    that they reach the slices the serving path runs at small shapes; the
    result does not depend on it."""
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
    if heads_per_block is not None and not 1 <= heads_per_block <= min(MAX_HEADS_PER_BLOCK,
                                                                       h // g):
        raise ValueError(f"ssd_chunk: {heads_per_block} heads per block outside "
                         f"[1, {min(MAX_HEADS_PER_BLOCK, h // g)}]")
    y = torch.empty_like(x)
    st = torch.empty((bsz, nc, h, p, n), dtype=torch.float32, device=dev)
    if bsz * nc == 0:
        return y, st
    with torch.cuda.device(dev):
        hs = heads_per_block or head_slice(
            bsz * nc, q, h, g, n, torch.cuda.get_device_properties(dev).multi_processor_count)
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().repro_ssd_chunk(
            x.data_ptr(), dt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), st.data_ptr(), bsz * nc, q, h, p, g, n, hs, stream,
        )
    build.check(rc, "ssd_chunk")
    LAUNCHES.hit(x.shape)
    return y, st
