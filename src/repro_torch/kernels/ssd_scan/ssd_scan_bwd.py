"""CUDA launch wrapper of the backward of the SSD intra-chunk kernel.

Replaces no Pallas kernel: the JAX package differentiates its jnp oracle
(``repro/models/ssd.py::ssd_chunked``) under ``jax.grad``. The kernel,
``csrc/ssd_scan_bwd.cu``, computes the function of ``ref.py::
ssd_chunk_bwd_ref``, the vector-Jacobian product of the forward kernel's
function, for every (batch, chunk, head) in one call of four launches:
prep (the state products per head slice, C Bᵀ per causal 64 x 64 tile
pair), walk (one block per (batch * chunk, group, head slice, column
tile): gWᵀ, W and dXⱼ over the causal row tiles, dCB summed over the
slice's heads in shared memory), reduce (the sums over the slices) and
group (dC, dB, and dda per head). Every product runs on the tensor cores
in 3xTF32 (the forward's split; one TF32 pass misses ``checks.
SSD_BWD_TOL``); the exponentials, the causal select and the sums stay in
fp32. No atomics: repeat launches are bitwise equal. ``head_slice`` picks
the heads per block so that the walk's grid gives every SM two blocks;
the kernel's notes give its bound and what is left for later.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .ssd_scan import MAX_N, MAX_P, MAX_Q, TILE

MAX_HEADS_PER_BLOCK = 8   # kMaxHeads in csrc/ssd_scan_bwd.cu
NQ = 32                   # kNq: columns n of a dC / dB block
THREADS = 256
LAUNCHES = build.LaunchCounter()

_SIGNATURES = {
    "repro_ssd_chunk_bwd": (
        [ctypes.c_void_p] * 18
        + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def library() -> ctypes.CDLL:
    """The built kernel library (compiled by nvcc at first use)."""
    return build.load("ssd_scan_bwd", _SIGNATURES)


def _tiles(q: int) -> int:
    return -(-q // TILE)


def _pairs(q: int) -> int:
    """Causal (row tile >= column tile) pairs of 64 x 64 tiles."""
    t = _tiles(q)
    return t * (t + 1) // 2


def _slices(h: int, g: int, hs: int) -> int:
    return -(-(h // g) // hs)


def blocks_per_launch(bnc: int, q: int, h: int, g: int, n: int, hs: int) -> dict:
    """Blocks of each of the call's four launches with ``hs`` heads per
    block: prep (a state block per (batch*chunk, group, head slice, column
    tile), then a C Bᵀ block per causal tile pair), walk (as prep's state
    blocks), reduce (a thread per float4 of dCB and per element of dB's
    state term) and group (a dC and a dB
    block per 64-row tile and 32 columns n, then a warp per (batch*chunk,
    head) for dda)."""
    walk = bnc * g * _slices(h, g, hs) * _tiles(q)
    return {"prep": walk + bnc * g * _pairs(q), "walk": walk,
            "reduce": -(-(bnc * g * (_pairs(q) * TILE * TILE // 4 + _tiles(q) * TILE * n))
                        // THREADS),
            "group": _tiles(q) * 2 * bnc * g * -(-n // NQ) + -(-(bnc * h) // 8)}


def head_slice(bnc: int, q: int, h: int, g: int, n: int, sms: int) -> int:
    """Heads per block by default: the most heads of a group, up to 8, with
    which the walk's grid still gives every one of ``sms`` SMs two blocks
    (one runs at a time), so that the short walks fill in behind the long
    ones; fewer heads per block write more partial sums of dCB and of dB's
    state term. At the training shape (B*NC = 8, Q = 256, H = 32, G = 1) on
    132 SMs: 3, 352 blocks."""
    for hs in range(min(MAX_HEADS_PER_BLOCK, h // g), 0, -1):
        if blocks_per_launch(bnc, q, h, g, n, hs)["walk"] >= 2 * sms:
            return hs
    return 1


def walk_work(bnc: int, q: int, h: int, g: int, hs: int) -> list:
    """``(column tile, batch*chunk, heads)`` of each block of the walk (and
    of prep's state role), in block order, decoded from the block index as
    the kernels decode it: the long walks (column tile 0) first."""
    nslices, hpg = _slices(h, g, hs), h // g
    units = bnc * g * nslices
    out = []
    for blk in range(units * _tiles(q)):
        jt, us = divmod(blk, units)
        ug, sl = divmod(us, nslices)
        bz, gg = divmod(ug, g)
        h0 = gg * hpg + sl * hs
        out.append((jt, bz, tuple(range(h0, h0 + min(hs, hpg - sl * hs)))))
    return out


def group_work(bnc: int, q: int, h: int, g: int, n: int) -> list:
    """The work of each block of the group launch, in block order, as the
    kernel decodes it: ``("dc" | "db", batch*chunk, group, row tile, first
    column n)`` (the longest sums first), then ``("dda", [(batch*chunk,
    head), ...])`` for the 8 warps of a block."""
    nt, nq = _tiles(q), -(-n // NQ)
    out = []
    for blk in range(nt * 2 * bnc * g * nq):
        rest, qi = divmod(blk, nq)
        rest, ug = divmod(rest, bnc * g)
        rank, role = divmod(rest, 2)
        t = rank if role else nt - 1 - rank
        out.append(("db" if role else "dc", ug // g, ug % g, t, qi * NQ))
    heads = [divmod(k, h) for k in range(bnc * h)]
    out += [("dda", heads[k:k + 8]) for k in range(0, bnc * h, 8)]
    return out


def scratch_shapes(bnc: int, q: int, h: int, g: int, n: int, hs: int) -> dict:
    """The call's scratch (fp32): C Bᵀ per causal tile pair, later dCB
    (``cbt``); dCB summed over each head slice (``dcbp``) and dB's state
    term summed over each slice (``dbsp``); r_j (``rs``); the row sums of S
    per column tile (``rowp``) and dcum's column part with R_j (``aux``);
    in the kernel's argument order."""
    qp, npairs, ns = _tiles(q) * TILE, _pairs(q), _slices(h, g, hs)
    return {"cbt": (bnc * g, npairs, TILE, TILE), "dcbp": (bnc * g * ns, npairs, TILE, TILE),
            "dbsp": (bnc * g * ns, qp, n), "rs": (bnc * h, qp),
            "rowp": (bnc * h, _tiles(q), qp), "aux": (bnc * h, 2, qp)}


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
                       c: torch.Tensor, gy: torch.Tensor, gst: torch.Tensor,
                       heads_per_block: int | None = None):
    """Launch the backward on the forward's inputs x (B,NC,Q,H,P), dt/da
    (B,NC,Q,H), b/c (B,NC,Q,G,N) and the cotangents gy (B,NC,Q,H,P), gst
    (B,NC,H,P,N), all fp32 contiguous on one card. Returns ``(dx, ddt,
    dda, db, dc)`` shaped as the inputs. ``heads_per_block`` (1 to
    ``min(8, H/G)``) is the checks' hook: it overrides ``head_slice`` so
    that they reach the slices the training path runs at small shapes; the
    result depends on it only through the order of the sums over heads."""
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
    top = min(MAX_HEADS_PER_BLOCK, h // g)
    if heads_per_block is not None and not 1 <= heads_per_block <= top:
        raise ValueError(f"ssd_chunk_bwd: {heads_per_block} heads per block outside "
                         f"[1, {top}]")
    dx, ddt, dda = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(da)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    bnc = bsz * nc
    if bnc == 0:
        return dx, ddt, dda, db, dc
    with torch.cuda.device(dev):
        hs = heads_per_block or head_slice(
            bnc, q, h, g, n, torch.cuda.get_device_properties(dev).multi_processor_count)
        scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
                   for shape in scratch_shapes(bnc, q, h, g, n, hs).values()]
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().repro_ssd_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
            gy.data_ptr(), gst.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dda.data_ptr(),
            db.data_ptr(), dc.data_ptr(), *(t.data_ptr() for t in scratch),
            bnc, q, h, p, g, n, hs, stream,
        )
    build.check(rc, "ssd_chunk_bwd")
    LAUNCHES.hit(x.shape)
    return dx, ddt, dda, db, dc
