"""CUDA launch wrapper of the fused error-feedback + block top-k kernel.

Replaces the Pallas kernel ``repro/kernels/topk_ef/topk_ef.py::
_topk_ef_kernel``; the kernel itself is ``csrc/topk_ef.cu`` (its notes
give the bound and the design). Per row of a ``(rows, bc)`` view:
``g = lr*grad + err``, the kb largest ``|g|`` by masked argmax with the
lowest-index tie-break, ``new_err = where(taken, 0, g)``.

The kernel takes a GROUP of views in one launch: ``plan_segments`` (pure
Python, testable without a card) lays the views out as the segments of a
table (lanes per row, 16-byte path or not, work units, output offsets,
which launch), ``run_group`` checks the views, allocates one buffer per
output kind and launches once per table. ``topk_ef_cuda`` is the
one-view call of the same entry. ``block_topk.block_topk`` runs the
EF-free instance through ``run_group`` too.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from .. import build

MAX_BLOCK = 2048
MAX_SEGMENTS = 64               # segments per launch (the table's capacity)
VPL_CLASSES = (8, 16, 32, 64)   # values per lane of the kernel's instantiations
MAX_UNITS = 1 << 30             # work units per launch (int32 arithmetic in the kernel)
MAX_ROWS = MAX_UNITS              # rows per view: its units fit one launch
ALIGN = 4                       # output offsets in elements: 16 bytes
LAUNCHES = build.LaunchCounter()
SEGMENTS = build.LaunchCounter()   # segments covered by those launches

# csrc/topk_ef.cu's Segment (x, err, new_err, vals, idx, rows, unit0, bc,
# kb, lane_shift, vec, slots; 56 bytes) and Table (MAX_SEGMENTS segments,
# then nseg, units, lr, vpl; 3,600 bytes)
_SEGMENT = struct.Struct("<5QiihhBBBx")
_TABLE_TAIL = struct.Struct("<iifi")
TABLE_BYTES = MAX_SEGMENTS * _SEGMENT.size + _TABLE_TAIL.size

_SIGNATURES = {
    "repro_topk_ef_group": ([ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "repro_block_topk_group": ([ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "repro_topk_table_bytes": ([], ctypes.c_int),
    "repro_topk_max_segments": ([], ctypes.c_int),
}
_layout_checked = False


def library() -> ctypes.CDLL:
    """The built kernel library (compiled by nvcc at first use); raises if
    its table layout is not the one ``plan_segments`` packs."""
    global _layout_checked
    lib = build.load("topk_ef", _SIGNATURES)
    if not _layout_checked:
        got = (lib.repro_topk_table_bytes(), lib.repro_topk_max_segments())
        if got != (TABLE_BYTES, MAX_SEGMENTS):
            raise build.KernelBuildError(
                f"topk_ef: the library's table is {got} (bytes, segments), "
                f"the wrapper packs {(TABLE_BYTES, MAX_SEGMENTS)}")
        _layout_checked = True
    return lib


class Segment(NamedTuple):
    rows: int
    bc: int
    kb: int
    lanes: int      # lanes per row: 8, 16 or 32 (32 // lanes rows per warp)
    vec: bool       # 16-byte loads and stores
    slots: int      # values per lane: 1, 2, 4 or 8, or vpl above 8
    vpl: int        # the instantiation it runs in (values per lane, a class)
    units: int      # work units: ceil(rows / rows per warp)
    launch: int     # index into Plan.launches (-1: no rows, no launch)
    unit0: int      # first work unit within its launch
    err_off: int    # offset of its new_err in the group's buffer (elements)
    out_off: int    # offset of its vals / idx in the group's buffers (elements)


class Launch(NamedTuple):
    vpl: int
    segments: tuple   # indices into Plan.segments, at most MAX_SEGMENTS
    units: int


class Plan(NamedTuple):
    segments: tuple
    launches: tuple
    err_size: int     # elements of the new_err buffer
    out_size: int     # elements of the vals and idx buffers


def plan_segments(views, ptrs) -> Plan:
    """Lay out a group of ``(rows, bc, kb)`` views for the kernel.

    ``ptrs[i]`` holds view i's input addresses (x, and err for EF). A
    segment takes the 16-byte path when ``bc % 4 == 0`` and every input
    address is a multiple of 16; its new_err then is too, since each
    segment's offsets in the output buffers are rounded up to 16 bytes. A
    row takes the fewest lanes of 8 / 16 / 32 that cover it (4 columns a
    lane on the 16-byte path). Launches: one per values-per-lane class, in
    class order, each cut into tables of at most MAX_SEGMENTS segments and
    MAX_UNITS units; views with no rows take no launch. Plans are cached by
    their views and alignments (the training step asks for the same one
    every step).
    """
    aligned = tuple(all(a % 16 == 0 for a in addrs) for addrs in ptrs)
    return _plan(tuple(tuple(v) for v in views), aligned)


def _round_up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


@functools.lru_cache(maxsize=256)
def _plan(views: tuple, aligned: tuple) -> Plan:
    segs, err_off, out_off = [], 0, 0
    by_class: dict = {}
    for i, ((rows, bc, kb), ok) in enumerate(zip(views, aligned)):
        vec = bc % 4 == 0 and ok
        width = bc // 4 if vec else bc
        lanes = 8 if width <= 8 else 16 if width <= 16 else 32
        need = 4 * -(-bc // (4 * lanes)) if vec else -(-bc // lanes)
        vpl = next(c for c in VPL_CLASSES if need <= c)
        slots = vpl if vpl > 8 else next(n for n in (1, 2, 4, 8) if need <= n)
        units = -(-rows // (32 // lanes))
        err_off, out_off = _round_up(err_off), _round_up(out_off)
        segs.append([rows, bc, kb, lanes, vec, slots, vpl, units, -1, 0, err_off, out_off])
        err_off += rows * bc
        out_off += rows * kb
        if rows:
            by_class.setdefault(vpl, []).append(i)
    launches = []
    for vpl in sorted(by_class):
        members, units = [], 0
        for i in by_class[vpl]:
            n = segs[i][7]
            if members and (len(members) == MAX_SEGMENTS or units + n > MAX_UNITS):
                launches.append(Launch(vpl, tuple(members), units))
                members, units = [], 0
            segs[i][8], segs[i][9] = len(launches), units
            members.append(i)
            units += n
        launches.append(Launch(vpl, tuple(members), units))
    return Plan(tuple(Segment(*s) for s in segs), tuple(launches), _round_up(err_off),
                _round_up(out_off))


def pack_table(plan: Plan, launch: Launch, ptrs, outs, lr: float):
    """The kernel's table for one launch of ``plan``: the segments'
    input addresses from ``ptrs`` (as for ``plan_segments``), their
    outputs at their offsets from ``outs`` = (new_err, vals, idx) base
    addresses (new_err 0 without EF)."""
    table = ctypes.create_string_buffer(TABLE_BYTES)
    ne, v, ix = outs
    for slot, i in enumerate(launch.segments):
        s = plan.segments[i]
        p = ptrs[i]
        _SEGMENT.pack_into(
            table, slot * _SEGMENT.size, p[0], p[1] if len(p) > 1 else 0,
            ne + 4 * s.err_off if ne else 0, v + 4 * s.out_off, ix + 4 * s.out_off,
            s.rows, s.unit0, s.bc, s.kb, s.lanes.bit_length() - 1, int(s.vec), s.slots)
    _TABLE_TAIL.pack_into(table, MAX_SEGMENTS * _SEGMENT.size, len(launch.segments),
                          launch.units, float(lr), launch.vpl)
    return table


def check_rows(name: str, x: torch.Tensor, kb: int) -> None:
    """Validate a ``(..., bc)`` float32 CUDA operand for the row kernels:
    contiguous, so its rows are ``numel // bc`` rows of ``bc`` columns."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError(f"{name}: expected a (..., bc) view, got a scalar")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    bc = x.shape[-1]
    if not 1 <= bc <= MAX_BLOCK:
        raise ValueError(f"{name}: block width {bc} outside [1, {MAX_BLOCK}]")
    if not 1 <= kb <= bc:
        raise ValueError(f"{name}: kb={kb} outside [1, {bc}]")
    if x.numel() > MAX_ROWS * bc:
        raise ValueError(f"{name}: {x.numel() // bc} rows, the kernel takes at most {MAX_ROWS}")


def run_group(ef: bool, xs, errs, lr: float, kbs, launches, segments, name: str):
    """Check the views, plan them, allocate one buffer per output kind and
    launch the kernel once per table. A view is a contiguous ``(*lead,
    bc)`` fp32 CUDA tensor. Returns ``(new_errs, vals, idxs)``: lists of
    per-view ``(*lead, bc)`` / ``(*lead, kb)`` views of those buffers
    (``new_errs`` is None without EF). ``launches`` / ``segments`` are the
    counters to add to."""
    if len(xs) != len(kbs) or (ef and len(errs) != len(xs)):
        raise ValueError(f"{name}: {len(xs)} views, {len(kbs)} kb values"
                         + (f", {len(errs)} error views" if ef else ""))
    if not xs:
        return ([] if ef else None), [], []
    dev = xs[0].get_device()
    ptrs, views = [], []
    for i, x in enumerate(xs):
        operands = (x, errs[i]) if ef else (x,)
        for t in operands:
            check_rows(name, t, kbs[i])
            if t.get_device() != dev:
                raise ValueError(f"{name}: views on cuda:{dev} and {t.device}")
        if ef and errs[i].shape != x.shape:
            raise ValueError(f"{name}: grad and err differ in shape")
        ptrs.append(tuple(t.data_ptr() for t in operands))
        views.append((x.numel() // x.shape[-1], x.shape[-1], kbs[i]))
    plan = plan_segments(views, ptrs)
    device = xs[0].device
    new_err = torch.empty(plan.err_size, dtype=torch.float32, device=device) if ef else None
    vals = torch.empty(plan.out_size, dtype=torch.float32, device=device)
    idx = torch.empty(plan.out_size, dtype=torch.int32, device=device)
    if plan.launches:
        outs = (new_err.data_ptr() if ef else 0, vals.data_ptr(), idx.data_ptr())
        with torch.cuda.device(device):
            fn = getattr(library(), "repro_topk_ef_group" if ef else "repro_block_topk_group")
            stream = torch.cuda.current_stream().cuda_stream
            for launch in plan.launches:
                table = pack_table(plan, launch, ptrs, outs, lr)
                build.check(fn(ctypes.addressof(table), stream), name)
                launches.count += 1
                segments.count += len(launch.segments)
    new_errs, out_vals, out_idx = [] if ef else None, [], []
    for x, kb, s in zip(xs, kbs, plan.segments):
        if ef:
            new_errs.append(new_err.as_strided(x.shape, x.stride(), s.err_off))
        shape = x.shape[:-1] + (kb,)
        stride = tuple(st // s.bc * kb for st in x.stride()[:-1]) + (1,)
        out_vals.append(vals.as_strided(shape, stride, s.out_off))
        out_idx.append(idx.as_strided(shape, stride, s.out_off))
    return new_errs, out_vals, out_idx


def topk_ef_group(grads, errs, lr: float, kbs):
    """Fused EF + top-k over a group of ``(*lead, bc)`` fp32 CUDA views,
    each with its own kb, in one launch per table (``plan_segments``).
    Returns ``(new_errs, vals, idxs)``: lists of per-view ``(*lead, bc)``
    f32, ``(*lead, kb)`` f32 and ``(*lead, kb)`` int32 views."""
    return run_group(True, grads, errs, lr, kbs, LAUNCHES, SEGMENTS, "topk_ef")


def topk_ef_cuda(grad2d: torch.Tensor, err2d: torch.Tensor, lr: float, kb: int):
    """One view through the grouped entry. Returns ``(new_err, values,
    local_indices)``: ``(rows, bc)`` f32, ``(rows, kb)`` f32, ``(rows,
    kb)`` int32."""
    new_errs, vals, idxs = topk_ef_group([grad2d], [err2d], lr, [kb])
    return new_errs[0], vals[0], idxs[0]
