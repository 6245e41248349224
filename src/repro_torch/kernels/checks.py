"""Kernel-vs-plain checks on the card, shared by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.

Each check builds inputs on the card, runs the CUDA kernel and its plain
PyTorch version on the same tensors, and requires them to agree: the
top-k kernels bit for bit (values compared as int32 bit patterns, so
``-0.0 != 0.0``), one view at a time (``cases``) and as groups of views
in one launch (``group_cases``); the SSD chunk kernel within ``SSD_TOL``
(its sums run in another order), and its backward within ``SSD_BWD_TOL``
and bitwise equal to itself from one launch to the next.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig, leaf_geometry
from repro_torch.core.types import tree_flatten_with_paths
from repro_torch.models import build
from repro_torch.models.ssd import ssd_chunked as ssd_oracle

from .block_topk import block_topk as bt_mod
from .block_topk.block_topk import block_topk_cuda, block_topk_group
from .block_topk.ref import block_topk_ref
from .ssd_scan import ops as ssd_ops
from .ssd_scan.ref import ssd_chunk_bwd_ref, ssd_chunk_ref
from .ssd_scan.ssd_scan import ssd_chunk_cuda
from .ssd_scan.ssd_scan_bwd import ssd_chunk_bwd_cuda
from .topk_ef.ref import topk_ef_ref
from .topk_ef import topk_ef as ef_mod
from .topk_ef.topk_ef import plan_segments, topk_ef_cuda, topk_ef_group


class LeafView(NamedTuple):
    path: str
    rows: int     # worker dim and lead dims folded in
    bc: int
    kb: int


def leaf_views(arch: str, num_workers: int, cfg: CompressorConfig = CompressorConfig()):
    """The (rows, bc, kb) view of every leaf of ``arch`` that one per-shard
    encode hands the kernel, with the M workers folded into the rows: the
    segments of the encode's one grouped launch."""
    params = build(get_config(arch)).init(torch.Generator().manual_seed(0))
    paths, leaves, _ = tree_flatten_with_paths(params)
    out = []
    for path, x in zip(paths, leaves):
        blocked, kb = leaf_geometry(cfg, tuple(x.shape), path)
        out.append(LeafView(path, num_workers * x.numel() // blocked[-1], blocked[-1], kb))
    return out


def geometry_mix(views) -> dict:
    """{(bc, kb): rows} summed over leaves."""
    mix = Counter()
    for v in views:
        mix[(v.bc, v.kb)] += v.rows
    return dict(mix)


class Case(NamedTuple):
    name: str
    rows: int
    bc: int
    kb: int
    kind: str      # "normal" | "tied" | "signs" | "zero" | "nan"
    lr: float


def cases(num_workers: int = 10) -> list:
    """Main-path geometries of cnn_cifar and fc_mnist at M workers, and the
    edges: bc in {1, 10, 257, 2048}, kb = bc, ties of both signs, all-zero
    rows, lr != 1."""
    out = []
    for arch in ("cnn_cifar", "fc_mnist"):
        for (bc, kb), rows in sorted(geometry_mix(leaf_views(arch, num_workers)).items()):
            out.append(Case(f"{arch} ({bc},{kb})", rows, bc, kb, "normal", 1.0))
    for bc in (1, 10, 257, 2048):
        for kb in sorted({1, min(3, bc), bc}):
            out.append(Case(f"edge bc={bc} kb={kb}", 37, bc, kb, "normal", 1.0))
    for kind in ("tied", "signs", "zero"):
        for bc, kb in ((10, 1), (64, 1), (256, 3), (257, 4)):
            out.append(Case(f"{kind} bc={bc} kb={kb}", 129, bc, kb, kind, 1.0))
    for bc, kb in ((64, 1), (256, 3), (2048, 5)):
        out.append(Case(f"lr=0.05 bc={bc} kb={kb}", 211, bc, kb, "normal", 0.05))
    return out


def make_inputs(case: Case, device, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (case.rows, case.bc)
    if case.kind == "normal":
        g = torch.randn(shape, generator=gen, device=device)
        e = 0.1 * torch.randn(shape, generator=gen, device=device)
    elif case.kind == "tied":
        g = torch.randint(-2, 3, shape, generator=gen, device=device).float()
        e = torch.randint(-1, 2, shape, generator=gen, device=device).float()
    elif case.kind == "signs":  # every entry +-1.5: all magnitudes equal
        s = torch.randint(0, 2, shape, generator=gen, device=device).float() * 2 - 1
        g, e = 1.5 * s, torch.zeros(shape, device=device)
    elif case.kind == "nan":   # normal, with a NaN in every fifth row
        g = torch.randn(shape, generator=gen, device=device)
        e = 0.1 * torch.randn(shape, generator=gen, device=device)
        g[::5, case.bc // 2] = float("nan")
    else:
        g = torch.zeros(shape, device=device)
        e = torch.zeros(shape, device=device)
    return g.contiguous(), e.contiguous()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, counting a NaN in both at one position as equal."""
    if not a.numel():
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(d.masked_fill(a.isnan() & b.isnan(), 0.0).max())


def check_topk_ef(case: Case, device="cuda", seed: int = 0) -> float:
    """Kernel vs plain on one case; raises AssertionError unless bitwise
    equal. Returns the max abs difference of the values (0.0)."""
    g, e = make_inputs(case, device, seed)
    ne_k, v_k, i_k = topk_ef_cuda(g, e, case.lr, case.kb)
    ne_r, v_r, i_r = topk_ef_ref(g, e, case.lr, case.kb)
    torch.cuda.synchronize()
    for name, a, b in (("indices", i_k, i_r), ("values", v_k, v_r), ("new_err", ne_k, ne_r)):
        if not _bits_equal(a, b):
            raise AssertionError(
                f"topk_ef {case.name}: {name} differ from the plain version "
                f"(max abs {_max_abs(a, b):.3g})"
            )
    return max(_max_abs(v_k, v_r), _max_abs(ne_k, ne_r))


def check_block_topk(case: Case, device="cuda", seed: int = 0) -> float:
    x, _ = make_inputs(case, device, seed)
    v_k, i_k = block_topk_cuda(x, case.kb)
    v_r, i_r = block_topk_ref(x, case.kb)
    torch.cuda.synchronize()
    for name, a, b in (("indices", i_k, i_r), ("values", v_k, v_r)):
        if not _bits_equal(a, b):
            raise AssertionError(
                f"block_topk {case.name}: {name} differ from the plain version "
                f"(max abs {_max_abs(a, b):.3g})"
            )
    return _max_abs(v_k, v_r)


# ---------------------------------------------------------------------------
# groups of views in one launch
# ---------------------------------------------------------------------------

class GroupCase(NamedTuple):
    name: str
    views: tuple   # (rows, bc, kb, kind) per view
    lr: float
    offset: int    # 0: each view its own tensor; else every view sits this
                   # many floats into a larger buffer (misaligned: the
                   # kernel's one-column-per-lane path)


def group_cases(num_workers: int = 10) -> list:
    """cnn_cifar's and fc_mnist's whole encodes at M workers, and the
    edges: ties / signs / zeros over every block-width class, NaN rows
    beside clean rows in one warp (bc = 10 packs two rows per warp, bc <= 8
    four), row counts that are no multiple of the rows per warp, empty
    views, more than one table's worth of segments, views at an odd float
    offset, rows wider than 256 (more instantiations), lr != 1."""
    out = []
    for arch in ("cnn_cifar", "fc_mnist"):
        views = tuple((v.rows, v.bc, v.kb, "normal") for v in leaf_views(arch, num_workers))
        out.append(GroupCase(f"{arch} encode M={num_workers}", views, 1.0, 0))
    mix = ((129, 10, 1), (129, 64, 1), (37, 128, 2), (129, 256, 3), (33, 257, 4))
    for kind in ("tied", "signs", "zero"):
        out.append(GroupCase(f"{kind} mix", tuple(v + (kind,) for v in mix), 1.0, 0))
    out.append(GroupCase("nan rows", (
        (10, 10, 1, "nan"), (11, 10, 3, "nan"), (6, 4, 2, "nan"), (7, 64, 2, "nan"),
        (5, 256, 3, "nan"), (6, 300, 2, "nan")), 1.0, 0))
    out.append(GroupCase("ragged rows", (
        (7, 10, 1, "normal"), (5, 4, 2, "normal"), (0, 64, 1, "normal"), (3, 64, 1, "normal"),
        (1, 8, 8, "normal"), (13, 2, 1, "normal"), (9, 16, 3, "normal"),
        (0, 10, 1, "normal"), (3, 17, 17, "normal")), 1.0, 0))
    widths = (10, 64, 128, 256, 3, 32, 600)
    out.append(GroupCase("130 segments", tuple(
        (1 + i % 7, widths[i % len(widths)], 1 + i % 3, "normal") for i in range(130)),
        1.0, 0))
    out.append(GroupCase("odd offset", (
        (37, 64, 1, "normal"), (21, 128, 2, "normal"), (9, 256, 3, "normal"),
        (11, 10, 1, "normal"), (5, 2048, 3, "normal")), 1.0, 1))
    out.append(GroupCase("wide rows", (
        (37, 300, 4, "tied"), (37, 512, 3, "normal"), (19, 1000, 2, "normal"),
        (9, 2048, 7, "tied"), (13, 256, 3, "normal")), 1.0, 0))
    out.append(GroupCase("lr=0.05", (
        (211, 64, 1, "normal"), (211, 256, 3, "normal"), (50, 2048, 5, "normal"),
        (33, 10, 1, "normal")), 0.05, 0))
    return out


def group_inputs(case: GroupCase, device, seed: int = 0):
    """Per view ``(g, e)``, each ``(rows, bc)`` contiguous; with
    ``case.offset`` each sits that many floats into a buffer of its own."""
    out = []
    for i, (rows, bc, kb, kind) in enumerate(case.views):
        g, e = make_inputs(Case(case.name, rows, bc, kb, kind, case.lr), device, seed + i)
        if case.offset:
            n = rows * bc
            g = torch.cat([torch.zeros(case.offset, device=device), g.reshape(-1)])
            e = torch.cat([torch.zeros(case.offset, device=device), e.reshape(-1)])
            g, e = g[case.offset:].view(rows, bc), e[case.offset:].view(rows, bc)
            if n and g.data_ptr() % 16 == 0:
                raise AssertionError(f"{case.name}: view {i} is 16-byte aligned")
        out.append((g, e))
    return out


def _expected_launches(case: GroupCase, ins, ef: bool) -> int:
    ptrs = [(g.data_ptr(), e.data_ptr()) if ef else (g.data_ptr(),) for g, e in ins]
    return len(plan_segments([v[:3] for v in case.views], ptrs).launches)


def check_topk_ef_group(case: GroupCase, device="cuda", seed: int = 0) -> float:
    """The grouped EF entry vs the plain version view by view; raises
    AssertionError unless bitwise equal, or unless it launched once per
    table of the plan. Returns the max abs difference of the values (0.0)."""
    ins = group_inputs(case, device, seed)
    kbs = [v[2] for v in case.views]
    before = ef_mod.LAUNCHES.count
    ne_k, v_k, i_k = topk_ef_group([g for g, _ in ins], [e for _, e in ins], case.lr, kbs)
    launched = ef_mod.LAUNCHES.count - before
    if launched != _expected_launches(case, ins, True):
        raise AssertionError(f"topk_ef group {case.name}: {launched} launches, expected "
                             f"{_expected_launches(case, ins, True)}")
    err = 0.0
    for j, ((g, e), kb) in enumerate(zip(ins, kbs)):
        ne_r, v_r, i_r = topk_ef_ref(g, e, case.lr, kb)
        torch.cuda.synchronize()
        for name, a, b in (("indices", i_k[j], i_r), ("values", v_k[j], v_r),
                           ("new_err", ne_k[j], ne_r)):
            if not _bits_equal(a, b):
                raise AssertionError(
                    f"topk_ef group {case.name} view {j} {tuple(g.shape)}: {name} differ "
                    f"from the plain version (max abs {_max_abs(a, b):.3g})")
        err = max(err, _max_abs(v_k[j], v_r), _max_abs(ne_k[j], ne_r))
    return err


def check_block_topk_group(case: GroupCase, device="cuda", seed: int = 0) -> float:
    """The grouped EF-free entry vs the plain version, as above."""
    ins = group_inputs(case, device, seed)
    kbs = [v[2] for v in case.views]
    before = bt_mod.LAUNCHES.count
    v_k, i_k = block_topk_group([g for g, _ in ins], kbs)
    launched = bt_mod.LAUNCHES.count - before
    if launched != _expected_launches(case, ins, False):
        raise AssertionError(f"block_topk group {case.name}: {launched} launches, expected "
                             f"{_expected_launches(case, ins, False)}")
    err = 0.0
    for j, ((g, _), kb) in enumerate(zip(ins, kbs)):
        v_r, i_r = block_topk_ref(g, kb)
        torch.cuda.synchronize()
        for name, a, b in (("indices", i_k[j], i_r), ("values", v_k[j], v_r)):
            if not _bits_equal(a, b):
                raise AssertionError(
                    f"block_topk group {case.name} view {j} {tuple(g.shape)}: {name} differ "
                    f"from the plain version (max abs {_max_abs(a, b):.3g})")
        err = max(err, _max_abs(v_k[j], v_r))
    return err


# ---------------------------------------------------------------------------
# SSD chunk kernel
# ---------------------------------------------------------------------------

# |kernel - plain| <= SSD_TOL * max(1, max|plain|). Both are fp32 with sums
# in different orders (the kernel's cumsum is a lane-blocked warp scan, its
# dot products are tiled). The dominant error is that of cum: at full width
# da = -exp(a_log) softplus(.) with a_log up to log 16, so cum falls to
# ~-3e3 over a 256-step chunk, where the fp32 spacing is 2.4e-4, and
# exp(cum_i - cum_j) carries that absolute error in its exponent.
# tests/test_torch_ssd.py::test_plain_version_fp32_error_budget_at_full_width
# holds the fp32 plain version within SSD_TOL / 5 of a float64 evaluation
# at the slice's shape (Q=256, P=64, N=128), so two fp32 evaluations stay
# within SSD_TOL of each other. 2e-4 is the JAX package's kernel tolerance
# (tests/test_kernels.py); at the JAX test shapes max|y| is O(1), where
# this is the tests' atol.
SSD_TOL = 2e-4

# The backward kernel's five gradients against ``ssd_chunk_bwd_ref``, as
# SSD_TOL: |kernel - plain| <= SSD_BWD_TOL * max(1, max|plain|) per
# gradient. The fp32 plain backward's error against a float64 evaluation
# at full width (Q=256, P=64, N=128) is largest in dda where cum falls
# steepest ("extreme": ~30 a step): dda sums S_ij = gW_ij W_ij off the
# diagonal, whose L_ij = exp(cum_i - cum_j) carries the absolute error of
# cum (~5e-4 at |cum| ~ 7e3) in its exponent, up to 1.92e-4 of max|dda|
# over ssd_cases() (1.43e-4 at the test's shape; ~2.5e-5 with "model"
# inputs). tests/test_torch_ssd_train.py holds the plain backward within
# SSD_BWD_TOL / 5 of float64 there, so two fp32 evaluations in different
# sum orders (kernel and plain) stay within SSD_BWD_TOL of each other.
SSD_BWD_TOL = 1e-3


class SsdCase(NamedTuple):
    name: str
    b: int
    s: int        # sequence length, a multiple of chunk
    h: int
    p: int
    g: int
    n: int
    chunk: int
    kind: str     # "test" | "model" | "extreme"


def ssd_cases() -> list:
    """The JAX package's kernel test shapes (tests/test_kernels.py), the
    serving slice's shape (a width-512 tick over 4 slots of mamba2_370m),
    and the edges: G > 1, Q not a power of two, P and N at their limits,
    many heads per group (20, which head slices of 3 and 6 do not divide),
    Q, P and N just off the MMA tile (16 / 8 / 8) and just under their
    limits, decay steep enough that exp(cum_i - cum_j) overflows above the
    diagonal."""
    return [
        SsdCase("jax test (2,128,4,16,1,16,32)", 2, 128, 4, 16, 1, 16, 32, "test"),
        SsdCase("jax test (1,64,2,8,2,8,16)", 1, 64, 2, 8, 2, 8, 16, "test"),
        SsdCase("jax test (2,96,6,8,3,4,32)", 2, 96, 6, 8, 3, 4, 32, "test"),
        SsdCase("jax test h0 (1,64,2,8,1,8,16)", 1, 64, 2, 8, 1, 8, 16, "test"),
        SsdCase("slice (4,512,32,64,1,128,256)", 4, 512, 32, 64, 1, 128, 256, "model"),
        SsdCase("edge G=2 Q=96 (2,192,6,64,2,128,96)", 2, 192, 6, 64, 2, 128, 96, "model"),
        SsdCase("edge Q=200 P=5 N=3 (1,400,3,5,3,3,200)", 1, 400, 3, 5, 3, 3, 200, "model"),
        SsdCase("edge Q=1 (3,4,2,16,1,16,1)", 3, 4, 2, 16, 1, 16, 1, "model"),
        SsdCase("edge H=40 G=2 (1,128,40,16,2,32,64)", 1, 128, 40, 16, 2, 32, 64, "model"),
        SsdCase("edge Q=248 P=63 N=127 (1,496,2,63,1,127,248)", 1, 496, 2, 63, 1, 127, 248,
                "model"),
        SsdCase("edge overflow (2,512,4,64,1,128,256)", 2, 512, 4, 64, 1, 128, 256, "extreme"),
        SsdCase("edge overflow Q=32 (2,96,6,8,3,4,32)", 2, 96, 6, 8, 3, 4, 32, "extreme"),
    ]


def ssd_tp_cases() -> list:
    """The shapes the tensor-parallel SSD layer gives both kernels on one
    of 2 model-axis ranks of mamba2_370m (16 of its 32 heads): training's
    2 workers x 512 tokens folded into one launch, and serving's
    width-256 tick over 4 slots."""
    return [
        SsdCase("tp slice (2,512,16,64,1,128,256)", 2, 512, 16, 64, 1, 128, 256, "model"),
        SsdCase("tp tick (4,256,16,64,1,128,256)", 4, 256, 16, 64, 1, 128, 256, "model"),
    ]


def ssd_inputs(case: SsdCase, device, seed: int = 0):
    """``(x, dt, a_log, b, c, h0)`` at sequence level, fp32, made on the
    CPU from ``seed`` and moved to ``device``. "test": the distribution of
    the JAX tests; "model": that of mamba2_370m at full width (dt =
    softplus of a unit normal, a_log = log U(1, 16)); "extreme": every
    head at a_log = log 16 with dt ~ 2, so cum falls by ~30 per step."""
    gen = torch.Generator().manual_seed(seed)
    b, s, h, p, g, n = case.b, case.s, case.h, case.p, case.g, case.n

    def normal(*shape, mean=0.0):
        return torch.randn(shape, generator=gen) + mean

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    if case.kind == "test":
        x = normal(b, s, h, p)
        dt = uniform(0.05, 0.5, b, s, h)
        a_log = uniform(-1.0, 1.0, h)
        bm, cm = 0.3 * normal(b, s, g, n), 0.3 * normal(b, s, g, n)
        h0 = 0.1 * normal(b, h, p, n)
    else:
        x = normal(b, s, h, p)
        extreme = case.kind == "extreme"
        dt = torch.nn.functional.softplus(normal(b, s, h, mean=2.0 if extreme else 0.0))
        a_log = torch.full((h,), math.log(16.0)) if extreme else uniform(1.0, 16.0, h).log()
        bm, cm = normal(b, s, g, n), normal(b, s, g, n)
        h0 = normal(b, h, p, n)
    return tuple(t.to(device).contiguous() for t in (x, dt, a_log, bm, cm, h0))


def ssd_chunk_inputs(case: SsdCase, device, seed: int = 0):
    """The chunk kernel's operands ``(x, dt, da, b, c)`` for ``case``, as
    ``ops.ssd_chunked`` builds them."""
    x, dt, a_log, bm, cm, _ = ssd_inputs(case, device, seed)
    nc = case.s // case.chunk
    da = (-torch.exp(a_log))[None, None, :] * dt

    def chunks(t):
        return t.reshape((case.b, nc, case.chunk) + t.shape[2:]).contiguous()

    return tuple(chunks(t) for t in (x, dt, da, bm, cm))


def _within(name: str, got: torch.Tensor, want: torch.Tensor, rel: float = SSD_TOL) -> float:
    if not torch.isfinite(want).all():
        raise AssertionError(f"{name}: the plain version is not finite")
    err = _max_abs(got, want)
    tol = rel * max(1.0, float(want.abs().max()))
    if not err <= tol:  # NaN fails too
        raise AssertionError(f"{name}: max abs diff {err:.3g} > {tol:.3g}")
    return err


# head slices held besides the wrapper's own choice: the two the serving
# path runs (6 at width-512 ticks, 3 at width-256 ticks); 6 is the most a
# block takes, 3 gives each of a block's three warpgroups one head
SSD_HEAD_SLICES = (3, 6)


def check_ssd_chunk(case: SsdCase, device="cuda", seed: int = 0) -> float:
    """The chunk kernel vs its plain version (y and st) on one case, at the
    wrapper's head slice and at each of ``SSD_HEAD_SLICES`` that the case's
    heads per group allow; raises AssertionError beyond ``SSD_TOL``.
    Returns the max abs difference."""
    ins = ssd_chunk_inputs(case, device, seed)
    y_r, st_r = ssd_chunk_ref(*ins)
    err = 0.0
    for hs in (None,) + tuple(s for s in SSD_HEAD_SLICES if s <= case.h // case.g):
        y_k, st_k = ssd_chunk_cuda(*ins, heads_per_block=hs)
        torch.cuda.synchronize()
        where = f"ssd_chunk {case.name}" + (f" at {hs} heads per block" if hs else "")
        err = max(err, _within(f"{where}: y", y_k, y_r), _within(f"{where}: st", st_k, st_r))
    return err


def check_ssd_chunked(case: SsdCase, device="cuda", with_h0: bool = False,
                      seed: int = 0) -> float:
    """``ops.ssd_chunked`` (through the kernel on a CUDA tensor, the plain
    chunk term on a CPU one) vs the model's oracle
    ``models.ssd.ssd_chunked``, y and the final state."""
    x, dt, a_log, bm, cm, h0 = ssd_inputs(case, device, seed)
    h0 = h0 if with_h0 else None
    y_k, h_k = ssd_ops.ssd_chunked(x, dt, a_log, bm, cm, case.chunk, h0)
    y_r, h_r = ssd_oracle(x, dt, a_log, bm, cm, case.chunk, h0)
    if x.is_cuda:
        torch.cuda.synchronize()
    return max(_within(f"ssd_chunked {case.name}: y", y_k, y_r),
               _within(f"ssd_chunked {case.name}: h", h_k, h_r))


SSD_GRADS = ("dx", "ddt", "dda", "db", "dc")


def ssd_bwd_inputs(case: SsdCase, device, seed: int = 0):
    """The backward kernel's operands for ``case``: the chunk kernel's
    ``(x, dt, da, b, c)`` and unit-normal cotangents ``gy`` (B,NC,Q,H,P)
    and ``gst`` (B,NC,H,P,N), made on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed + 1)
    nc = case.s // case.chunk
    gy = torch.randn((case.b, nc, case.chunk, case.h, case.p), generator=gen)
    gst = torch.randn((case.b, nc, case.h, case.p, case.n), generator=gen)
    return ssd_chunk_inputs(case, device, seed) + (gy.to(device), gst.to(device))


# head slices of the backward held besides the wrapper's own choice: 3,
# the training shape's (32 heads a group: the last slice takes 2), and 8,
# the most a block takes; at H/G = 20 neither divides the group
SSD_BWD_HEAD_SLICES = (3, 8)


def ssd_bwd_head_slices(case: SsdCase) -> tuple:
    """The slices of ``SSD_BWD_HEAD_SLICES`` that ``case``'s heads per group
    allow."""
    return tuple(s for s in SSD_BWD_HEAD_SLICES if s <= case.h // case.g)


def check_ssd_chunk_bwd(case: SsdCase, device="cuda", seed: int = 0) -> float:
    """The backward kernel vs its plain version on one case, each of the
    five gradients within ``SSD_BWD_TOL``: at the wrapper's head slice,
    where a second launch on the same inputs must be bitwise equal to the
    first, and at each of ``ssd_bwd_head_slices(case)``; raises
    AssertionError otherwise. Returns the max abs difference."""
    ins = ssd_bwd_inputs(case, device, seed)
    want = ssd_chunk_bwd_ref(*ins)
    got = ssd_chunk_bwd_cuda(*ins)
    again = ssd_chunk_bwd_cuda(*ins)
    torch.cuda.synchronize()
    err = 0.0
    for name, k, k2, r in zip(SSD_GRADS, got, again, want):
        where = f"ssd_chunk_bwd {case.name}: {name}"
        if not _bits_equal(k, k2):
            raise AssertionError(f"{where}: two launches on the same inputs differ")
        err = max(err, _within(where, k, r, SSD_BWD_TOL))
    for hs in ssd_bwd_head_slices(case):
        got = ssd_chunk_bwd_cuda(*ins, heads_per_block=hs)
        torch.cuda.synchronize()
        for name, k, r in zip(SSD_GRADS, got, want):
            where = f"ssd_chunk_bwd {case.name} at {hs} heads per block: {name}"
            err = max(err, _within(where, k, r, SSD_BWD_TOL))
    return err
