"""Kernel-vs-plain checks on the card, shared by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.

Each check builds inputs on the card, runs the CUDA kernel and its plain
PyTorch version on the same tensors, and requires them to agree bit for
bit (values compared as int32 bit patterns, so ``-0.0 != 0.0``).
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig, leaf_geometry
from repro_torch.core.types import tree_flatten_with_paths
from repro_torch.models import build

from .block_topk.block_topk import block_topk_cuda
from .block_topk.ref import block_topk_ref
from .topk_ef.ref import topk_ef_ref
from .topk_ef.topk_ef import topk_ef_cuda


class LeafView(NamedTuple):
    path: str
    rows: int     # worker dim and lead dims folded in
    bc: int
    kb: int


def leaf_views(arch: str, num_workers: int, cfg: CompressorConfig = CompressorConfig()):
    """The (rows, bc, kb) view of every leaf of ``arch`` that one per-shard
    encode hands the kernel, with the M workers folded into the rows: one
    launch per leaf."""
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
    kind: str      # "normal" | "tied" | "signs" | "zero"
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
    else:
        g = torch.zeros(shape, device=device)
        e = torch.zeros(shape, device=device)
    return g.contiguous(), e.contiguous()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


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
