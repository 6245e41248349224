"""The grouped EF + top-k entry: its planner (pure Python, what the card's
launch is built from) and its plain path against the JAX package.

``plan_segments`` is checked on the shapes it serves: cnn_cifar's 37
leaves at 10 workers make ONE launch, 130 tiny views make three tables of
at most 64 segments, output offsets are 16-byte aligned and disjoint, and
the 16-byte path is taken only where bc % 4 == 0 and the inputs are
aligned. The grouped plain path (what a CPU tensor runs) is held bitwise
to the JAX package's ``blocked_topk_ef`` (its Pallas kernel in interpret
mode) view by view at lr = 1, and ``make_topk_ef``'s per_shard kernel impl
(one grouped call per encode) bitwise to its reference impl. Inputs come
from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_ef import ops as jax_ops
from repro_torch.core.compressors import CompressorConfig, make_topk_ef
from repro_torch.core.types import tree_leaves
from repro_torch.kernels import checks
from repro_torch.kernels.block_topk.block_topk import block_topk_group
from repro_torch.kernels.topk_ef import ops
from repro_torch.kernels.topk_ef import topk_ef as T


def _check_layout(plan, views):
    """Offsets 16-byte aligned, in order and disjoint; every view with rows
    in exactly one launch, at most MAX_SEGMENTS per launch, unit ranges
    contiguous within a launch."""
    err_end = out_end = 0
    for s, (rows, bc, kb) in zip(plan.segments, views):
        assert (s.rows, s.bc, s.kb) == (rows, bc, kb)
        assert s.err_off % 4 == 0 and s.out_off % 4 == 0
        assert s.err_off >= err_end and s.out_off >= out_end
        err_end, out_end = s.err_off + rows * bc, s.out_off + rows * kb
        assert s.units == -(-rows // (32 // s.lanes))
        assert (s.launch == -1) == (rows == 0)
    assert plan.err_size >= err_end and plan.out_size >= out_end
    seen = []
    for n, launch in enumerate(plan.launches):
        assert 1 <= len(launch.segments) <= T.MAX_SEGMENTS
        unit = 0
        for i in launch.segments:
            s = plan.segments[i]
            assert (s.launch, s.unit0, s.vpl) == (n, unit, launch.vpl)
            unit += s.units
        assert unit == launch.units <= T.MAX_UNITS
        seen += launch.segments
    assert sorted(seen) == [i for i, v in enumerate(views) if v[0]]


def test_plan_cnn_cifar_encode_is_one_launch():
    views = [(v.rows, v.bc, v.kb) for v in checks.leaf_views("cnn_cifar", 10)]
    ptrs = [(4096 * (i + 1), 4096 * (i + 100)) for i in range(len(views))]
    plan = T.plan_segments(views, ptrs)
    _check_layout(plan, views)
    assert len(views) == 37 and len(plan.launches) == 1
    assert plan.launches[0].vpl == 8 and len(plan.launches[0].segments) == 37
    for s in plan.segments:
        assert s.vec == (s.bc % 4 == 0)
        # bc = 10: two rows of 16 lanes per warp; bc = 64: 16 lanes of 4
        # columns; bc = 128 / 256: 32 lanes, 4 / 8 values each
        assert (s.lanes, s.slots) == {10: (16, 1), 64: (16, 4), 128: (32, 4),
                                      256: (32, 8)}[s.bc]
    assert sum(s.units for s in plan.segments) == 136_030


def test_plan_130_tiny_segments_take_three_launches():
    views = [(3, 10, 1)] * 130
    plan = T.plan_segments(views, [(16 * i,) for i in range(130)])
    _check_layout(plan, views)
    assert [len(l.segments) for l in plan.launches] == [64, 64, 2]


def test_plan_alignment_widths_and_empty_views():
    views = [(7, 64, 1), (7, 64, 1), (5, 10, 2), (0, 128, 1), (2, 257, 3), (3, 2048, 5),
             (4, 3, 1), (9, 20, 2)]
    ptrs = [(0, 64), (0, 68), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0), (0, 0)]
    plan = T.plan_segments(views, ptrs)
    _check_layout(plan, views)
    segs = plan.segments
    assert segs[0].vec and not segs[1].vec          # err 4 bytes off: scalar path
    assert (segs[1].lanes, segs[1].slots) == (32, 2)
    assert not segs[2].vec and segs[2].lanes == 16
    assert segs[3].launch == -1                     # no rows, no launch
    assert (segs[4].vec, segs[4].vpl, segs[4].slots) == (False, 16, 16)
    assert (segs[5].vec, segs[5].vpl) == (True, 64)
    assert (segs[6].lanes, segs[6].slots) == (8, 1)  # four rows per warp
    assert (segs[7].vec, segs[7].lanes, segs[7].slots) == (True, 8, 4)
    assert [l.vpl for l in plan.launches] == [8, 16, 64]


def _tree(kind, seed):
    """Worker-stacked blocked views (M = 3, a lead dim) at bc 10, 64, 128
    and 256, with their kb."""
    rng = np.random.default_rng(seed)
    shapes = [(3, 2, 5, 10), (3, 4, 64), (3, 2, 2, 128), (3, 3, 256)]
    kbs = [1, 1, 2, 3]
    out = []
    for shape in shapes:
        if kind == "normal":
            g = rng.normal(size=shape).astype(np.float32)
            e = (0.1 * rng.normal(size=shape)).astype(np.float32)
        elif kind == "tied":
            g = rng.integers(-2, 3, size=shape).astype(np.float32)
            e = rng.integers(-1, 2, size=shape).astype(np.float32)
        else:
            g = np.zeros(shape, np.float32)
            e = np.zeros(shape, np.float32)
        out.append((g, e))
    return out, kbs


@pytest.mark.parametrize("kind", ["normal", "tied", "zero"])
def test_grouped_plain_path_matches_jax_bitwise(kind):
    leaves, kbs = _tree(kind, {"normal": 0, "tied": 1, "zero": 2}[kind])
    got = ops.blocked_topk_ef_group([torch.from_numpy(g) for g, _ in leaves],
                                    [torch.from_numpy(e) for _, e in leaves], kbs)
    assert len(got) == len(leaves)
    for (g, e), kb, outs in zip(leaves, kbs, got):
        want = jax_ops.blocked_topk_ef(jnp.asarray(g), jnp.asarray(e), kb)
        for a, b in zip(outs, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.dtype == (torch.int32 if b.dtype == jnp.int32 else torch.float32)


def test_make_topk_ef_kernel_impl_equals_reference_bitwise():
    """per_shard, M = 3: the kernel impl (one grouped call per encode; its
    plain version on the CPU) and the unfused reference impl give the same
    payloads and residuals, bit for bit, on a mixed tree."""
    rng = np.random.default_rng(5)
    shapes = {"a/w": (3, 4, 3, 3, 16), "a/b": (3, 16), "b/w": (3, 40, 10), "c": (3, 300)}
    g = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    e = {k: torch.from_numpy((0.1 * rng.normal(size=s)).astype(np.float32))
         for k, s in shapes.items()}
    outs = {}
    for impl in ("kernel", "reference"):
        comp = make_topk_ef(CompressorConfig(k_ratio=0.05, block_size=64, topk_impl=impl))
        outs[impl] = comp.compress(e, g)
    (pk, ek), (pr, er) = outs["kernel"], outs["reference"]
    for a, b in zip(tree_leaves(ek), tree_leaves(er)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for k in shapes:
        assert pk[k].blocked_shape == pr[k].blocked_shape
        assert pk[k].orig_shape == pr[k].orig_shape
        assert torch.equal(pk[k].indices, pr[k].indices)
        assert torch.equal(pk[k].values.view(torch.int32), pr[k].values.view(torch.int32))


def test_grouped_entries_refuse_what_they_do_not_take():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):      # the wrappers never fall back
        T.topk_ef_group([x], [x], 1.0, [1])
    with pytest.raises(ValueError, match="CUDA"):
        block_topk_group([x], [1])
    with pytest.raises(ValueError):                    # a kb per view
        T.topk_ef_group([x, x], [x, x], 1.0, [1])
    with pytest.raises(ValueError):
        ops.blocked_topk_ef_group([x], [x, x], [1])
    assert ops.blocked_topk_ef_group([], [], []) == []
