"""The plain versions of the port's kernels (what a CPU tensor runs, and
what the CUDA kernel is held to on the card) against the JAX package's
Pallas kernels in interpret mode, as tests/test_kernels.py runs them.

Tolerances: bitwise at lr=1 (``1*grad + err`` is exact, and the selection
is the same masked argmax in both). At lr=0.05 ``lr*grad + err`` rounds
twice in the port (as the Pallas source is written), while XLA's CPU
backend contracts it into one FMA; the two differ by the rounding of the
product the FMA skips, so values and residuals are held to 1 ulp of
``lr*grad`` plus 1 ulp of the result (indices still equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_topk import ops as jax_bt_ops
from repro.kernels.block_topk.block_topk import block_topk_pallas
from repro.kernels.topk_ef import ops as jax_ops
from repro.kernels.topk_ef.topk_ef import topk_ef_pallas
from repro_torch.kernels.block_topk import ops as bt_ops
from repro_torch.kernels.block_topk.block_topk import block_topk_cuda
from repro_torch.kernels.block_topk.ref import block_topk_ref
from repro_torch.kernels.topk_ef import ops
from repro_torch.kernels.topk_ef.ref import topk_ef_ref
from repro_torch.kernels.topk_ef.topk_ef import topk_ef_cuda

# (rows, bc, kb): the main path's block geometries at small row counts,
# plus the edges (bc = 1, bc > 256, kb = bc)
GEOMS = [(12, 64, 1), (9, 10, 1), (8, 128, 2), (5, 128, 1), (7, 256, 3),
         (4, 1, 1), (3, 257, 4), (3, 16, 16)]


def _assert_product_ulp(got, want, lr, grad):
    """|got - want| <= ulp(fl(lr*grad)) + ulp(want), elementwise."""
    prod = np.abs(np.float32(lr) * grad.astype(np.float32))
    tol = np.spacing(prod) + np.spacing(np.abs(want))
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)


def _inputs(rows, bc, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        g = rng.normal(size=(rows, bc)).astype(np.float32)
        e = (0.1 * rng.normal(size=(rows, bc))).astype(np.float32)
    elif kind == "tied":  # equal magnitudes of both signs
        g = rng.integers(-2, 3, size=(rows, bc)).astype(np.float32)
        e = rng.integers(-1, 2, size=(rows, bc)).astype(np.float32)
    else:  # all zero
        g = np.zeros((rows, bc), np.float32)
        e = np.zeros((rows, bc), np.float32)
    return g, e


@pytest.mark.parametrize("rows,bc,kb", GEOMS)
@pytest.mark.parametrize("kind", ["normal", "tied", "zero"])
def test_topk_ef_ref_vs_pallas_lr1_bitwise(rows, bc, kb, kind):
    g, e = _inputs(rows, bc, kind, rows * bc + kb)
    ne_j, v_j, i_j = topk_ef_pallas(jnp.asarray(g), jnp.asarray(e), jnp.float32(1.0),
                                    kb, tile_blocks=rows, interpret=True)
    ne_t, v_t, i_t = topk_ef_ref(torch.from_numpy(g), torch.from_numpy(e), 1.0, kb)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(ne_t.numpy(), np.asarray(ne_j))


@pytest.mark.parametrize("rows,bc,kb", GEOMS[:5])
def test_topk_ef_ref_vs_pallas_lr005_one_ulp(rows, bc, kb):
    g, e = _inputs(rows, bc, "normal", 3 * rows + bc)
    ne_j, v_j, i_j = topk_ef_pallas(jnp.asarray(g), jnp.asarray(e), jnp.float32(0.05),
                                    kb, tile_blocks=rows, interpret=True)
    ne_t, v_t, i_t = topk_ef_ref(torch.from_numpy(g), torch.from_numpy(e), 0.05, kb)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _assert_product_ulp(v_t.numpy(), np.asarray(v_j), 0.05,
                        np.take_along_axis(g, i_t.numpy().astype(np.int64), 1))
    _assert_product_ulp(ne_t.numpy(), np.asarray(ne_j), 0.05, g)
    # the port rounds twice, exactly
    two = np.float32(0.05) * g + e
    np.testing.assert_array_equal(
        ne_t.numpy(), np.where(ne_t.numpy() == 0, 0, two).astype(np.float32))


@pytest.mark.parametrize("rows,bc,kb", GEOMS)
@pytest.mark.parametrize("kind", ["normal", "tied"])
def test_block_topk_ref_vs_pallas_bitwise(rows, bc, kb, kind):
    x, _ = _inputs(rows, bc, kind, 17 * rows + bc)
    v_j, i_j = block_topk_pallas(jnp.asarray(x), kb, tile_blocks=rows, interpret=True)
    v_t, i_t = block_topk_ref(torch.from_numpy(x), kb)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_nan_row_selects_nothing():
    """A NaN row: every pick is value 0 at column bc and nothing is taken
    (the masked argmax never matches a NaN max), in both packages."""
    g = np.ones((2, 8), np.float32)
    g[1, 3] = np.nan
    e = np.zeros_like(g)
    ne_j, v_j, i_j = topk_ef_pallas(jnp.asarray(g), jnp.asarray(e), jnp.float32(1.0),
                                    2, tile_blocks=2, interpret=True)
    ne_t, v_t, i_t = topk_ef_ref(torch.from_numpy(g), torch.from_numpy(e), 1.0, 2)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(ne_t.numpy(), np.asarray(ne_j))
    assert i_t[1].tolist() == [8, 8]


def test_blocked_topk_ef_ops_bitwise():
    """The per-shard entry: worker and lead dims folded into rows."""
    rng = np.random.default_rng(2)
    g = rng.normal(size=(3, 2, 3, 4, 1, 64)).astype(np.float32)
    e = (0.1 * rng.normal(size=g.shape)).astype(np.float32)
    vj, ij, nej = jax_ops.blocked_topk_ef(jnp.asarray(g), jnp.asarray(e), 2)
    vt, it, net = ops.blocked_topk_ef(torch.from_numpy(g), torch.from_numpy(e), 2)
    assert tuple(vt.shape) == g.shape[:-1] + (2,)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(net.numpy(), np.asarray(nej))


@pytest.mark.parametrize("k", [1, 50, 200])
def test_topk_ef_ops_padding_and_clamp(k):
    """d=1000 in blocks of 128: the tail is zero-filled (selectable), and
    picks past d come back as value 0 at index d-1."""
    rng = np.random.default_rng(k)
    d = 1000
    g = rng.normal(size=d).astype(np.float32)
    g[900:] = 0.0  # few nonzeros in the last block: forces tail picks at k=200
    e = np.zeros(d, np.float32)
    pj, nej = jax_ops.topk_ef(jnp.asarray(g), jnp.asarray(e), jnp.float32(1.0), k, 128)
    pt, net = ops.topk_ef(torch.from_numpy(g), torch.from_numpy(e), 1.0, k, 128)
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    np.testing.assert_array_equal(pt.values.numpy(), np.asarray(pj.values))
    np.testing.assert_array_equal(net.numpy(), np.asarray(nej))
    assert int(pt.indices.max()) <= d - 1
    # batched over a worker dim: each row is its own vector
    pb, neb = ops.topk_ef(torch.from_numpy(np.stack([g, g])), torch.zeros(2, d), 1.0, k, 128)
    np.testing.assert_array_equal(pb.indices[1].numpy(), np.asarray(pj.indices))
    np.testing.assert_array_equal(neb[1].numpy(), np.asarray(nej))


def test_topk_ef_ops_lr005_one_ulp():
    rng = np.random.default_rng(8)
    d = 1000
    g = rng.normal(size=d).astype(np.float32)
    e = (0.1 * rng.normal(size=d)).astype(np.float32)
    pj, nej = jax_ops.topk_ef(jnp.asarray(g), jnp.asarray(e), jnp.float32(0.05), 30, 128)
    pt, net = ops.topk_ef(torch.from_numpy(g), torch.from_numpy(e), 0.05, 30, 128)
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    _assert_product_ulp(pt.values.numpy(), np.asarray(pj.values), 0.05,
                        g[pt.indices.numpy()])
    _assert_product_ulp(net.numpy(), np.asarray(nej), 0.05, g)


@pytest.mark.parametrize("k", [7, 64])
def test_block_topk_entries_bitwise(k):
    """Both block top-k entries: through the fused kernel (topk_ef.ops)
    and through the EF-free kernel (block_topk.ops)."""
    rng = np.random.default_rng(k)
    x = rng.integers(-4, 5, size=700).astype(np.float32)
    pj = jax_ops.block_topk(jnp.asarray(x), k, 128)
    pt = ops.block_topk(torch.from_numpy(x), k, 128)
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    np.testing.assert_array_equal(pt.values.numpy(), np.asarray(pj.values))
    pj2 = jax_bt_ops.block_topk(jnp.asarray(x), k, 128)
    pt2 = bt_ops.block_topk(torch.from_numpy(x), k, 128)
    np.testing.assert_array_equal(pt2.indices.numpy(), np.asarray(pj2.indices))
    np.testing.assert_array_equal(pt2.values.numpy(), np.asarray(pj2.values))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: a CPU tensor is refused before
    any build or launch (the ops modules route CPU tensors to ref.py)."""
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        topk_ef_cuda(x, x, 1.0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        block_topk_cuda(x, 1)
