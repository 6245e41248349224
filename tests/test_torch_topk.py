"""Parity of the port's top-k operators (repro_torch.core.topk) with the JAX
package's (repro.core.topk). Inputs come from numpy seeds and go through
both packages; every comparison is bitwise in fp32 (the selection is
iterative masked argmax with the lowest-index tie-break in both)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import topk as J
from repro.models import build as jax_build
from repro_torch.core import topk as T


def _leaf_shapes(arch):
    params = jax.eval_shape(jax_build(jax_get_config(arch)).init, jax.random.PRNGKey(0))
    return [tuple(x.shape) for x in jax.tree.leaves(params)]


def _tied(rng, shape):
    """Small integers of both signs: many equal magnitudes, zeros too."""
    return rng.integers(-3, 4, size=shape).astype(np.float32)


@pytest.mark.parametrize("arch", ["cnn_cifar", "fc_mnist"])
def test_blocked_view_shape_every_leaf(arch):
    shapes = _leaf_shapes(arch)
    assert len(shapes) == (37 if arch == "cnn_cifar" else 4)
    for shape in shapes:
        for target in (64, 256, 2048):
            assert T.blocked_view_shape(shape, None, target) == \
                J.blocked_view_shape(shape, None, target), (shape, target)


def test_blocked_view_shape_sharded_sweep():
    shapes = _leaf_shapes("cnn_cifar") + [(1000,), (6, 10), (4, 96, 48), (2, 3, 3, 64, 64)]
    n = 0
    for shape in shapes:
        for ax in [None] + list(range(len(shape))):
            for size in (1, 2, 4):
                if ax is not None and shape[ax] % size:
                    continue
                for target in (16, 128, 256):
                    got = T.blocked_view_shape(shape, ax, target, size)
                    assert got == J.blocked_view_shape(shape, ax, target, size)
                    n += 1
    assert n > 500


@pytest.mark.parametrize("shape,kb", [
    ((6, 64), 1), ((3, 4, 10), 1), ((5, 128), 2), ((2, 3, 256), 3),
    ((4, 7), 7), ((3, 1), 1), ((2, 257), 4),
])
@pytest.mark.parametrize("tied", [False, True])
def test_blocked_topk_bitwise(shape, kb, tied):
    rng = np.random.default_rng(sum(shape) * 7 + kb)
    x = _tied(rng, shape) if tied else rng.normal(size=shape).astype(np.float32)
    pj = J.blocked_topk(jnp.asarray(x), kb)
    pt = T.blocked_topk(torch.from_numpy(x), kb)
    np.testing.assert_array_equal(pt.values.numpy(), np.asarray(pj.values))
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    assert pt.indices.dtype == torch.int32


def test_blocked_topk_all_zero_rows_pick_first_columns():
    """zero_payload's stale cache: all-zero rows select columns 0..kb-1."""
    x = np.zeros((3, 2, 16), np.float32)
    pt = T.blocked_topk(torch.from_numpy(x), 3)
    pj = J.blocked_topk(jnp.asarray(x), 3)
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    np.testing.assert_array_equal(pt.indices.numpy(),
                                  np.broadcast_to(np.arange(3), (3, 2, 3)))


@pytest.mark.parametrize("d,k,bs", [(1000, 10, 128), (1000, 50, 128), (256, 3, 256), (77, 5, 32)])
@pytest.mark.parametrize("tied", [False, True])
def test_block_topk_bitwise(d, k, bs, tied):
    rng = np.random.default_rng(d + k + bs)
    x = _tied(rng, (d,)) if tied else rng.normal(size=(d,)).astype(np.float32)
    pj = J.block_topk(jnp.asarray(x), k, bs)
    pt = T.block_topk(torch.from_numpy(x), k, bs)
    np.testing.assert_array_equal(pt.values.numpy(), np.asarray(pj.values))
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    assert pt.size == pj.size == d
    np.testing.assert_array_equal(pt.densify().numpy(), np.asarray(pj.densify()))
    # the worker dim: a stacked batch gives each row's own payload
    xs = np.stack([x, -x[::-1].copy()])
    ps = T.block_topk(torch.from_numpy(xs), k, bs)
    np.testing.assert_array_equal(ps.indices[0].numpy(), np.asarray(pj.indices))


@pytest.mark.parametrize("tied", [False, True])
def test_exact_topk_bitwise(tied):
    rng = np.random.default_rng(5)
    x = _tied(rng, (300,)) if tied else rng.normal(size=(300,)).astype(np.float32)
    pj = J.exact_topk(jnp.asarray(x), 17)
    pt = T.exact_topk(torch.from_numpy(x), 17)
    np.testing.assert_array_equal(pt.indices.numpy(), np.asarray(pj.indices))
    np.testing.assert_array_equal(pt.values.numpy(), np.asarray(pj.values))


@pytest.mark.parametrize("lead,kb,bc", [((5,), 2, 16), ((2, 3), 3, 64), ((4,), 1, 10)])
def test_scatter_last_bitwise(lead, kb, bc):
    rng = np.random.default_rng(kb * bc)
    idx = np.stack([rng.permutation(bc)[:kb] for _ in range(int(np.prod(lead)))])
    idx = idx.reshape(lead + (kb,)).astype(np.int32)
    vals = rng.normal(size=lead + (kb,)).astype(np.float32)
    dj = J._scatter_last(jnp.asarray(vals), jnp.asarray(idx), bc)
    dt = T._scatter_last(torch.from_numpy(vals), torch.from_numpy(idx), bc)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_block_payload_densify_roundtrip():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 3, 8, 64)).astype(np.float32)
    blocked = J.blocked_view_shape(x.shape, None, 256)
    pj = J.blocked_topk(jnp.asarray(x.reshape(blocked)), 2)
    pj = J.BlockPayload(pj.values, pj.indices, blocked, x.shape)
    pt = T.blocked_topk(torch.from_numpy(x.reshape(blocked)), 2)
    pt = T.BlockPayload(pt.values, pt.indices, blocked, x.shape)
    np.testing.assert_array_equal(pt.densify().numpy(), np.asarray(pj.densify()))
    # a leading worker dim densifies per worker
    pw = T.BlockPayload(pt.values[None].expand(2, *pt.values.shape),
                        pt.indices[None].expand(2, *pt.indices.shape), blocked, x.shape)
    assert tuple(pw.densify().shape) == (2,) + x.shape
