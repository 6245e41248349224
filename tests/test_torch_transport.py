"""Parity of the port's transport (encode / exchange / densify / bits) and
selection rule with the JAX package's. The same numpy gradients and EF
buffers go through ``repro.comm.transport.Transport`` (one worker at a
time) and ``repro_torch.comm.transport.Transport`` (M workers stacked on a
leading dim). Payloads, candidate EF state and the M=4 densified mean are
compared bitwise; the dense (identity) mean to 1e-6 relative, because
XLA's cross-device psum may add the four workers in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import collectives as jax_coll
from repro.comm.transport import build_transport as jax_build_transport
from repro.configs import get_config as jax_get_config
from repro.core import selection as jax_sel
from repro.core.compressors import CompressorConfig as JaxCC
from repro.core.topk import BlockPayload as JaxBP, SparsePayload as JaxSP
from repro.models import build as jax_build
from repro_torch.comm.transport import build_transport
from repro_torch.core import selection as sel
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.topk import BlockPayload, SparsePayload
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models import params_from_numpy

LAYOUTS = [
    ("per_shard", "kernel"), ("per_shard", "reference"),
    ("per_tensor", "reference"), ("per_tensor", "kernel"), ("per_tensor", "exact"),
    ("flat", "reference"), ("flat", "kernel"),
]


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one intra-op thread for every test here: the tensors are
    small, and under pytest-xdist every worker's default pool of one thread
    per core oversubscribes the machine and slows the other workers'
    tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(arch, d_model=None):
    cfg = jax_get_config(arch)
    if d_model:
        import dataclasses

        cfg = dataclasses.replace(cfg, d_model=d_model)
    return jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))


# a few leaves of cnn_cifar's kinds, dict keys deliberately NOT in sorted
# order: the flatten order (and so the flat layout's concatenation and the
# payload / EF pairing) must follow jax.tree's sorted keys
SMALL = {
    "trunk": {"conv1": jax.ShapeDtypeStruct((2, 3, 3, 8, 8), jnp.float32),
              "gn1": {"scale": jax.ShapeDtypeStruct((2, 8), jnp.float32)}},
    "head": {"w": jax.ShapeDtypeStruct((32, 10), jnp.float32),
             "b": jax.ShapeDtypeStruct((10,), jnp.float32)},
    "stem": jax.ShapeDtypeStruct((3, 3, 3, 16), jnp.float32),
    "gn0": {"bias": jax.ShapeDtypeStruct((16,), jnp.float32)},
}


def _random_tree(shapes, rng, scale=1.0):
    return jax.tree.map(
        lambda s: (scale * rng.normal(size=s.shape)).astype(np.float32), shapes
    )


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _stack_np(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


@pytest.mark.parametrize("layout,impl", LAYOUTS)
def test_encode_bitwise_vs_jax(layout, impl):
    shapes = SMALL
    rng = np.random.default_rng(LAYOUTS.index((layout, impl)))
    gs = [_random_tree(shapes, rng) for _ in range(2)]
    es = [_random_tree(shapes, rng, 0.1) for _ in range(2)]
    if layout == "flat":  # the EF buffer of the flat layout is the global vector
        es = [{"__global__": np.concatenate([x.reshape(-1) for x in jax.tree.leaves(e)])}
              for e in es]
    kw = dict(name="topk_ef", k_ratio=0.02, layout=layout, topk_impl=impl)
    jt = jax_build_transport(JaxCC(**kw), ("data",), 1)
    tt = build_transport(CompressorConfig(**kw), 2)

    pt, ct = tt.encode(params_from_numpy(_stack_np(es)), params_from_numpy(_stack_np(gs)))
    for m in range(2):
        pj, cj = jt.encode(_jnp(es[m]), _jnp(gs[m]), jax.random.PRNGKey(0))
        lt, lj = tree_leaves(pt), jax.tree.leaves(pj)
        assert len(lt) == len(lj)
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(a[m].numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(ct), jax.tree.leaves(cj)):
            np.testing.assert_array_equal(a[m].numpy(), np.asarray(b))


def test_zero_payload_matches_jax():
    """The empty stale cache: values 0, indices 0..kb-1 in every block."""
    shapes = _shapes("cnn_cifar", d_model=16)
    jt = jax_build_transport(JaxCC(), ("data",), 1)
    tt = build_transport(CompressorConfig(), 3)
    params = params_from_numpy(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    pj = jt.zero_payload(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes))
    pt = tt.zero_payload(params)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        for m in range(3):
            np.testing.assert_array_equal(a[m].numpy(), np.asarray(b))


@pytest.mark.parametrize("arch,paper,wire", [
    ("cnn_cifar", 1_132_736, 2_265_472), ("fc_mnist", 167_136, 334_272),
])
def test_bits_full_width(arch, paper, wire):
    shapes = _shapes(arch)
    template = params_from_numpy(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    cfg = CompressorConfig()
    tt = build_transport(cfg, 10)
    assert tt.bits_paper(template) == paper
    assert tt.bits_wire(template) == wire
    jrep = jax_build_transport(JaxCC(), ("data",), 10).bits_report(shapes)
    assert tt.bits_report(template).rows() == jrep.rows()


@pytest.mark.parametrize("kw", [
    dict(layout="per_tensor"), dict(layout="per_tensor", topk_impl="exact"),
    dict(layout="flat"), dict(compact_indices=True), dict(wire_dtype="bfloat16"),
    dict(k_ratio_per_layer=(("trunk", 0.05),)), dict(name="identity"),
    dict(name="identity", wire_dtype="bfloat16"),
])
def test_bits_per_bucket_vs_jax(kw):
    shapes = _shapes("cnn_cifar")
    template = params_from_numpy(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    trep = build_transport(CompressorConfig(**kw), 4).bits_report(template)
    jrep = jax_build_transport(JaxCC(**kw), ("data",), 4).bits_report(shapes)
    assert trep.rows() == jrep.rows()


def _jax_mean(mesh, payload_np, kind):
    """collectives.exchange inside a shard_map over the 4-way data axis."""

    def worker(payload):
        payload = jax.tree.map(lambda x: x[0], payload)
        return jax_coll.exchange(payload, kind, ("data",), 4)

    sm = jax.shard_map(worker, mesh=mesh, in_specs=(P("data"),), out_specs=P(),
                       axis_names={"data"}, check_vma=False)
    return jax.jit(sm)(payload_np)


@pytest.mark.parametrize("layout", ["per_shard", "per_tensor", "flat"])
def test_densified_mean_m4_bitwise_vs_shard_map(mesh2d, layout):
    shapes = _shapes("cnn_cifar", d_model=16)
    rng = np.random.default_rng(4)
    g = params_from_numpy(_stack_np([_random_tree(shapes, rng) for _ in range(4)]))
    tt = build_transport(CompressorConfig(k_ratio=0.05, layout=layout), 4)
    payload, _ = tt.encode(tt.init_state(g), g)
    mean_t = tt.exchange(payload)

    def to_jax(p):
        if isinstance(p, BlockPayload):
            return JaxBP(jnp.asarray(p.values.numpy()), jnp.asarray(p.indices.numpy()),
                         p.blocked_shape, p.orig_shape)
        return JaxSP(jnp.asarray(p.values.numpy()), jnp.asarray(p.indices.numpy()), p.size)

    jpayload = tree_map(to_jax, payload, is_leaf=lambda x: isinstance(x, (BlockPayload, SparsePayload)))
    mean_j = _jax_mean(mesh2d, jpayload, "sparse")
    lt, lj = tree_leaves(mean_t), jax.tree.leaves(mean_j)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # densify restores leaf shapes (fp32)
    upd = tt.densify(mean_t, tree_map(lambda x: x[0], g))
    for u, x in zip(tree_leaves(upd), tree_leaves(g)):
        assert u.shape == x.shape[1:] and u.dtype == torch.float32


def test_dense_mean_m4_vs_shard_map(mesh2d):
    shapes = _shapes("fc_mnist")
    rng = np.random.default_rng(6)
    g_np = _stack_np([_random_tree(shapes, rng) for _ in range(4)])
    tt = build_transport(CompressorConfig(name="identity"), 4)
    mean_t = tt.exchange(tt.encode(tt.init_state(params_from_numpy(g_np)),
                                   params_from_numpy(g_np))[0])
    mean_j = _jax_mean(mesh2d, _jnp(g_np), "dense")
    for a, b in zip(tree_leaves(mean_t), jax.tree.leaves(mean_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", range(6))
def test_selection_rule_vs_jax(seed):
    rng = np.random.default_rng(seed)
    D, M = 5, 4
    cfg_j = jax_sel.SelectionConfig(enabled=True, max_delay=D)
    cfg_t = sel.SelectionConfig(enabled=True, max_delay=D)
    shapes = {"a": (3, 4), "b": (7,)}
    fresh = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(M)]
    stale = [{k: (f[k] + rng.normal(scale=0.3, size=f[k].shape)).astype(np.float32)
              for k in shapes} for f in fresh]
    window = rng.uniform(0, 0.2, size=D).astype(np.float32)
    tau = rng.integers(1, D + 2, size=M).astype(np.int32)
    force = rng.random(M) < 0.3
    lr = np.float32(rng.uniform(0.01, 0.5))
    alphas_j = jax_sel.resolve_alphas(cfg_j, float(lr))
    alphas_t = sel.resolve_alphas(cfg_t, torch.tensor(lr))
    np.testing.assert_array_equal(alphas_t.numpy(), np.asarray(alphas_j))

    st_t = sel.SelectionState(torch.from_numpy(tau), torch.from_numpy(window))
    send_t = sel.should_send(
        cfg_t, params_from_numpy(_stack_np(fresh)), params_from_numpy(_stack_np(stale)),
        st_t, alphas_t, M, torch.from_numpy(force), batch_dims=1)
    for m in range(M):
        st_j = jax_sel.SelectionState(jnp.int32(tau[m]), jnp.asarray(window))
        sj = jax_sel.should_send(cfg_j, _jnp(fresh[m]), _jnp(stale[m]), st_j, alphas_j, M,
                                 jnp.asarray(force[m]))
        assert bool(send_t[m]) == bool(sj)
        assert int(sel.advance_tau(sel.SelectionState(torch.tensor(tau[m]), None),
                                   send_t[m])) == int(jax_sel.advance_tau(st_j, sj))
    upd = np.float32(rng.uniform(0, 1))
    np.testing.assert_array_equal(
        sel.push_window(st_t, torch.tensor(upd)).numpy(),
        np.asarray(jax_sel.push_window(jax_sel.SelectionState(jnp.int32(1), jnp.asarray(window)),
                                       jnp.float32(upd))),
    )
