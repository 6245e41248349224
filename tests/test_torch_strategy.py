"""Strategies, partition specs and the TP block geometry against the JAX
package, in one process.

JAX runs on the 8 fake CPU devices of ``conftest.py``; the port on a
``StackedMesh`` of the same shape (names and sizes only: nothing split in
memory, the exchange's block geometry from the specs, as the JAX
package's run on fake devices).

- ``choose_strategy`` equals JAX's field by field over 1-D, 2-D and 3-D
  meshes, a ``stage`` axis with divisible and indivisible trunks, SASG on
  and off, and the ``params_bytes`` boundary at an explicit budget; the
  default budget is the device's memory (here the host's), never the
  TPU's 16 GiB.
- Every spec function equals JAX's: every arch at its reduced size on
  (4, 2) and (2, 2, 2), cnn_cifar and llama3_8b at full width from shapes
  only.
- ``bits_paper`` / ``bits_wire`` per upload equal JAX's exchange's on
  (4, 1), (4, 2), (2, 4) and (2, 2, 2) (cnn_cifar at full width: 1,132,736
  / 1,477,664 / 1,880,800 at model 1 / 2 / 4).
- Steps, in the tiers of ``test_torch_train_step.py`` (sends, rounds and
  bits exact; params within 2e-2 under top-k, 1e-5 for sgd):
  4 SASG steps on (4, 2) for the d_model=16 CNN and reduced llama3_8b
  against JAX's sharded step; plain (``--algo sgd``) on (4, 2) against
  JAX's plain step; hierarchical on (2, 2, 1) against the port's flat step
  and JAX's flat (2, 1) step on the same rows (the JAX package's own
  hierarchical step aborts the process on this JAX, ROADMAP queue 3).
  A hand-built hierarchical strategy with ``fsdp_axis`` (refused by the
  JAX package, an XLA partitioner limit) runs in the port.
- ``remap_error_state`` and ``worker_dims_match`` follow the reference's
  rules.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.core.sasg import PRESETS as JAX_PRESETS
from repro.data import indexed_classification_stream, indexed_token_stream, synthetic_classification
from repro.dist import sharding as jsh
from repro.dist.strategy import Strategy as JStrategy
from repro.dist.strategy import choose_strategy as jax_choose_strategy
from repro.models import build as jax_build
from repro.optim import constant as jax_constant
from repro.train import build_train_step as jax_build_train_step
from repro_torch.comm import bits
from repro_torch.configs import ARCH_IDS, PAPER_IDS, get_config
from repro_torch.core.error_feedback import remap_error_state, worker_dims_match
from repro_torch.core.sasg import PRESETS
from repro_torch.core.types import tree_flatten_with_paths, tree_leaves
from repro_torch.dist import sharding as tsh
from repro_torch.dist.strategy import Strategy, choose_strategy, default_replica_budget
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build, params_from_numpy
from repro_torch.optim import constant
from repro_torch.train import build_train_step

STEPS, LR = 4, 0.05
AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(shape, axes=None):
    axes = axes or AXES[len(shape)]
    n = int(np.prod(shape))
    return (compat.make_mesh(shape, axes, devices=jax.devices()[:n]),
            make_test_mesh(shape, axes))


def _fields(s) -> tuple:
    return tuple(getattr(s, f.name) for f in dataclasses.fields(JStrategy)) + (
        s.uses_shard_map, s.pipelined, s.membership, s.inner_dp, s.batch_axes)


def test_choose_strategy_matches_jax():
    budget = 2 ** 30
    cases = []
    for shape, axes in [((4,), ("data",)), ((4, 2), None), ((2, 4), None), ((8,), ("model",)),
                        ((2, 2, 2), None), ((2, 2, 2), ("data", "stage", "model")),
                        ((2, 4, 1), ("pod", "data", "stage"))]:
        for sasg in (True, False):
            for pstages, trunk in ((1, None), (2, None), (2, 4), (2, 3), (4, 8), (2, 0)):
                for pbytes in (None, budget // 3, budget // 3 + 1, 10 * budget):
                    cases.append((shape, axes, sasg, pstages, trunk, pbytes))
    for shape, axes, sasg, pstages, trunk, pbytes in cases:
        jmesh, tmesh = _meshes(shape, axes)
        kw = dict(sasg_enabled=sasg, params_bytes=pbytes, replica_budget_bytes=budget,
                  pipeline_stages=pstages, microbatches=3, trunk_layers=trunk)
        want, got = jax_choose_strategy(jmesh, **kw), choose_strategy(tmesh, **kw)
        assert _fields(got) == _fields(want), (shape, axes, kw)
    # the boundary: 3 x params_bytes / tp == budget still fits, one byte more does not
    _, tmesh = _meshes((4, 2))
    assert choose_strategy(tmesh, params_bytes=2 * budget // 3,
                           replica_budget_bytes=budget).name == "flat"
    assert choose_strategy(tmesh, params_bytes=2 * budget // 3 + 1,
                           replica_budget_bytes=budget).name == "plain"
    # the default budget is this device's memory (the host's on a CPU mesh)
    host = default_replica_budget(tmesh)
    assert host == os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert choose_strategy(tmesh, params_bytes=2 * host // 3).name == "flat"
    assert choose_strategy(tmesh, params_bytes=host).name == "plain"


def _specs_equal(want_tree, got_tree, what):
    want = jax.tree_util.tree_flatten_with_path(
        want_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    paths, got, _ = tree_flatten_with_paths(got_tree, is_leaf=tsh.is_spec)
    assert len(want) == len(got), what
    for (wpath, w), p, g in zip(want, paths, got):
        wkey = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in wpath)
        assert wkey == p and tuple(w) == tuple(g), (what, p, tuple(w), tuple(g))


def _cache_trees(jmodel, tmodel):
    if jmodel.init_cache is None:
        return []
    trees = [(jax.eval_shape(lambda: jmodel.init_cache(2, 16)),
              tmodel.init_cache(2, 16, device="meta"))]
    if jmodel.init_paged_cache is not None:
        trees.append((jax.eval_shape(lambda: jmodel.init_paged_cache(2, 16, 8, 4)),
                      tmodel.init_paged_cache(2, 16, 8, 4, device="meta")))
    return trees


@pytest.mark.parametrize("scope", ["reduced", "full_width"])
def test_specs_match_jax(scope):
    """param_specs / ef_specs / stage_only_spec / strip_stage_spec /
    batch_specs / cache_specs on (4, 2) and (2, 2, 2)."""
    archs = (PAPER_IDS + ARCH_IDS) if scope == "reduced" else ["cnn_cifar", "llama3_8b"]
    for arch in archs:
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        if scope == "reduced" and arch not in PAPER_IDS:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        jmodel, tmodel = jax_build(jcfg), build(tcfg)
        jshape = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        tshape = tmodel.init(torch.Generator().manual_seed(0), device="meta")
        for shape in ((4, 2), (2, 2, 2)):
            jmesh, tmesh = _meshes(shape)
            for fsdp, tp in ((None, "model"), ("data", "model"), (("pod", "data"), "model")
                             if len(shape) == 3 else ("data", None)):
                what = (arch, shape, fsdp, tp)
                jp = jsh.param_specs(jshape, jmesh, fsdp, tp)
                tp_ = tsh.param_specs(tshape, tmesh, fsdp, tp)
                _specs_equal(jp, tp_, what)
                _specs_equal(jsh.ef_specs(jp, None, False), tsh.ef_specs(tp_, None, False), what)
            # the stage-axis arguments (used by the pipeline, ROADMAP item 9)
            trunk = (("trunk",),) if arch == "cnn_cifar" else (("unit",),)
            jp = jsh.param_specs(jshape, jmesh, None, "model", stage_axis="data",
                                 trunk_paths=trunk)
            tp_ = tsh.param_specs(tshape, tmesh, None, "model", stage_axis="data",
                                  trunk_paths=trunk)
            _specs_equal(jp, tp_, (arch, shape, "stage"))
            for stage_sharded in (True, False):
                _specs_equal(jsh.ef_specs(jp, "data", stage_sharded),
                             tsh.ef_specs(tp_, "data", stage_sharded), (arch, "ef", stage_sharded))
            for w, g in zip(jax.tree.leaves(jp, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)), tree_leaves(tp_, is_leaf=tsh.is_spec)):
                assert tuple(jsh.stage_only_spec(w, "data")) == tuple(tsh.stage_only_spec(g, "data"))
                assert tuple(jsh.strip_stage_spec(w, "data")) == tuple(tsh.strip_stage_spec(g, "data"))
            batch = {"x": np.zeros((8, 3)), "labels": np.zeros((8,)), "odd": np.zeros((3, 2))}
            _specs_equal(jsh.batch_specs(batch, jmesh, "data"),
                         tsh.batch_specs({k: torch.from_numpy(v) for k, v in batch.items()},
                                         tmesh, "data"), (arch, "batch"))
            if scope == "reduced":
                # the JAX layout; the port's tensor-parallel engine departs
                # from it for the SSD and RG-LRU states, each rank's model
                # building its own part (held by tests/test_torch_mesh.py)
                for jc, tc in _cache_trees(jmodel, tmodel):
                    _specs_equal(jsh.cache_specs(jc, jmesh, "data", "model"),
                                 tsh.cache_specs(tc, tmesh, "data", "model"), (arch, "cache"))


def _jax_step(jcfg, preset, shape, strategy=None):
    jmesh = compat.make_mesh(shape, AXES[len(shape)], devices=jax.devices()[:int(np.prod(shape))])
    strategy = strategy or jax_choose_strategy(jmesh, sasg_enabled=preset != "sgd")
    return jax_build_train_step(jax_build(jcfg), JAX_PRESETS[preset](), jmesh, strategy,
                                jax_constant(LR))


def _configs(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if arch == "cnn_cifar":
        return (dataclasses.replace(jcfg, d_model=16), dataclasses.replace(tcfg, d_model=16))
    return jcfg.reduced(), tcfg.reduced()


def _stream(arch, global_batch):
    if arch == "llama3_8b":
        return indexed_token_stream(256, global_batch, 16, seed=0)
    xs, ys = synthetic_classification(256, 10, (32, 32, 3), seed=0)
    return indexed_classification_stream(xs, ys, global_batch, seed=0)


def _lockstep(jbuilt, tbuilt, arch, global_batch, param_tol, steps=STEPS, sent_only=False):
    jstate = jbuilt.init(jax.random.PRNGKey(2))
    tstate = tbuilt.init(params=params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    stream = _stream(arch, global_batch)
    for step in range(steps):
        batch = stream.batch_at(step)
        jstate, jm = jbuilt.jit_step(jstate, batch)
        tstate, tm = tbuilt.step(tstate, batch)
        assert float(tm["num_sent"]) == float(jm["num_sent"]), step
        for key in ("rounds_total", "bits_paper_total", "bits_wire_total"):
            assert float(tm[key]) == float(jm[key]), (step, key)
        diff = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
                   for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)))
        assert diff < param_tol, (step, diff)
    return tstate


def test_bits_match_jax():
    want_cnn = {(4, 1): 1_132_736, (4, 2): 1_477_664, (2, 4): 1_880_800}
    for arch in ("cnn_cifar", "llama3_8b"):
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        if arch == "llama3_8b":
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        for shape in ((4, 1), (4, 2), (2, 4), (2, 2, 2)):
            jbuilt = _jax_step(jcfg, "sasg", shape)
            tbuilt = build_train_step(build(tcfg), PRESETS["sasg"](), None, constant(LR),
                                      device="cpu", mesh=make_test_mesh(shape, AXES[len(shape)]))
            assert tbuilt.strategy.name == jbuilt.strategy.name
            assert (tbuilt.bits_paper, tbuilt.bits_wire) == (jbuilt.bits_paper, jbuilt.bits_wire)
            if arch == "cnn_cifar" and shape in want_cnn:
                assert tbuilt.bits_paper == want_cnn[shape]
    # a spec tree that does not fit the leaves is refused, not read as unsharded
    template = build(get_config("cnn_cifar")).init(torch.Generator().manual_seed(0), "meta")
    specs = tsh.param_specs(template, make_test_mesh((4, 2), AXES[2]), None, "model")
    with pytest.raises(ValueError, match="leaf specs"):
        short = tree_leaves(specs, is_leaf=lambda x: x is None or tsh.is_spec(x))[:-1]
        bits.account(PRESETS["sasg"]().compressor, template, short, {"data": 4, "model": 2})


@pytest.mark.parametrize("arch", ["cnn_cifar", "llama3_8b"])
def test_sasg_steps_match_jax_on_a_4x2_mesh(arch):
    jcfg, tcfg = _configs(arch)
    jbuilt = _jax_step(jcfg, "sasg", (4, 2))
    tbuilt = build_train_step(build(tcfg), PRESETS["sasg"](), None, constant(LR), device="cpu",
                              mesh=make_test_mesh((4, 2), AXES[2]))
    assert tbuilt.strategy.name == "flat" and tbuilt.num_workers == 4
    _lockstep(jbuilt, tbuilt, arch, 8, 2e-2)


def test_plain_matches_jax_on_a_4x2_mesh():
    jcfg, tcfg = _configs("cnn_cifar")
    jbuilt = _jax_step(jcfg, "sgd", (4, 2))
    tbuilt = build_train_step(build(tcfg), PRESETS["sgd"](), None, constant(LR), device="cpu",
                              mesh=make_test_mesh((4, 2), AXES[2]))
    assert (tbuilt.strategy.name, jbuilt.strategy.name) == ("plain", "plain")
    assert tbuilt.exchange is None and tbuilt.bits_paper == jbuilt.bits_paper
    state = _lockstep(jbuilt, tbuilt, "cnn_cifar", 8, 1e-5)
    assert state.wstate == () and state.gstate == ()


def test_hierarchical_matches_flat_on_the_same_rows():
    """(2, 2, 1): each pod one worker, its rows split over the in-pod data
    axis. Against the port's flat (2, 1) step and JAX's flat (2, 1) step."""
    jcfg, tcfg = _configs("cnn_cifar")
    jbuilt = _jax_step(jcfg, "sasg", (2, 1))
    hier = build_train_step(build(tcfg), PRESETS["sasg"](), None, constant(LR), device="cpu",
                            mesh=make_test_mesh((2, 2, 1), AXES[3]))
    flat = build_train_step(build(tcfg), PRESETS["sasg"](), None, constant(LR), device="cpu",
                            mesh=make_test_mesh((2, 1), AXES[2]))
    assert hier.strategy.name == "hierarchical" and hier.num_workers == 2
    assert hier.strategy.inner_dp == "data" and hier.strategy.fsdp_axis is None
    sh = _lockstep(jbuilt, hier, "cnn_cifar", 8, 2e-2)
    sf = _lockstep(jbuilt, flat, "cnn_cifar", 8, 2e-2)
    for a, b in zip(tree_leaves(sh.params), tree_leaves(sf.params)):
        assert float((a - b).abs().max()) < 2e-2
    np.testing.assert_array_equal(sh.wstate.tau.numpy(), sf.wstate.tau.numpy())
    # FSDP inside the pod: the JAX package refuses it; the port runs it
    mesh = make_test_mesh((2, 2, 1), AXES[3])
    s = choose_strategy(mesh)
    fsdp = Strategy(s.name, s.upload_axes, s.grad_axes, "data", s.data_axis, s.tp_axis,
                    s.num_workers)
    built = build_train_step(build(tcfg), PRESETS["sasg"](), None, constant(LR), device="cpu",
                             mesh=mesh, strategy=fsdp)
    state, mets = built.step(built.init(seed=2), _stream("cnn_cifar", 8).batch_at(0))
    assert float(mets["num_sent"]) == 2.0 and np.isfinite(float(mets["loss"]))


def test_ef_remap_and_worker_dims():
    mesh = make_test_mesh((2, 2), AXES[2])
    err = {"w": torch.arange(24.0).reshape(2, 3, 4), "b": torch.ones(2, 4)}
    specs = {"w": tsh.P("data", None, "model"), "b": tsh.P("data", None)}
    # a StackedMesh splits nothing: the arrays come back as they are, bitwise
    out = remap_error_state(err, specs, mesh)
    assert all(out[k] is err[k] for k in err)
    # None keeps the leaf; a raw spec needs the mesh
    assert remap_error_state(err, {"w": None, "b": None})["w"] is err["w"]
    with pytest.raises(ValueError, match="target mesh"):
        remap_error_state(err, specs)
    # axes the target lacks, or holds at size 1, are stripped
    one = make_test_mesh((2, 1), AXES[2])
    assert tuple(tsh.live_spec(tsh.P("data", ("stage", "model")), one)) == ("data", None)
    assert tuple(tsh.live_spec(tsh.P(("pod", "data"), "model"), mesh)) == ("data", "model")
    # worker dims: every leaf's leading dim is M; empty state matches anything
    assert worker_dims_match(err, 2) and not worker_dims_match(err, 4)
    assert worker_dims_match((), 3)
    assert not worker_dims_match({"s": torch.zeros(())}, 1)
