"""The port's pipeline against the JAX package's, and its two forms against each other.

``repro_torch.dist.pipeline`` runs a model's trunk over S stages (1F1B,
or GPipe as the reference engine); the train step composes it with the
SASG exchange on a mesh with a ``stage`` axis: stacked in one process, or
one stage a gloo rank. d_model=16 CNN, SASG, on the CPU.

Tolerances:
- the engines on a toy ``PipelineDef`` against the JAX engines in a
  shard_map over S = 2, 4 fake devices: loss rtol 1e-6, gradients rtol
  1e-4 / atol 1e-6 (the JAX suite's ``test_1f1b_matches_sequential``), and
  the port's 1F1B against its GPipe: loss bitwise, gradients within 1e-7
  (accumulation order), as the JAX suite holds its two; autograd of
  ``build_pipelined_loss`` against GPipe's hand-written backward: the same
  tiers.
- the CNN's pipelined per-worker gradients against the unpipelined ones:
  loss rtol 1e-5, each leaf within 1e-4 of its largest magnitude
  (microbatching reorders the sums).
- ``ActivationLayout``: identity round trip bitwise; the blocked top-k
  encode's values and indices bitwise the JAX encode's (``lax.top_k``'s
  order and ties), its payload bits those of ``bits.activation_payload_bits``
  and of the wire tensors.
- the pipelined SASG step on a stacked (2, 2) ``data`` x ``stage`` mesh
  against the JAX step on the same mesh (the benched layout: compressed
  1F1B ring, overlap): sends, rounds and bits exact, the stage traffic
  798,720 ring + 48,384 gather bits a step (BENCH_pipeline.json's
  ``pipelined`` record), params within the JAX suite's ``flat_pipe_check``
  tier (2e-2), losses rtol 1e-2 (1e-6 at the first step). The identity
  ring is compared every step (it reads ~6e-8); the compressed ring after
  its first step only (5e-4 there): its top-k of activations and
  cotangents flips near-tied picks on last-bit gradient differences, and
  the lossy forward carries each flip on (the JAX suite checks its own
  compressed ring only for structure). The port's pipelined steps against
  its flat step within the same tier. ``overlap=True`` is accepted for
  config parity and runs the synchronous exchange.
- stage-local encode against flat encode: bitwise (topk_ef per_shard,
  the payload path; qsgd, the dense fallback).
- two gloo ranks (one stage each), and four as stages x a model axis,
  against the stacked run: bitwise (sends, counters, params, worker
  state); a 2-stage checkpoint restores into a flat run with the worker
  state carried bitwise.

Four test items, torch on one intra-op thread (the suite's item count sets
pytest-xdist's chunk sizes, ROADMAP.md).
"""
import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.compat
from repro.comm.transport import ActivationLayout as JaxLayout
from repro.configs import get_config as jax_get_config
from repro.core import metrics as JCM
from repro.core import sasg_config as jax_sasg_config
from repro.dist.pipeline import build_pipelined_vag as jax_build_pipelined_vag
from repro.dist.pipeline import resolve_microbatches as jax_resolve
from repro.dist.strategy import choose_strategy as jax_choose_strategy
from repro.models import build as jax_build
from repro.models.model import PipelineDef as JaxPipelineDef
from repro.optim import constant as jax_constant
from repro.train import build_train_step as jax_build_train_step
from repro_torch.comm import bits as bits_lib
from repro_torch.comm import collectives, process_group
from repro_torch.comm.collectives import StageAxis
from repro_torch.comm.transport import ActivationLayout, StageInfo, Transport
from repro_torch.configs import get_config
from repro_torch.core import metrics as CM
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.sasg import sasg_config
from repro_torch.core.types import tree_flatten_with_paths, tree_leaves, tree_map
from repro_torch.dist.pipeline import (build_pipelined_loss, build_pipelined_vag,
                                       build_stage_combine, resolve_microbatches)
from repro_torch.dist.strategy import choose_strategy
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build, params_from_numpy
from repro_torch.models.model import PipelineDef
from repro_torch.optim import constant
from repro_torch.train import Trainer, TrainerConfig, build_train_step

LR, STEPS, M = 0.05, 3, 2
RING = dict(wire_dtype="float32", k_ratio=0.05, block_size=256)
RING_BITS, GATHER_BITS, GPIPE_RING_BITS = 798_720.0, 48_384.0, 10_485_760.0
KEYS = ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total")
JOIN_S = 300.0


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cnn_cfg():
    return dataclasses.replace(get_config("cnn_cifar"), d_model=16)


def _batches(n, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=(b,)).astype(np.int32)} for _ in range(n)]


def _port_configs():
    base = sasg_config(k_ratio=0.05, max_delay=4)
    return {
        "sasg": base,
        "ring": dataclasses.replace(base, act_layout=ActivationLayout(**RING), overlap=True),
        "gpipe": dataclasses.replace(base, pipeline_engine="gpipe"),
        "qsgd": dataclasses.replace(base, compressor=CompressorConfig(name="qsgd")),
    }


def _pipe_built(scfg, group=None, shape=(M, 2)):
    axes = ("data", "stage", "model")[:len(shape)]
    mesh = make_test_mesh(shape, axes, group=group)
    strategy = choose_strategy(mesh, pipeline_stages=2, trunk_layers=2)
    return build_train_step(build(_cnn_cfg()), scfg, M, constant(LR), device="cpu",
                            group=group, mesh=mesh, strategy=strategy)


def _run(built, batches, params=None, rows=None):
    """The steps from ``init(0)``; with a ``rows`` list, each step under the
    wire log, its rows appended."""
    state = built.init(0, params=params)
    hist = []
    for b in batches:
        with collectives.wire_log() if rows is not None else contextlib.nullcontext() as got:
            state, m = built.step(state, b)
        if rows is not None:
            rows.extend(got)
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist


# ---------------------------------------------------------------------------
# (ii) the schedule
# ---------------------------------------------------------------------------

def _toy(n_layers=4, b=8, d_in=5, d=6, d_out=3, seed=2):
    rng = np.random.default_rng(seed)
    params = {"w_in": rng.normal(size=(d_in, d)).astype(np.float32) * 0.4,
              "trunk": rng.normal(size=(n_layers, d, d)).astype(np.float32) * 0.3,
              "w_out": rng.normal(size=(d, d_out)).astype(np.float32) * 0.4}
    batch = {"x": rng.normal(size=(b, d_in)).astype(np.float32),
             "y": rng.normal(size=(b, d_out)).astype(np.float32)}
    jdef = JaxPipelineDef(n_layers, ("trunk",), lambda p, bt: bt["x"] @ p["w_in"],
                          lambda w, h: jnp.tanh(h @ w),
                          lambda p, h, bt: jnp.mean((h @ p["w_out"] - bt["y"]) ** 2))
    tdef = PipelineDef(n_layers, ("trunk",), lambda p, bt: bt["x"] @ p["w_in"],
                       lambda w, h: torch.tanh(h @ w),
                       lambda p, h, bt: torch.mean((h @ p["w_out"] - bt["y"]) ** 2))
    return params, batch, jdef, tdef


def _check_engines():
    params, batch, jdef, tdef = _toy()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tbatch = {k: torch.from_numpy(v)[None] for k, v in batch.items()}   # one worker
    for S in (2, 4):
        mesh = repro.compat.make_mesh((S,), ("stage",), devices=jax.devices()[:S])
        got = {}
        for engine in ("1f1b", "gpipe"):
            sm = jax.shard_map(
                jax_build_pipelined_vag(jdef, axis="stage", engine=engine), mesh=mesh,
                in_specs=({"w_in": JP(), "trunk": JP("stage"), "w_out": JP()}, JP()),
                out_specs=(JP(), {"w_in": JP(), "trunk": JP(), "w_out": JP()}),
                axis_names={"stage"}, check_vma=False)
            lj, gj = jax.jit(sm)(jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, batch))
            lt, gt = build_pipelined_vag(tdef, StageAxis(S), engine=engine)(
                tparams, tbatch, False)
            np.testing.assert_allclose(float(lt[0]), float(lj), rtol=1e-6)
            for k in params:
                np.testing.assert_allclose(gt[k][0].numpy(), np.asarray(gj[k]), rtol=1e-4,
                                           atol=1e-6, err_msg=(S, engine, k))
            got[engine] = (lt, gt)
        assert torch.equal(got["1f1b"][0], got["gpipe"][0])
        for k in params:
            np.testing.assert_allclose(got["1f1b"][1][k].numpy(), got["gpipe"][1][k].numpy(),
                                       rtol=0, atol=1e-7)
        # the GPipe forward alone, differentiated by autograd where the
        # stages are in this process: GPipe's hand-written backward
        gl, ll = torch.func.grad_and_value(build_pipelined_loss(tdef, StageAxis(S)))(
            tparams, {k: v[0] for k, v in tbatch.items()})
        assert float(ll) == float(got["gpipe"][0][0])
        for k in params:
            np.testing.assert_allclose(gl[k].numpy(), got["gpipe"][1][k][0].numpy(), rtol=0,
                                       atol=1e-7)
    with pytest.raises(ValueError, match="unknown pipeline engine"):
        build_pipelined_vag(tdef, StageAxis(2), engine="interleaved2")


def _check_cnn_gradients():
    """The CNN's PipelineDef: per-worker 1F1B / GPipe gradients (payload
    and fallback forms) against the unpipelined per-worker gradients."""
    from repro_torch.core.sasg import per_worker_grad_fn

    model = build(_cnn_cfg())
    assert model.pipeline.n_layers == 2 and model.pipeline.trunk_path == ("trunk",)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    b = _batches(1)[0]
    batch = {"x": torch.from_numpy(b["x"]).reshape(M, 4, 32, 32, 3),
             "labels": torch.from_numpy(b["labels"]).long().reshape(M, 4)}
    l0, g0 = per_worker_grad_fn(model.loss_fn)(params, batch, False)
    for engine in ("1f1b", "gpipe"):
        for local in (False, True):
            lt, gt = build_pipelined_vag(model.pipeline, StageAxis(2), stage_local=local,
                                         engine=engine)(params, batch, False)
            np.testing.assert_allclose(lt.numpy(), l0.numpy(), rtol=1e-5)
            for a, w in zip(tree_leaves(gt), tree_leaves(g0)):
                assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _check_layout():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    ident = ActivationLayout()
    parts = ident.encode(torch.from_numpy(x))
    assert ident.is_identity and len(parts) == 1
    assert torch.equal(ident.decode(parts, x.shape, torch.float32), torch.from_numpy(x))
    for lay in (dict(k_ratio=0.25, block_size=8), RING,
                dict(wire_dtype="bfloat16", k_ratio=0.5, block_size=16)):
        tl, jl = ActivationLayout(**lay), JaxLayout(**lay)
        # ties and zeros inside blocks: lax.top_k keeps the lowest index first
        y = np.round(rng.normal(size=(2, 4, 200)), 1).astype(np.float32)
        y[0, 0, :40] = 0.0
        yt = torch.from_numpy(y)
        vt, it = tl.encode(yt, batch_dims=1)
        for w in range(2):
            vj, ij = jl.encode(jnp.asarray(y[w]))
            assert np.array_equal(vt[w].float().numpy(), np.asarray(vj, np.float32)), lay
            assert np.array_equal(it[w].long().numpy(), np.asarray(ij).astype(np.int64)), lay
            dj = np.asarray(jl.decode((vj, ij), y[w].shape, jnp.float32))
            dt = tl.decode((vt, it), y.shape, torch.float32, batch_dims=1)[w]
            assert np.array_equal(dt.numpy(), dj)
        elems = y[0].size
        wire = sum(p[0].numel() * p.element_size() * 8 for p in (vt, it))
        assert tl.payload_bits(elems) == bits_lib.activation_payload_bits(
            tl.wire_dtype, tl.k_ratio, tl.block_size, elems) == wire == jl.payload_bits(elems)
        zeros = tl.zero_parts(y.shape, "cpu", 1)
        assert [tuple(z.shape) for z in zeros] == [tuple(p.shape) for p in (vt, it)]


def _check_counts():
    for batch_size, requested in ((7, 4), (13, 8), (6, 4), (12, 8), (8, 4), (8, 0), (5, 1)):
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            nt = resolve_microbatches(batch_size, requested)
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            nj = jax_resolve(batch_size, requested)
        assert nt == nj and len(wt) == len(wj), (batch_size, requested)
        for a, b in zip(wt, wj):
            assert str(a.message) == str(b.message)
    for kw in (dict(stages=2, n_micro=2, act_elems=65536),
               dict(stages=4, n_micro=8, act_elems=1000, engine="1f1b", gather_bits=5.0,
                    hop_payload_bits=123.0, bcast_payload_bits=456.0),
               dict(stages=2, n_micro=3, act_elems=10, engine="1f1b", bits_per_elem=16)):
        t, j = CM.PipelineCommModel(**kw), JCM.PipelineCommModel(**kw)
        assert (t.ticks, t.ring_bits_per_step(), t.bits_per_step()) == \
            (j.ticks, j.ring_bits_per_step(), j.bits_per_step())


def test_schedule_matches_jax(one_thread):
    """The 1F1B and GPipe engines against the JAX engines at S = 2, 4; the
    CNN's pipelined gradients; the activation wire format against the JAX
    encode; the microbatch count's warnings; the traffic model."""
    _check_engines()
    _check_cnn_gradients()
    _check_layout()
    _check_counts()


# ---------------------------------------------------------------------------
# (iii) the pipelined SASG step
# ---------------------------------------------------------------------------

def _check_jax_step(batches):
    """The identity ring (1F1B) and the benched compressed ring against the
    JAX step on the same (2, 2) mesh from the same params."""
    jcfg = dataclasses.replace(jax_get_config("cnn_cifar"), d_model=16)
    jmodel = jax_build(jcfg)
    mesh = repro.compat.make_mesh((M, 2), ("data", "stage"), devices=jax.devices()[:2 * M])
    strategy = jax_choose_strategy(mesh, sasg_enabled=True, pipeline_stages=2,
                                   trunk_layers=jmodel.pipeline.n_layers)
    base = jax_sasg_config(k_ratio=0.05, max_delay=4)
    for name, jscfg in (("sasg", base), ("ring", dataclasses.replace(
            base, act_layout=JaxLayout(**RING), overlap=True))):
        jbuilt = jax_build_train_step(jmodel, jscfg, mesh, strategy, jax_constant(LR))
        tbuilt = _pipe_built(_port_configs()[name])
        assert (tbuilt.bits_paper, tbuilt.bits_wire) == (jbuilt.bits_paper, jbuilt.bits_wire)
        jstate = jbuilt.init(jax.random.PRNGKey(0))
        tstate = tbuilt.init(params=params_from_numpy(jax.tree.map(np.asarray,
                                                                   jstate.params)))
        for step, b in enumerate(batches):
            jstate, jm = jbuilt.jit_step(jstate, b)
            tstate, tm = tbuilt.step(tstate, b)
            for key in KEYS + ("pipe_ring_bits_step", "pipe_gather_bits_step",
                               "pipe_bits_step", "pipe_bits_total"):
                assert float(tm[key]) == float(jm[key]), (name, step, key)
            if name == "ring":
                assert float(tm["pipe_ring_bits_step"]) == RING_BITS
                assert float(tm["pipe_gather_bits_step"]) == GATHER_BITS
                if step:
                    # the lossy ring keeps the top |x| of each block: a
                    # gradient that differs in its last bits flips a
                    # near-tied pick, and the lossy forward carries the flip
                    # on; compared through the first step only
                    continue
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-6 if step == 0 else 1e-2)
            for a, w in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
                assert float(np.max(np.abs(a.numpy() - np.asarray(w)))) < 2e-2, (name, step)


def _check_against_flat(batches):
    cfgs = _port_configs()
    mesh = make_test_mesh((M,), ("data",))
    flat = {}
    for name in ("sasg", "qsgd"):
        built = build_train_step(build(_cnn_cfg()), cfgs[name], None, constant(LR),
                                 device="cpu", mesh=mesh, strategy=choose_strategy(mesh))
        flat[name] = _run(built, batches)
    runs = {}
    for name, scfg in cfgs.items():
        built = _pipe_built(scfg)
        assert built.strategy.pipelined and built.strategy.pipeline_stages == 2
        runs[name] = _run(built, batches)
        # the payload path exactly where the JAX package takes it
        assert (built.exchange.transport.stage is not None) == (name != "qsgd"), name
        state, hist = runs[name]
        want_state, want_hist = flat["qsgd" if name == "qsgd" else "sasg"]
        for h, w in zip(hist, want_hist):
            assert h["num_sent"] == w["num_sent"]
            assert h["pipe_bits_step"] == h["pipe_ring_bits_step"] + h["pipe_gather_bits_step"]
            assert "pipe_bits_step" not in w
        assert hist[-1]["rounds_total"] == want_hist[-1]["rounds_total"]
        if name in ("sasg", "gpipe", "qsgd"):   # the dense ring: flat_pipe_check's tier
            for a, w in zip(tree_leaves(state.params), tree_leaves(want_state.params)):
                assert float((a - w).abs().max()) < 2e-2, name
    assert runs["gpipe"][1][0]["pipe_ring_bits_step"] == GPIPE_RING_BITS
    assert runs["ring"][1][0]["pipe_ring_bits_step"] == RING_BITS


def _check_stage_local_encode():
    """Stage-local encode == flat encode, bitwise: per_shard topk_ef on each
    stage's trunk slice (the as-if-full kb), gathered; qsgd after the dense
    stage combine, with the same draws."""
    model = build(_cnn_cfg())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(3)
    g = tree_map(lambda p: torch.randn((M,) + tuple(p.shape), generator=gen), params)
    paths, leaves, _ = tree_flatten_with_paths(g)
    stage = StageAxis(2)
    trunk = {p: x.shape[1] for p, x in zip(paths, leaves) if p.startswith("trunk/")}

    def slices(s):
        """Stage s's gradient tree: its trunk slice (contiguous, as a rank
        holds it) and the rest whole."""
        return {**g, "trunk": tree_map(lambda x: x[:, s:s + 1].contiguous(), g["trunk"])}

    for impl in ("kernel", "reference"):
        cfg = CompressorConfig(name="topk_ef", k_ratio=0.05, topk_impl=impl)
        flat_t = Transport(cfg, M)
        stage_t = Transport(cfg, M, stage=StageInfo(stage, ("trunk",), trunk))
        e0 = flat_t.init_state(g)
        want, want_e = flat_t.encode(e0, g)
        per = [stage_t.encode(stage_t.init_state(slices(s)), slices(s)) for s in (0, 1)]
        pp = [tree_leaves(p, is_leaf=collectives._is_payload) for p, _ in per]
        wpaths, wl, _ = tree_flatten_with_paths(want, is_leaf=collectives._is_payload)
        for i, path in enumerate(wpaths):
            if path.startswith("trunk/"):
                got = collectives.gather_block_payload([pp[0][i], pp[1][i]], stage, 1)
            else:
                got = pp[0][i]
            assert torch.equal(got.values, wl[i].values) and \
                torch.equal(got.indices, wl[i].indices), path
            assert got.orig_shape == wl[i].orig_shape, path
        for path, e in zip(*tree_flatten_with_paths(want_e)[:2]):
            parts = [dict(zip(*tree_flatten_with_paths(c)[:2]))[path] for _, c in per]
            got = torch.cat(parts, 1) if path.startswith("trunk/") else parts[0]
            assert torch.equal(got, e), path

    cfg = CompressorConfig(name="qsgd")
    masked = [g, tree_map(torch.zeros_like, g)]
    masked = [{**m, "trunk": tree_map(lambda x, s=s: x[:, s:s + 1], g["trunk"])}
              for s, m in enumerate(masked)]
    combined = build_stage_combine(model.pipeline, stage)(masked)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(combined), leaves))
    t = Transport(cfg, M)
    a, _ = t.encode((), combined, torch.Generator().manual_seed(5))
    b, _ = t.encode((), g, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_pipelined_sasg_step_matches_jax(one_thread):
    """The benched layout against the JAX step on a (2, 2) data x stage
    mesh; the port's pipelined steps (1F1B identity / compressed ring,
    GPipe, the qsgd fallback) against its flat step;
    stage-local encode == flat encode."""
    batches = _batches(STEPS)
    _check_jax_step(batches)
    _check_against_flat(batches)
    _check_stage_local_encode()


# ---------------------------------------------------------------------------
# (iv) two gloo ranks, one stage each
# ---------------------------------------------------------------------------

RANK_CONFIGS = ("sasg", "ring", "gpipe", "qsgd")


def _flat_state(built, state):
    full = built.gather_state(state)
    paths, leaves, _ = tree_flatten_with_paths((full.params, full.wstate))
    return {p: x.detach().numpy().copy() for p, x in zip(paths, leaves)}


def _stage_rank(group, ckpt_dir):
    torch.set_num_threads(1)
    out = {}
    for name in RANK_CONFIGS:
        built = _pipe_built(_port_configs()[name], group=group, shape=(1, 2))
        trunk = built.init(0).params["trunk"]
        local = {k: tuple(v.to_local().shape) for k, v in trunk.items()
                 if hasattr(v, "to_local")}
        rows = []
        state, hist = _run(built, _batches(STEPS), rows=rows)
        out[name] = {"hist": hist, "state": _flat_state(built, state), "local": local,
                     "rows": rows}
    built = _pipe_built(_port_configs()["sasg"], group=group, shape=(1, 2))
    from repro_torch.launch.train import data_stream

    trainer = Trainer(built, data_stream(_cnn_cfg(), 2 * M),
                      TrainerConfig(total_steps=2, ckpt_dir=ckpt_dir, ckpt_every=2),
                      log_fn=lambda m: None)
    state = trainer.run(seed=0)
    out["ckpt"] = _flat_state(built, state)
    return out


def _stage_tp_rank(group):
    """A rank of a (1, 2, 2) data x stage x model mesh: its TP shard of its
    stage's trunk slice."""
    torch.set_num_threads(1)
    built = _pipe_built(_port_configs()["sasg"], group=group, shape=(1, 2, 2))
    state, hist = _run(built, _batches(2))
    return {"hist": hist, "state": _flat_state(built, state)}


def test_two_gloo_stage_ranks_equal_the_stacked_run(one_thread, tmp_path):
    """A (1, 2) data x stage device mesh of 2 gloo ranks, each holding its
    stage's trunk slice, against the same mesh stacked in one process:
    sends, counters, params and worker state bitwise for 1F1B (identity
    and compressed ring), GPipe and the qsgd fallback; the same for a (1,
    2, 2) data x stage x model mesh of 4 ranks (SASG); a 2-stage
    checkpoint restores into a flat run (``data`` 2 mesh, equal
    membership) with the worker state carried bitwise."""
    ckpt = str(tmp_path / "ck")
    ranks = process_group.spawn(_stage_rank, 2, "gloo", "cpu", args=(ckpt,),
                                join_timeout_s=JOIN_S)
    for name in RANK_CONFIGS:
        built = _pipe_built(_port_configs()[name], shape=(1, 2))
        rows = []
        state, hist = _run(built, _batches(STEPS), rows=rows)
        want = _flat_state(built, state)
        # the wire log: the ring, the stage gathers and sums, the same rows
        # stacked and on the ranks, apart from what each rank handed gloo
        ops = {r["op"] for r in rows}
        assert {"ring_shift_parts", "ring_broadcast_parts"} <= ops, (name, ops)
        assert ({"gather_block_payload", "psum_tree"} if name != "qsgd"
                else {"stage_combine_leaf"}) <= ops, (name, ops)
        assert all(r["axes"] == ["stage"] and r["moved_bytes"] == 0 for r in rows)
        for r in ranks:
            got = r[name]
            assert got["hist"] == hist, name
            assert got["state"].keys() == want.keys()
            for p, w in want.items():
                assert got["state"][p].tobytes() == w.tobytes(), (name, p)
            assert got["local"] and all(s[0] == 1 for s in got["local"].values())
            assert [dict(x, moved_bytes=0) for x in got["rows"]] == rows, name
            assert all(x["moved_bytes"] > 0 for x in got["rows"]), name

    # stages with a model axis: 4 ranks, each its TP shard of its stage's slice
    tp_ranks = process_group.spawn(_stage_tp_rank, 4, "gloo", "cpu", join_timeout_s=JOIN_S)
    built = _pipe_built(_port_configs()["sasg"], shape=(1, 2, 2))
    state, hist = _run(built, _batches(2))
    want = _flat_state(built, state)
    for r in tp_ranks:
        assert r["hist"] == hist
        assert all(r["state"][p].tobytes() == w.tobytes() for p, w in want.items())

    from repro_torch.launch.train import data_stream

    mesh = make_test_mesh((M,), ("data",))
    flat = build_train_step(build(_cnn_cfg()), _port_configs()["sasg"], None, constant(LR),
                            device="cpu", mesh=mesh, strategy=choose_strategy(mesh))
    logs = []
    trainer = Trainer(flat, data_stream(_cnn_cfg(), 2 * M),
                      TrainerConfig(total_steps=4, ckpt_dir=ckpt), log_fn=logs.append)
    state, step = trainer._restore_latest(flat.init(0))
    assert step == 2 and not any("changed" in m for m in logs), logs
    got = _flat_state(flat, state)
    want = ranks[0]["ckpt"]
    assert got.keys() == want.keys()
    for p, w in want.items():
        assert got[p].tobytes() == w.tobytes(), p
