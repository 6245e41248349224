"""The port's elastic worker membership and chaos harness, against the JAX
package's, in ONE test item.

One item, not one per group: the suite runs under pytest-xdist's ``--dist
load`` on 6 workers, whose first chunk is ``N // 24`` items. From N = 816
that chunk hands one worker all of collection items 170-203, which hold
the reference's longest tests (``test_pipeline_sasg``,
``test_pipeline_bench``: ~1,100 s), and the run is cut at its limit
(ROADMAP "Test budget"; ``tools/xdist_schedule.py``). This item keeps N at
815.

fc_mnist, k 0.1, lr 0.05, 4 workers (the JAX package's on 4 of 8 fake CPU
devices, the port's stacked), 12 steps, a checkpoint every 4, data seed
3. Five groups of checks:

- Parity: one plan through both ``ElasticTrainer``s from the same params
  (JAX ``PRNGKey(7)``, carried by ``params_from_numpy``): 4 -> 2 at step 3,
  a straggler with no ``indices`` at 5, a save failure armed at 6, a crash
  at 9 whose restore point (step 8) comes after the shrink, 2 -> 4 at 10;
  under SASG and under the sparse preset (no selection: the cold-started
  worker state sends payloads). Events (kinds, steps, from/to, the drawn
  straggler, restored step, steps lost), ``batch_log`` and every step's
  ``num_sent`` exact; counters within rtol 1e-6 (float32 accumulation),
  the loss within rtol 1e-4, the tiers of ``test_torch_train_step.py``.
- The contract over the reference: with ``worker_drop(6, to=2).crash(7)``
  the restore point (step 4) comes before the shrink. The port rebuilds
  at the checkpoint's 4 workers and ends bitwise its own run without the
  crash. The JAX ``ElasticTrainer`` replays steps 4-5 at 2 workers; its gap
  is printed, not asserted (ROADMAP queue 3).
- The chaos matrix, as ``tests/test_chaos.py`` holds the JAX package's
  (port seed 7): the recovery faults (crash, data hiccup, save failures,
  corruption) end bitwise the uninterrupted run; the straggler and the
  resize are deterministic (the same plan twice, bitwise) and engaged;
  a composed plan recovers twice, deterministically; every run applies at
  each step the batch the uninterrupted run applied there. The in-run
  4 -> 2 -> 4 resize equals restart elasticity (three Trainers sharing a
  checkpoint directory) bitwise, as ``tests/test_elastic.py:134`` holds;
  ``remap_state`` carries or cold-starts exactly; an injected
  ``KernelLaunchError`` ends an elastic run; ``corrupt_checkpoint`` of
  either package fails the other's ``verify``.
- Workers as processes: 2 gloo ranks run fc_mnist through the launcher
  with M 4 -> 2 -> 4 and a straggler, bitwise the same command stacked in
  one process; a crash in a multi-process plan is refused when the
  trainer is built.
- The launcher and the benches: ``--resize`` / ``--faults`` build the JAX
  launcher's plan and are refused as it refuses them, with its messages;
  ``run.py --elastic --smoke`` and ``--compressors --smoke`` on the CPU,
  the sweep's bits per upload equal to ``repro/comm/bits.py``'s for the
  same templates (no JAX step is compiled).
"""
import contextlib
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.train as jax_train
from repro.comm import bits as jax_bits
from repro.configs import get_config as jax_get_config
from repro.core import CompressorConfig as JaxCompressorConfig
from repro.core import PRESETS as JAX_PRESETS
from repro.data import indexed_classification_stream as jax_stream
from repro.data.synthetic import synthetic_classification as jax_synthetic
from repro.launch import train as jax_launch
from repro.models import build as jax_build
from repro.optim import constant as jax_constant
from repro.train import checkpoint as jax_ckpt
from repro_torch.benchmarks import compressor_bench
from repro_torch.benchmarks import run as bench_run
from repro_torch.comm import process_group
from repro_torch.configs import get_config
from repro_torch.core.sasg import PRESETS
from repro_torch.core.types import path_str, tree_flatten_with_paths, tree_leaves
from repro_torch.data import indexed_classification_stream, synthetic_classification
from repro_torch.dist.strategy import choose_strategy
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build, params_from_numpy
from repro_torch.optim import constant
from repro_torch.train import Trainer, TrainerConfig, build_train_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import (ElasticTrainer, WorkerMembership, fresh_worker_state,
                                       remap_state)
from repro_torch.train.faults import FaultPlan, corrupt_checkpoint

TOTAL, EVERY, FAULT_STEP = 12, 4, 7
SEED_DATA, SEED_INIT = 3, 7
LR, K = 0.05, 0.1
MATRIX = FaultPlan.single_fault_matrix(step=FAULT_STEP, workers=4)
# recovery-replay classes: bitwise the uninterrupted run
BITEXACT = ("crash", "corrupt_ckpt", "save_fail_transient", "save_fail_lost", "data_hiccup")
EVENT_KEYS = ("kind", "step", "from", "to", "workers", "attempts", "victim", "failed_step",
              "restored_step", "steps_lost", "error")


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


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _silent(msg):
    pass


def _data():
    xs, ys = synthetic_classification(256, 10, (28, 28, 1), seed=0)
    return indexed_classification_stream(xs, ys, batch=8, seed=SEED_DATA)


def _jax_data():
    xs, ys = jax_synthetic(256, 10, (28, 28, 1), seed=0)
    return jax_stream(xs, ys, batch=8, seed=SEED_DATA)


def _tc(ckpt_dir, total=TOTAL):
    return TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=EVERY,
                         log_every=10**9, record_batches=True)


def _events(tr):
    return [tuple(e.get(k) for k in EVENT_KEYS) for e in tr.events]


def _replayed_exactly(tr, clean_tr):
    """Every step index applied, each with the uninterrupted run's batch
    (the log may hold a pre-failure prefix twice)."""
    assert dict(tr.batch_log) == dict(clean_tr.batch_log)
    assert sorted(dict(tr.batch_log)) == list(range(TOTAL))
    assert tr.batch_log[-1][0] == TOTAL - 1


class _Pair:
    """The two packages' membership for one preset, and the port's copy of
    the JAX run's initial params."""

    def __init__(self, preset):
        kw = {"k_ratio": K}
        self.jmem = jax_train.WorkerMembership(
            jax_build(jax_get_config("fc_mnist")), JAX_PRESETS[preset](**kw), jax_constant(LR),
            sasg_enabled=True)
        self.tmem = WorkerMembership(build(get_config("fc_mnist")), PRESETS[preset](**kw),
                                     constant(LR), device="cpu")
        jstate = self.jmem.build(4).init(jax.random.PRNGKey(SEED_INIT))
        self.params = jax.tree.map(np.asarray, jstate.params)

    def run_jax(self, ckpt_dir, plan):
        tr = jax_train.ElasticTrainer(self.jmem.build(4), _jax_data(), _tc(ckpt_dir),
                                      membership=self.jmem, plan=plan, log_fn=_silent)
        return tr, tr.run(init_key=jax.random.PRNGKey(SEED_INIT))

    def run_port(self, ckpt_dir, plan):
        built = self.tmem.build(4)
        tr = ElasticTrainer(built, _data(), _tc(ckpt_dir), membership=self.tmem, plan=plan,
                            log_fn=_silent)
        return tr, tr.run(state=built.init(params=params_from_numpy(self.params)))


def _parity_plan(plan_cls):
    return (plan_cls().worker_drop(3, to=2).straggler(5).save_fail(6, attempts=1)
            .crash(9).worker_join(10, to=4))


# ---------------------------------------------------------------------------
# the groups of checks
# ---------------------------------------------------------------------------

def _check_parity(pair, preset, root):
    jtr, _ = pair.run_jax(str(root / f"jax_{preset}"), _parity_plan(jax_train.FaultPlan))
    ttr, tstate = pair.run_port(str(root / f"port_{preset}"), _parity_plan(FaultPlan))
    assert _events(ttr) == _events(jtr), preset
    assert [e[0] for e in _events(ttr)] == ["resize", "straggler", "save_fail_armed", "crash",
                                            "recovery", "resize"]
    assert ttr.events[4]["restored_step"] == 2 * EVERY      # after the shrink
    assert ttr.batch_log == jtr.batch_log
    assert len(ttr.history) == len(jtr.history) == TOTAL + 1   # step 8 replayed
    for step, (t, j) in enumerate(zip(ttr.history, jtr.history)):
        assert t["num_sent"] == j["num_sent"], (preset, step, t, j)
        for key in ("rounds_total", "bits_paper_total", "bits_wire_total"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-6)
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    assert ttr.built.num_workers == 4 and tstate.wstate.tau.shape == (4,)
    sent = [h["num_sent"] for h in ttr.history]
    if preset == "sparse":   # the cold-started worker state sends every step
        assert sent[3:] == [2.0] * 8 + [4.0] * 2, sent   # steps 3-8, 8 again, 9; 10-11
        assert float(tstate.counters.rounds) == sum(sent[:8] + sent[9:])


def _check_contract(pair, root) -> float:
    """A restore point before a resize: the port ends bitwise its run
    without the crash. Returns the JAX package's gap (max abs)."""
    tr, state = pair.run_port(str(root / "crash"), FaultPlan().worker_drop(6, to=2).crash(7))
    clean_tr, clean = pair.run_port(str(root / "clean"), FaultPlan().worker_drop(6, to=2))
    rec = [e for e in tr.events if e["kind"] == "recovery"]
    assert [(e["restored_step"], e["steps_lost"]) for e in rec] == [(EVERY, 3)]
    # the replay of steps 4-5 ran at the checkpoint's 4 workers, then shrank again
    assert [(e["kind"], e["step"]) for e in tr.events if e["kind"] == "resize"] == [
        ("resize", 6), ("resize", 6)]
    assert _same(state, clean) and tr.batch_log[7:] == clean_tr.batch_log[EVERY:]
    replayed = tr.history[7:9]     # steps 4 and 5, after the failed step 7's attempt
    assert [h["num_sent"] for h in replayed] == [h["num_sent"] for h in clean_tr.history[4:6]]

    _, jstate = pair.run_jax(str(root / "jcrash"), jax_train.FaultPlan()
                             .worker_drop(6, to=2).crash(7))
    _, jclean = pair.run_jax(str(root / "jclean"), jax_train.FaultPlan().worker_drop(6, to=2))
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(jclean.params)))


def _check_chaos_matrix(mem, root):
    def run(name, plan=None):
        tr = ElasticTrainer(mem.build(4), _data(), _tc(str(root / name)), membership=mem,
                            plan=plan, log_fn=_silent)
        return tr, tr.run(seed=SEED_INIT)

    clean_tr, clean_state = run("clean")
    for name in BITEXACT:
        tr, state = run(name, MATRIX[name])
        recoveries = [e for e in tr.events if e["kind"] == "recovery"]
        assert len(recoveries) <= tr.cfg.max_restarts, name
        _replayed_exactly(tr, clean_tr)
        assert _same(state, clean_state), f"{name}: diverged from the clean run"
        kinds = [e["kind"] for e in tr.events]
        if name == "corrupt_ckpt":
            # the only checkpoint before the fault is corrupt: back to step 0
            assert kinds == ["corrupt_ckpt", "crash", "recovery"]
            assert tr.events[0]["victim"] == EVERY
            assert (recoveries[0]["failed_step"], recoveries[0]["restored_step"]) == (7, 0)
        if name in ("crash", "data_hiccup"):
            assert kinds == [name, "recovery"]
            assert (recoveries[0]["restored_step"], recoveries[0]["steps_lost"]) == (EVERY, 3)
        if name.startswith("save_fail"):
            assert kinds[0] == "save_fail_armed" and tr.events[0]["step"] == FAULT_STEP
            lost = [e for e in tr.events if e["kind"] == "ckpt_lost"]
            if name == "save_fail_lost":
                assert [e["step"] for e in lost] == [2 * EVERY]
            else:
                assert not lost and kinds == ["save_fail_armed"]

    for name in ("worker_drop", "straggler"):
        tr, state = run(name, MATRIX[name])
        _replayed_exactly(tr, clean_tr)
        tr2, state2 = run(name + "_replay", MATRIX[name])
        assert _same(state, state2), f"{name}: plan is not deterministic"
        assert tr.events == tr2.events and tr.history == tr2.history
        assert not _same(state.params, clean_state.params)
        if name == "worker_drop":
            assert [(e["kind"], e["step"], e["from"], e["to"]) for e in tr.events] == [
                ("resize", FAULT_STEP, 4, 2)]
            assert tr.built.num_workers == 2 and state.wstate.tau.shape == (2,)
        else:
            f = MATRIX[name].faults[0]
            hit = [e for e in tr.events if e["kind"] == "straggler"]
            assert [e["step"] for e in hit] == list(range(f.step, f.step + f.duration))
            # the drawn worker: default_rng((seed, fault index)), as in the JAX package
            want = int(np.random.default_rng((0, 0)).integers(4))
            assert all(e["workers"] == [want] for e in hit)
            for s in range(f.step, f.step + f.duration):
                assert tr.history[s]["num_sent"] < 4   # the skip path was forced

    # faults compose: a straggler window, a crash and a data hiccup
    plan = FaultPlan().straggler(5, indices=(1,), duration=2).crash(7).data_hiccup(9)
    tr, state = run("composed", plan)
    recoveries = [e for e in tr.events if e["kind"] == "recovery"]
    assert [(e["failed_step"], e["restored_step"]) for e in recoveries] == [(7, 4), (9, 8)]
    _replayed_exactly(tr, clean_tr)
    _, state2 = run("composed2", plan)
    assert _same(state, state2)
    return clean_tr, clean_state


def _check_resize_and_restart(mem, clean_tr, clean, root):
    """In-run 4 -> 2 -> 4 == restart elasticity; remap_state; the kernel
    fault rule under an ElasticTrainer; corrupt_checkpoint across the
    packages."""
    b4, b2 = mem.build(4), mem.build(2)
    plan = FaultPlan().worker_drop(EVERY, to=2).worker_join(2 * EVERY, to=4)
    tr_a = ElasticTrainer(b4, _data(), _tc(str(root / "inrun")), membership=mem, plan=plan,
                          log_fn=_silent)
    state_a = tr_a.run(seed=SEED_INIT)
    assert [e["kind"] for e in tr_a.events] == ["resize", "resize"]
    assert tr_a.built.num_workers == 4
    state_b = None
    for workers, upto in ((4, EVERY), (2, 2 * EVERY), (4, TOTAL)):
        tr_b = Trainer(mem.build(workers), _data(), _tc(str(root / "restart"), upto),
                       log_fn=_silent)
        state_b = tr_b.run(seed=SEED_INIT)
    assert _same(state_a, state_b)
    assert tr_a.batch_log == clean_tr.batch_log
    assert not _same(state_a.params, clean.params)   # the worker set changed the history

    # remap_state: an unchanged membership carries everything bitwise; a
    # resize carries params, counters, gstate and seed, and cold-starts the
    # worker state from the carried params
    assert b4.strategy.membership != b2.strategy.membership
    assert _same(remap_state(clean, b4, b4), clean)
    out = remap_state(clean, b2, b4)
    for name in ("params", "opt_state", "gstate", "counters", "seed"):
        assert _same(getattr(out, name), getattr(clean, name)), name
    assert out.wstate.tau.shape == (2,) and _same(out.wstate, fresh_worker_state(b2, out.params))
    mesh = make_test_mesh((4,), ("data",))
    plain = build_train_step(mem.model, PRESETS["sgd"](), None, constant(LR), device="cpu",
                             mesh=mesh, strategy=choose_strategy(mesh, sasg_enabled=False))
    to_plain = remap_state(clean, plain, b4)
    assert to_plain.wstate == () and to_plain.gstate == ()
    assert _same(to_plain.params, clean.params)
    back = remap_state(to_plain, b4, plain)     # plain -> SASG: a fresh global state
    assert _same(back.gstate, b4.exchange.init_global(torch.device("cpu")))
    assert _same(back.wstate, fresh_worker_state(b4, clean.params))

    # a kernel fault ends an elastic run: no recovery, whatever the plan
    def step(state, batch, force_skip=None):
        if int(state.gstate.step) == 2:
            raise KernelLaunchError("injected kernel fault")
        return b4.step(state, batch, force_skip)

    tr_k = ElasticTrainer(b4._replace(step=step), _data(), _tc(str(root / "kfault")),
                          membership=mem, plan=FaultPlan().straggler(1).crash(5),
                          log_fn=_silent)
    with pytest.raises(KernelLaunchError, match="injected"):
        tr_k.run(seed=SEED_INIT)
    assert [e["kind"] for e in tr_k.events] == ["straggler"] and len(tr_k.history) == 2

    # corrupt_checkpoint of either package fails the other's verify
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32)}
    jax_ckpt.save(tree, str(root / "j"), 3)
    ckpt.save({k: torch.from_numpy(v) for k, v in tree.items()}, str(root / "t"), 3)
    assert ckpt.verify(str(root / "j"), 3) and jax_ckpt.verify(str(root / "t"), 3)
    assert corrupt_checkpoint(str(root / "j")) == 3
    assert jax_train.corrupt_checkpoint(str(root / "t")) == 3
    assert not jax_ckpt.verify(str(root / "j"), 3) and not ckpt.verify(str(root / "j"), 3)
    assert not ckpt.verify(str(root / "t"), 3) and not jax_ckpt.verify(str(root / "t"), 3)


P = 2
ELASTIC_ARGV = ["--arch", "fc_mnist", "--algo", "sasg", "--workers", "4", "--global-batch",
                "8", "--steps", "10", "--lr", "0.3", "--device", "cpu",
                "--resize", "3:2,7:4", "--faults", "straggler@5"]


def _params(state) -> dict:
    paths, leaves, _ = tree_flatten_with_paths(state.params)
    return {path_str(p): x.numpy() for p, x in zip(paths, leaves)}


def _elastic_rank(group, argv):
    """This rank's elastic run of ``argv`` (through the launcher), and the
    refusal of a crash in the plan."""
    trainer = launch.build_trainer(launch.parse_args(argv), _silent, group)
    state = trainer.run(seed=0)
    try:
        launch.build_trainer(launch.parse_args(argv + ["--faults", "straggler@5,crash@6"]),
                             _silent, group)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"history": trainer.history, "events": trainer.events, "params": _params(state),
            "workers": trainer.built.num_workers, "refused": refused}


@contextlib.contextmanager
def _rank_threads():
    """The stacked reference on the threads of one spawned CPU rank
    (``process_group.spawn`` splits the cores): the CPU's matmul kernels
    block their sums by thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // P))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _check_gloo_ranks():
    ranks = process_group.spawn(_elastic_rank, P, "gloo", "cpu",
                                args=(ELASTIC_ARGV + ["--procs", str(P)],),
                                join_timeout_s=180.0)
    with _rank_threads():
        trainer, state = launch.train(ELASTIC_ARGV, log_fn=_silent)
    want = _params(state)
    kinds = [(e["kind"], e["step"]) for e in trainer.events]
    assert kinds == [("resize", 3), ("straggler", 5), ("resize", 7)]
    assert min(h["num_sent"] for h in trainer.history[3:7]) < 2   # the straggler skipped
    for r in ranks:
        assert r["events"] == trainer.events and r["workers"] == 4
        assert r["history"] == trainer.history     # sends, counters and losses
        for path, w in want.items():
            assert np.array_equal(r["params"][path].view(np.int32), w.view(np.int32)), path
        assert r["refused"] is not None and "crash" in r["refused"]


class _Stop(Exception):
    pass


def _jax_plan(argv, monkeypatch):
    """The FaultPlan the JAX launcher builds from ``argv`` (4 workers),
    caught before it trains."""
    seen = {}

    def fake_build(model, scfg, *a, **kw):
        return type("Built", (), {"exchange": None})()

    class FakeTrainer:
        def __init__(self, built, stream, tcfg, membership=None, plan=None, **kw):
            seen["plan"] = plan
            raise _Stop

    monkeypatch.setattr(jax_train, "build_train_step", fake_build)
    monkeypatch.setattr(jax_train, "ElasticTrainer", FakeTrainer)
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))  # the launcher sets it
    with pytest.raises(_Stop):
        jax_launch.main(["--arch", "fc_mnist", "--mesh-shape", "4,1", *argv])
    return seen["plan"]


def _check_launcher_and_benches(monkeypatch, capsys, root):
    argv = ["--resize", "4:2,8:4,9:8", "--faults", "straggler@5,crash@7,save_fail@2"]
    theirs = _jax_plan(argv, monkeypatch)
    ours = launch.fault_plan(launch.parse_args(["--arch", "fc_mnist", "--workers", "4", *argv]),
                             4)
    assert [dataclasses.astuple(f) for f in ours.faults] == [
        dataclasses.astuple(f) for f in theirs.faults]
    for bad in (["--resize", "4"], ["--faults", "crash"], ["--faults", "boom@3"],
                ["--faults", "crash@-1"], ["--faults", "worker_drop@3"]):
        with pytest.raises(SystemExit) as e_ours:
            launch.parse_args(bad)
        our_err = capsys.readouterr().err.strip().splitlines()[-1]
        with pytest.raises(SystemExit) as e_theirs:
            _jax_plan(bad, monkeypatch)
        their_err = capsys.readouterr().err.strip().splitlines()[-1]
        assert e_ours.value.code == e_theirs.value.code == 2 and our_err == their_err, bad
    with pytest.raises(ValueError, match="does not divide over 3 workers"):
        launch.build_trainer(launch.parse_args(
            ["--arch", "fc_mnist", "--workers", "4", "--global-batch", "8", "--device", "cpu",
             "--resize", "2:3"]), _silent)

    out = str(root / "bench")
    assert bench_run.main(["--elastic", "--smoke", "--device", "cpu", "--out-dir", out]) == 0
    with open(f"{out}/elastic.json") as f:
        cells = {c["plan"]: c for c in json.load(f)["cells"]}
    assert sorted(cells) == ["crash", "worker_drop"]
    assert cells["crash"]["bitexact_vs_clean"] and cells["crash"]["steps_lost"] == 3
    assert cells["worker_drop"]["resizes"] == 1
    assert all(c["replay_exact"] and not c["failures"] for c in cells.values())

    assert bench_run.main(["--compressors", "--smoke", "--device", "cpu", "--out-dir", out]) == 0
    with open(f"{out}/compressors.json") as f:
        record = json.load(f)["compressors"]
    cfg = dataclasses.replace(jax_get_config("cnn_cifar"), d_model=16)
    template = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
    assert sorted(record) == sorted(compressor_bench.sweep_configs())
    for name, comp in compressor_bench.sweep_configs().items():
        report = jax_bits.account(JaxCompressorConfig(**dataclasses.asdict(comp)), template)
        got = record[name]
        assert (got["bits_paper_per_upload"], got["bits_wire_per_upload"]) == (
            report.paper, report.wire), name
        assert got["buckets"] == report.rows(), name
        assert got["step_ms_flat"] > 0 and got["step_ms_pipelined"] > 0


def test_elastic_membership_and_chaos(tmp_path, monkeypatch, capsys):
    sasg = _Pair("sasg")
    for preset, pair in (("sasg", sasg), ("sparse", _Pair("sparse"))):
        _check_parity(pair, preset, tmp_path / "parity")
    gap = _check_contract(sasg, tmp_path / "contract")
    with capsys.disabled():
        print(f"\nthe JAX ElasticTrainer's run with worker_drop(6, to=2).crash(7) ends "
              f"{gap:.4g} (max abs) from its run without the crash; the port's ends bitwise")
    mem = WorkerMembership(build(get_config("fc_mnist")), PRESETS["sasg"](k_ratio=K),
                           constant(LR), device="cpu")
    clean_tr, clean = _check_chaos_matrix(mem, tmp_path / "chaos")
    _check_resize_and_restart(mem, clean_tr, clean, tmp_path / "resize")
    _check_gloo_ranks()
    _check_launcher_and_benches(monkeypatch, capsys, tmp_path)
