"""Checkpoints, restore-and-continue, the data loader and the launcher's
flags of the port.

- Checkpoints across packages: a tree saved by ``repro.train.checkpoint``
  restores through the port bitwise, and the reverse (bf16 leaves too,
  which the port writes as float32); both write the same manifest.
- Recovery on the CPU (fc_mnist, four workers): a run whose step 7 fails
  once, checkpointing every 4 steps asynchronously, ends bitwise equal to
  an uninterrupted run (SASG through the top-k kernel's plain version,
  SASG with qsgd's seeded draws, SASG with ``fold_lr=False`` and
  momentum), having applied the same batches; a corrupt newest checkpoint
  falls back to an older one; a save that exhausts its retries is a
  ``ckpt_lost`` event, asynchronous or blocking; ``ckpt_keep`` bounds the
  checkpoints kept and ``max_restarts`` the recoveries; a restore at
  another worker count re-initializes the worker state from the restored
  params; ``KernelLaunchError`` and ``KernelBuildError`` from the step end
  the run, once the save in flight is written, and so does a kernel
  wrapper's refusal of its inputs.
- ``data.ShardedLoader``: batches equal ``batch_at(step)``, a source error
  reaches the consumer, ``close()`` joins its thread.
- The launcher: ``--compressor``, ``--wire-dtype``, ``--k-ratio-per-layer``,
  ``--ckpt-dir`` and ``--ckpt-every`` parse as the JAX launcher parses them,
  errors included.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train as jax_train
from repro.data import replay as jax_replay
from repro.launch import train as jax_launch
from repro.train import checkpoint as jax_ckpt
from repro_torch.configs import get_config
from repro_torch.core.sasg import PRESETS
from repro_torch.core.types import tree_leaves
from repro_torch.data import ShardedLoader, batch_fingerprint, indexed_classification_stream
from repro_torch.data import synthetic_classification
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
from repro_torch.launch import train as launch
from repro_torch.models import build
from repro_torch.optim import constant, momentum
from repro_torch.train import Trainer, TrainerConfig, build_train_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import is_kernel_fault

M, LR, STEPS, EVERY, FAULT = 4, 0.1, 12, 4, 7


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
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"fc1": {"w": rng.normal(size=(20, 8)).astype(np.float32),
                    "b": rng.normal(size=(8,)).astype(np.float32)},
            "emb": rng.normal(size=(5, 4)).astype(np.float32),
            "step": np.asarray(3, np.int32)}


def test_jax_checkpoint_restores_through_the_port(tmp_path):
    host = _tree(np.random.default_rng(0))
    jtree = jax.tree.map(jnp.asarray, host)
    jtree["emb"] = jtree["emb"].astype(jnp.bfloat16)
    jax_ckpt.save(jtree, str(tmp_path), 5, meta={"num_workers": 4})
    template = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.float32), host)
    template["emb"] = template["emb"].bfloat16()
    template["step"] = torch.zeros((), dtype=torch.int32)
    assert ckpt.verify(str(tmp_path), 5) and ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.manifest_meta(str(tmp_path), 5) == {"num_workers": 4}
    got = ckpt.restore(template, str(tmp_path), 5)
    for path in (("fc1", "w"), ("fc1", "b")):
        assert np.array_equal(got[path[0]][path[1]].numpy(), host[path[0]][path[1]])
    assert got["emb"].dtype == torch.bfloat16
    assert np.array_equal(got["emb"].float().numpy(),
                          np.asarray(jtree["emb"].astype(jnp.float32)))
    assert int(got["step"]) == 3 and got["step"].dtype == torch.int32


def test_port_checkpoint_restores_through_jax(tmp_path):
    host = _tree(np.random.default_rng(1))
    ttree = jax.tree.map(torch.from_numpy, host)
    ttree["emb"] = ttree["emb"].bfloat16()
    ckpt.save(ttree, str(tmp_path / "t"), 2)
    jtree = jax.tree.map(jnp.asarray, host)
    jtree["emb"] = jtree["emb"].astype(jnp.bfloat16)
    jax_ckpt.save(jtree, str(tmp_path / "j"), 2)
    assert jax_ckpt.verify(str(tmp_path / "t"), 2)
    template = jax.tree.map(jnp.zeros_like, jtree)
    got = jax_ckpt.restore(template, str(tmp_path / "t"), 2)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))
    manifests = [json.load(open(tmp_path / d / "step_2" / "manifest.json")) for d in "tj"]
    assert [e["name"] for e in manifests[0]["leaves"]] == [e["name"] for e in
                                                            manifests[1]["leaves"]]
    assert manifests[0]["step"] == manifests[1]["step"] == 2


def test_save_is_atomic_and_gc_keeps_the_newest(tmp_path):
    tree = {"a": torch.arange(6.0)}
    for step in (1, 2, 3, 4):
        ckpt.save(tree, str(tmp_path), step, blocking=False).join()
    os.makedirs(tmp_path / "step_9.tmp")              # a write in flight
    os.makedirs(tmp_path / "step_8")                  # debris with no manifest
    assert ckpt.candidate_steps(str(tmp_path)) == [4, 3, 2, 1]
    ckpt.gc_old(str(tmp_path), keep=2)
    assert ckpt.candidate_steps(str(tmp_path)) == [4, 3]

    def failing(n):
        write, calls = ckpt._write, []

        def attempt(host, directory, step, meta):
            calls.append(step)
            if len(calls) <= n:
                os.makedirs(os.path.join(directory, f"step_{step}.tmp"), exist_ok=True)
                raise OSError(f"injected save failure (attempt {len(calls)})")
            write(host, directory, step, meta)

        return attempt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt, "_write", failing(9))
        with pytest.raises(ckpt.CheckpointSaveError):
            ckpt.save(tree, str(tmp_path), 5, backoff=0.001)
    assert 5 not in ckpt.candidate_steps(str(tmp_path))
    assert not os.path.exists(tmp_path / "step_5.tmp")          # debris removed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt, "_write", failing(1))
        ckpt.save(tree, str(tmp_path), 6, backoff=0.001)         # retried
    assert ckpt.verify(str(tmp_path), 6)


def test_save_copies_to_the_host_before_returning(tmp_path):
    """An asynchronous save holds the values of the call, whatever the
    caller does to its tensors after."""
    tree = {"a": torch.zeros(1000)}
    handle = ckpt.save(tree, str(tmp_path), 1, blocking=False)
    tree["a"].add_(1.0)
    handle.join()
    assert torch.equal(ckpt.restore({"a": torch.ones(1000)}, str(tmp_path), 1)["a"],
                       torch.zeros(1000))


# ---------------------------------------------------------------------------
# restore-and-continue
# ---------------------------------------------------------------------------

def _built(workers=M, compressor=None, optimizer=None):
    scfg = PRESETS["sasg"]()
    if compressor:
        scfg = dataclasses.replace(scfg, compressor=dataclasses.replace(scfg.compressor,
                                                                        name=compressor))
    if optimizer is not None:
        scfg = dataclasses.replace(scfg, fold_lr=False)
    return build_train_step(build(get_config("fc_mnist")), scfg, workers, constant(LR),
                            device="cpu", optimizer=optimizer)


def _stream(workers=M):
    xs, ys = synthetic_classification(256, 10, (28, 28, 1), seed=0)
    return indexed_classification_stream(xs, ys, 2 * workers, seed=0)


def _trainer(built, ckpt_dir=None, steps=STEPS, fault_hook=None, data=None):
    cfg = TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=EVERY,
                        log_every=100, record_batches=True)
    return Trainer(built, data if data is not None else _stream(built.num_workers), cfg,
                   fault_hook=fault_hook, log_fn=lambda m: None)


def _fail_once(at):
    hit = []

    def hook(step):
        if step == at and not hit:
            hit.append(step)
            raise RuntimeError("injected node failure")

    return hook


@pytest.mark.parametrize("variant", ["topk_ef", "qsgd", "momentum"])
def test_faulted_run_equals_uninterrupted(tmp_path, variant):
    def make():
        if variant == "momentum":
            return _built(optimizer=momentum(LR, 0.9))
        return _built(compressor=variant)

    clean = _trainer(make())
    want = clean.run(seed=3)
    faulted = _trainer(make(), str(tmp_path), fault_hook=_fail_once(FAULT))
    got = faulted.run(seed=3)
    assert _same(got, want)
    recoveries = [e for e in faulted.events if e["kind"] == "recovery"]
    assert len(recoveries) == 1 and len(faulted.events) == 1
    assert (recoveries[0]["failed_step"], recoveries[0]["restored_step"]) == (FAULT, EVERY)
    assert dict(faulted.batch_log) == dict(clean.batch_log)
    assert len(faulted.batch_log) == STEPS + FAULT - EVERY       # steps 4..6 replayed
    assert ckpt.candidate_steps(str(tmp_path)) == [12, 8, 4]


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    want = _trainer(_built()).run()
    _trainer(_built(), str(tmp_path), steps=8).run()
    assert ckpt.candidate_steps(str(tmp_path)) == [8, 4]
    victim = tmp_path / "step_8" / "00003.npy"
    victim.write_bytes(victim.read_bytes()[:40])
    assert not ckpt.verify(str(tmp_path), 8)
    resumed = _trainer(_built(), str(tmp_path))
    assert _same(resumed.run(), want)
    assert min(s for s, _ in resumed.batch_log) == EVERY      # went on from step 4


def _lose_save_of(monkeypatch, lost_step):
    """Every write attempt of checkpoint ``lost_step`` fails."""
    write = ckpt._write

    def attempt(host, directory, step, meta):
        if step == lost_step:
            raise OSError("injected save failure")
        write(host, directory, step, meta)

    monkeypatch.setattr(ckpt, "_write", attempt)


def test_exhausted_save_is_a_lost_checkpoint(tmp_path, monkeypatch):
    _lose_save_of(monkeypatch, EVERY)
    trainer = _trainer(_built(), str(tmp_path), steps=8)
    trainer.run()
    assert [e["kind"] for e in trainer.events] == ["ckpt_lost"]
    assert trainer.events[0]["step"] == EVERY
    assert ckpt.candidate_steps(str(tmp_path)) == [8]


def test_exhausted_blocking_save_is_a_lost_checkpoint(tmp_path, monkeypatch):
    """``ckpt_async=False``: the save is written before the next step, and
    one that exhausts its retries is lost the same way."""
    _lose_save_of(monkeypatch, EVERY)
    trainer = _trainer(_built(), str(tmp_path), steps=8)
    trainer.cfg.ckpt_async = False
    state = trainer.run()
    assert trainer._save_handle is None
    assert [e["kind"] for e in trainer.events] == ["ckpt_lost"]
    assert trainer.events[0]["step"] == EVERY
    assert ckpt.candidate_steps(str(tmp_path)) == [8]
    assert _same(ckpt.restore(state, str(tmp_path), 8), state)


def test_ckpt_keep_and_max_restarts(tmp_path):
    """``ckpt_keep`` checkpoints are kept; a step that fails once more than
    ``max_restarts`` allows ends the run with its error."""
    trainer = _trainer(_built(), str(tmp_path))
    trainer.cfg.ckpt_keep = 1
    trainer.cfg.ckpt_async = False     # each save committed before its gc
    trainer.run()
    assert ckpt.candidate_steps(str(tmp_path)) == [STEPS]

    def always(step):
        if step == FAULT:
            raise RuntimeError("injected node failure")

    trainer = _trainer(_built(), str(tmp_path / "r"), fault_hook=always)
    trainer.cfg.max_restarts = 2
    with pytest.raises(RuntimeError, match="injected"):
        trainer.run()
    recoveries = [e for e in trainer.events if e["kind"] == "recovery"]
    assert [(e["failed_step"], e["restored_step"]) for e in recoveries] == [(FAULT, EVERY)] * 2


def test_restore_at_another_worker_count_reinitializes_worker_state(tmp_path):
    first = _trainer(_built(), str(tmp_path), steps=EVERY)
    saved = first.run()
    built2 = _built(workers=2)
    state, step = _trainer(built2, str(tmp_path))._restore_latest(built2.init(0))
    assert step == EVERY
    assert _same(state.params, saved.params)
    assert _same(state.counters, saved.counters)
    assert _same(state.wstate, built2.exchange.init_worker(state.params))
    assert state.wstate.tau.shape == (2,)


@pytest.mark.parametrize("error", [KernelLaunchError, KernelBuildError])
def test_kernel_fault_ends_the_run(tmp_path, error):
    built = _built()

    def step(state, batch, force_skip=None):
        if int(state.gstate.step) == 2:
            raise error("injected kernel fault")
        return built.step(state, batch, force_skip)

    trainer = _trainer(built._replace(step=step), str(tmp_path))
    trainer.cfg.ckpt_every = 1          # the step-2 save is in flight at the fault
    with pytest.raises(error, match="injected"):
        trainer.run()
    assert trainer.events == [] and len(trainer.history) == 2
    # the run waited for its writer before raising: nothing half written
    assert trainer._save_handle is None and sorted(os.listdir(tmp_path)) == ["step_1", "step_2"]


def test_kernel_wrapper_refusal_ends_the_run(tmp_path):
    """A wrapper that refuses its inputs raises a ValueError; the loop ends
    the run with it rather than replay a deterministic refusal."""
    from repro_torch.kernels.topk_ef.topk_ef import check_rows

    built = _built()

    def step(state, batch, force_skip=None):
        if int(state.gstate.step) == 1:
            check_rows("topk_ef_group", torch.zeros(4, 8), 1)
        return built.step(state, batch, force_skip)

    trainer = _trainer(built._replace(step=step), str(tmp_path))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        trainer.run()
    assert trainer.events == [] and len(trainer.history) == 1


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # the error as the loop would catch it
        return e
    raise AssertionError(f"{fn.__name__} did not raise")


def _refuse(x):
    raise ValueError(f"bad input {x}")


def test_which_errors_are_kernel_faults():
    from repro_torch.kernels.topk_ef.topk_ef import check_rows

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert is_kernel_fault(KernelLaunchError("x"), cpu)
    assert is_kernel_fault(RuntimeError("CUDA error: an illegal memory access"), cuda)
    assert not is_kernel_fault(RuntimeError("CUDA error: an illegal memory access"), cpu)
    assert not is_kernel_fault(RuntimeError("injected node failure"), cuda)
    assert not is_kernel_fault(OSError("disk"), cuda)
    # a kernel wrapper's refusal of its inputs: any error raised in the kernels
    refused = _raised(check_rows, "x", torch.zeros(4, 8), 1)              # not on cuda
    assert isinstance(refused, ValueError)
    assert is_kernel_fault(refused, cpu) and is_kernel_fault(refused, cuda)
    assert not is_kernel_fault(_raised(_refuse, 1), cuda)      # raised outside the kernels
    # cuDNN and cuBLAS report without naming CUDA
    assert is_kernel_fault(RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED"), cuda)
    assert is_kernel_fault(RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling "
                                        "`cublasSgemm( handle, ...)`"), cuda)
    assert not is_kernel_fault(RuntimeError("cuDNN error: CUDNN_STATUS_NOT_SUPPORTED"), cpu)


# ---------------------------------------------------------------------------
# data: replay and the loader
# ---------------------------------------------------------------------------

def test_replay_cursor_and_fingerprint_match_jax():
    xs, ys = synthetic_classification(64, 10, (4, 4, 1), seed=0)
    ours, theirs = (indexed_classification_stream(xs, ys, 8, seed=1),
                    jax_replay.indexed_classification_stream(xs, ys, 8, seed=1))
    for s in (ours, theirs):
        next(s), next(s)
        s.seek(5)
    assert ours.cursor == theirs.cursor == 5
    a, b = next(ours), next(theirs)
    assert batch_fingerprint(a) == jax_replay.batch_fingerprint(b)
    assert batch_fingerprint({k: torch.from_numpy(v) for k, v in a.items()}) == \
        batch_fingerprint(a)
    with pytest.raises(ValueError):
        ours.seek(-1)


def test_loader_feeds_the_batches_of_the_stream():
    stream = _stream()
    with ShardedLoader(stream, device="cpu", prefetch=2) as loader:
        for step in range(6):
            got = next(loader)
            want = stream.batch_at(step)
            assert set(got) == set(want)
            for k in want:
                assert isinstance(got[k], torch.Tensor)
                assert np.array_equal(got[k].numpy(), want[k])


def test_loader_hands_a_source_error_to_the_consumer_and_ends():
    def source():
        yield {"x": np.zeros(3, np.float32)}
        raise OSError("disk gone")

    loader = ShardedLoader(source(), device="cpu")
    next(loader)
    with pytest.raises(OSError, match="disk gone"):
        next(loader)
    loader.close()
    done = ShardedLoader(iter([{"x": np.ones(2, np.float32)}]), device="cpu")
    next(done)
    with pytest.raises(StopIteration):
        next(done)
    done.close()


def test_loader_close_joins_a_blocked_thread():
    def endless():
        while True:
            yield {"x": np.zeros(4, np.float32)}

    loader = ShardedLoader(endless(), device="cpu", prefetch=1)
    threading.Event().wait(0.3)          # the queue fills; the thread blocks in put
    loader.close(timeout=5.0)
    assert not loader._thread.is_alive()


def test_loader_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedLoader(iter([]))


def test_trainer_runs_from_the_loader():
    want = _trainer(_built()).run()
    with ShardedLoader(_stream(), device="cpu") as loader:
        assert _same(_trainer(_built(), data=loader).run(), want)


# ---------------------------------------------------------------------------
# the launcher's flags
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _jax_parse(argv, monkeypatch):
    """What the JAX launcher builds from ``argv``: its SASG config and
    TrainerConfig, caught before it trains."""
    seen = {}

    def fake_build(model, scfg, *a, **kw):
        seen["scfg"] = scfg
        return type("Built", (), {"exchange": None})()

    class FakeTrainer:
        def __init__(self, built, stream, tcfg, **kw):
            seen["tcfg"] = tcfg
            raise _Stop

    monkeypatch.setattr(jax_train, "build_train_step", fake_build)
    monkeypatch.setattr(jax_train, "Trainer", FakeTrainer)
    with pytest.raises(_Stop):
        jax_launch.main(["--arch", "fc_mnist", "--mesh-shape", "1,1", *argv])
    return seen


@pytest.mark.parametrize("argv", [
    [],
    ["--algo", "sparse", "--compressor", "qsgd", "--wire-dtype", "bfloat16"],
    ["--compressor", "randk", "--k-ratio-per-layer", "fc1=0.05,fc2=0.1",
     "--ckpt-dir", "/ck", "--ckpt-every", "7"],
    ["--algo", "lasg", "--compressor", "signsgd_ef", "--ckpt-every", "3"],
])
def test_launcher_flags_parse_as_in_jax(argv, monkeypatch):
    seen = _jax_parse(argv, monkeypatch)
    args = launch.parse_args(["--arch", "fc_mnist", *argv])
    ours = dataclasses.asdict(launch.sasg_config_from_args(args).compressor)
    theirs = dataclasses.asdict(seen["scfg"].compressor)
    assert ours == {k: theirs[k] for k in ours}
    assert (args.ckpt_dir, args.ckpt_every) == (seen["tcfg"].ckpt_dir, seen["tcfg"].ckpt_every)


@pytest.mark.parametrize("spec", ["fc1", "=0.1", "fc1=abc", "fc1=0.1,fc2"])
def test_launcher_rejects_a_bad_schedule_as_jax_does(spec, monkeypatch, capsys):
    with pytest.raises(SystemExit) as ours:
        launch.parse_args(["--k-ratio-per-layer", spec])
    our_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as theirs:
        _jax_parse(["--k-ratio-per-layer", spec], monkeypatch)
    their_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert ours.value.code == theirs.value.code == 2
    assert our_err == their_err
