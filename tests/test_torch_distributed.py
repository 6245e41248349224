"""Workers as processes: the port's worker group against the stacked run.

Every test here runs on the CPU, with the ranks spawned by
``repro_torch.comm.process_group.spawn`` over gloo.

- The gathered exchange: 2 ranks, each holding 2 of 4 workers' payload
  slices, give bitwise the stacked exchange of the same payloads, for
  ``BlockPayload`` (top-k per shard), flat ``SparsePayload`` (top-k in the
  flat layout), dense (identity) and randk (per-tensor ``SparsePayload``).
- A whole run: 2 processes x 2 workers against 4 stacked workers, SASG, 6
  steps, on fc_mnist (through the launcher's ``build_trainer``, at an lr
  where workers skip) and on the d_model=16 CNN (through
  ``build_train_step``). Sends and
  counters exact on every rank; params bitwise where the per-worker
  gradients of 2 + 2 workers equal those of 4 (checked at the first step),
  else within ``test_torch_train_step.py``'s top-k tier, 2e-2.
- The command line: ``main()`` with ``--procs 2`` trains what its flags
  say on every rank.
- A step that fails on one rank ends the whole group: no rank restarts on
  its own.
- Process hygiene: concurrent runs get their own rendezvous, a failing
  rank's traceback reaches the caller, a hung rank is killed at the join
  timeout, and a collective waiting for a dead rank ends at the group's
  timeout. No process outlives a call.
- Refusals: NCCL with more ranks than cards, a cuda group without a card,
  workers that do not split over the processes, a device mesh whose size
  is not the process count.
"""
import contextlib
import dataclasses
import multiprocessing
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.comm import collectives, process_group
from repro_torch.comm.transport import build_transport
from repro_torch.configs import get_config
from repro_torch.core.compressors import CompressorConfig
from repro_torch.core.sasg import PRESETS, per_worker_grad_fn
from repro_torch.core.types import path_str, tree_flatten_with_paths, tree_leaves, tree_map
from repro_torch.launch import train as launch
from repro_torch.models import build
from repro_torch.optim import constant
from repro_torch.train import Trainer, TrainerConfig, build_train_step
from repro_torch.train.step import worker_batch

M, P, STEPS = 4, 2, 6
JOIN_S = 180.0
FC_ARGV = ["--arch", "fc_mnist", "--algo", "sasg", "--workers", str(M), "--global-batch",
           str(2 * M), "--steps", str(STEPS), "--lr", "0.3", "--device", "cpu"]
EXCHANGE_CASES = {
    "block": CompressorConfig(name="topk_ef", k_ratio=0.1, block_size=16),
    "flat": CompressorConfig(name="topk_ef", k_ratio=0.1, layout="flat", topk_impl="exact"),
    "dense": CompressorConfig(name="identity"),
    "randk": CompressorConfig(name="randk", k_ratio=0.1),
}


@contextlib.contextmanager
def _rank_threads():
    """The stacked reference runs on the threads of one spawned CPU rank
    (``process_group.spawn`` splits the cores): the CPU's matmul and
    convolution kernels block their sums by thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // P))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _spawn(fn, *args, nprocs=P, **kw):
    kw.setdefault("join_timeout_s", JOIN_S)
    return process_group.spawn(fn, nprocs, "gloo", "cpu", args=args, **kw)


def _payloads(name):
    """4 workers' payloads of a small tree (a matrix, a vector, a scalar
    leaf), encoded by the stacked transport from a seed."""
    gen = torch.Generator().manual_seed(7)
    params = {"w": torch.zeros(12, 20), "b": torch.zeros(33), "s": torch.zeros(1)}
    g = tree_map(lambda p: torch.randn((M,) + tuple(p.shape), generator=gen), params)
    t = build_transport(EXCHANGE_CASES[name], M)
    payload, _ = t.encode(t.init_state(g), g, torch.Generator().manual_seed(3))
    return t, params, payload


def _logged_exchange(t, payload):
    """``t.exchange(payload)`` under the wire log: (result, rows)."""
    with collectives.wire_log() as rows:
        out = t.exchange(payload)
    return out, rows


def _exchange_rank(group):
    out = {}
    for name in EXCHANGE_CASES:
        full_t, params, payload = _payloads(name)
        t = build_transport(EXCHANGE_CASES[name], M, group)
        start, n = group.workers(M)
        mine = tree_map(lambda x: x[start:start + n], payload)
        got, rows = _logged_exchange(t, mine)
        out[name] = {k: v.numpy() for k, v in t.densify(got, params).items()}
        out[name + "/rows"] = rows
    out["num_sent"] = float(collectives.psum_scalar(torch.tensor(group.rank + 1.0), group))
    return out


def _train_rank(group, argv):
    """This rank's share of the launcher's training of ``argv``: per-step
    metrics, final params, its workers' staleness counters and its top-k
    kernel launches."""
    from repro_torch.kernels.topk_ef import topk_ef

    trainer = launch.build_trainer(launch.parse_args(argv), lambda m: None, group)
    state = trainer.run(seed=0)
    paths, leaves, _ = tree_flatten_with_paths(state.params)
    return {"rank": group.rank, "history": trainer.history,
            "params": {path_str(p): x.numpy() for p, x in zip(paths, leaves)},
            "tau": state.wstate.tau.numpy(), "topk_ef_launches": topk_ef.LAUNCHES.count}


def _group_form(group):
    """The step of ``build_train_step``'s group form (no mesh) on this rank:
    its share of the workers, its mesh and strategy, and whether a Trainer
    takes it as a multi-process run."""
    built = build_train_step(build(get_config("fc_mnist")), PRESETS["sasg"](), M,
                             constant(0.1), device="cpu", group=group)
    return {"local_workers": built.exchange.transport.local_workers,
            "mesh": (tuple(built.mesh.mesh_dim_names), tuple(built.mesh.shape)),
            "strategy": built.strategy.name,
            "multi_process": Trainer(built, iter(()),
                                     TrainerConfig(ckpt_dir=os.devnull))._multi_process}


def _group_rank(group):
    """What each rank of the shared 2-process run returns: the exchanges,
    then the d_model=16 CNN's run, then fc_mnist's through the launcher,
    then the group form's build."""
    return {"exchange": _exchange_rank(group), "cnn16": _cnn16_run(group, 0.05),
            "fc_mnist": _train_rank(group, FC_ARGV + ["--procs", str(P)]),
            "group_form": _group_form(group)}


@pytest.fixture(scope="module")
def group_run():
    """One spawn of 2 ranks for the exchange and whole-run tests (each spawn
    costs the ranks' start-up)."""
    return _spawn(_group_rank)


def test_gathered_exchange_is_bitwise_the_stacked_exchange(group_run):
    """Also the wire log: the ranks log the rows the stacked exchange of
    the same (2,) mesh logs (one all-gather over ``data`` per tensor, its
    per-device result the M workers' part), apart from ``moved_bytes``:
    each rank's slice on the ranks, 0 stacked."""
    ranks = [r["exchange"] for r in group_run]
    for name in EXCHANGE_CASES:
        t, params, payload = _payloads(name)
        want = t.densify(t.exchange(payload), params)
        for r in ranks:
            for k, v in want.items():
                got = r[name][k]
                assert got.dtype == v.numpy().dtype and got.shape == tuple(v.shape)
                assert np.array_equal(got.view(np.int32), v.numpy().view(np.int32)), (name, k)
        stacked = build_transport(EXCHANGE_CASES[name], M, axis_sizes={"data": P})
        _, rows = _logged_exchange(stacked, payload)
        tensors = [x for x in tree_leaves(payload) if isinstance(x, torch.Tensor)]
        assert len(rows) == len(tensors) and all(
            r["kind"] == "all-gather" and r["axes"] == ["data"] and r["group_size"] == P
            and r["result_bytes"] == x.numel() * x.element_size() and r["moved_bytes"] == 0
            for r, x in zip(rows, tensors)), (name, rows)
        for rk in ranks:
            got = rk[name + "/rows"]
            assert [dict(r, moved_bytes=0) for r in got] == rows, name
            assert [r["moved_bytes"] for r in got] == [
                x.numel() * x.element_size() // P for x in tensors], name
    assert [r["num_sent"] for r in ranks] == [3.0, 3.0]


def _cnn16():
    return dataclasses.replace(get_config("cnn_cifar"), d_model=16)


def _cnn16_run(group, lr):
    """SASG on the d_model=16 CNN through ``build_train_step``: per-step
    metrics and the final params; ``group=None`` is the stacked run."""
    cfg = _cnn16()
    built = build_train_step(build(cfg), PRESETS["sasg"](), M, constant(lr), device="cpu",
                             group=group)
    state = built.init(seed=2)
    stream = launch.data_stream(cfg, 2 * M)
    hist = []
    for t in range(STEPS):
        state, mets = built.step(state, stream.batch_at(t))
        hist.append({k: float(v) for k, v in mets.items()})
    paths, leaves, _ = tree_flatten_with_paths(state.params)
    return {"history": hist, "params": {path_str(p): x.numpy() for p, x in zip(paths, leaves)}}


def _grads_split_bitwise(cfg, batch, seed):
    """Whether the per-worker gradients of workers 0-1 and 2-3 computed
    apart equal those of the four computed together."""
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    grad_fn = per_worker_grad_fn(model.loss_fn)
    full = tree_leaves(grad_fn(params, worker_batch(batch, M, "cpu"), False)[1])
    halves = [tree_leaves(grad_fn(params, worker_batch(batch, M, "cpu", (s, 2)), False)[1])
              for s in (0, 2)]
    return all(torch.equal(f, torch.cat([a, b]))
               for f, a, b in zip(full, halves[0], halves[1]))


def _check_against_stacked(ranks, stacked_hist, stacked_params, bitwise):
    for r in ranks:
        assert len(r["history"]) == STEPS
        for got, want in zip(r["history"], stacked_hist):
            for key in ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total"):
                assert got[key] == want[key], (r.get("rank"), key, got, want)
        for path, want in stacked_params.items():
            got = r["params"][path]
            if bitwise:
                assert np.array_equal(got.view(np.int32), want.view(np.int32)), path
            else:
                assert np.max(np.abs(got - want)) < 2e-2, path
    # every rank holds the same params and counters
    for path in stacked_params:
        assert np.array_equal(ranks[0]["params"][path], ranks[1]["params"][path])


def test_two_processes_match_four_stacked_workers_fc_mnist(group_run):
    ranks = [r["fc_mnist"] for r in group_run]
    cfg = get_config("fc_mnist")
    with _rank_threads():
        trainer, state = launch.train(FC_ARGV, log_fn=lambda m: None)
        bitwise = _grads_split_bitwise(cfg, launch.data_stream(cfg, 2 * M).batch_at(0), 0)
    paths, leaves, _ = tree_flatten_with_paths(state.params)
    want = {path_str(p): x.numpy() for p, x in zip(paths, leaves)}
    sent = [h["num_sent"] for h in trainer.history]
    assert min(sent) < M, sent  # workers skipped: the stale payloads crossed too
    _check_against_stacked(ranks, trainer.history, want, bitwise)
    for r in ranks:
        if bitwise:
            assert r["history"] == trainer.history   # the losses too
        assert r["topk_ef_launches"] == 0  # CPU: the plain version
    np.testing.assert_array_equal(np.concatenate([r["tau"] for r in ranks]),
                                  state.wstate.tau.numpy())


def test_two_processes_match_four_stacked_workers_cnn16(group_run):
    ranks = [r["cnn16"] for r in group_run]
    cfg = _cnn16()
    with _rank_threads():
        stacked = _cnn16_run(None, 0.05)
        bitwise = _grads_split_bitwise(cfg, launch.data_stream(cfg, 2 * M).batch_at(0), 2)
    _check_against_stacked(ranks, stacked["history"], stacked["params"], bitwise)


def test_cli_trains_its_flags_on_every_rank(monkeypatch, capfd):
    """``python -m repro_torch.launch.train ... --procs 2``: ``main()`` hands
    the command line to every rank. Only rank 0 logs; a rank that parsed
    other flags (another net, worker count or step count) would break or
    hang the group's collectives."""
    monkeypatch.setattr("sys.argv", [
        "train.py", "--arch", "fc_mnist", "--algo", "sasg", "--workers", str(M),
        "--global-batch", str(2 * M), "--steps", "3", "--lr", "0.3", "--device", "cpu",
        "--procs", str(P), "--backend", "gloo"])
    assert launch.main() == 0
    out = capfd.readouterr().out
    assert (f"[train] arch=fc_mnist algo=sasg workers={M} procs={P} backend=gloo "
            f"global_batch={2 * M} device=cpu") in out, out
    assert [ln.split()[2] for ln in out.splitlines()
            if ln.startswith("[trainer] step")] == ["0", "1", "2"], out
    assert f"[train] done: 3 steps on {P} processes" in out, out


def _step_fails_on_rank_one(group):
    trainer = launch.build_trainer(launch.parse_args(FC_ARGV), lambda m: None, group)
    fired = []

    def hook(step):   # one fault, on rank 1 only: a restart would not meet it again
        if group.rank == 1 and step == 2 and not fired:
            fired.append(step)
            raise ValueError("injected fault on rank one")

    trainer.fault_hook = hook
    trainer.run(seed=0)
    return trainer.events


def test_a_step_failing_on_one_rank_ends_the_group():
    """No rank restarts alone: its step-0 collectives would pair with the
    others' step-t ones. The injected error itself reaches the caller."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        _spawn(_step_fails_on_rank_one, timeout_s=15.0)
    assert "injected fault on rank one" in str(e.value)
    assert time.monotonic() - t0 < 60.0
    assert multiprocessing.active_children() == []


def _fail(group):
    if group.rank == 1:
        raise ValueError("rank one fails on purpose")
    return group.rank


def _hang(group):
    time.sleep(3600)


def _wait_for_a_dead_peer(group):
    if group.rank == 1:
        return "left"
    t0 = time.monotonic()
    try:
        collectives.gather_workers(torch.zeros(2), group)
    except RuntimeError:
        return time.monotonic() - t0
    return None


def _rank_and_world(group):
    return group.rank, group.world_size, str(group.device)


def test_process_hygiene():
    """Four runs at once, each with its own rendezvous: one that ends well,
    one whose rank 1 raises, one that hangs past its join timeout, and one
    whose collective waits for a rank that left."""
    runs = {
        "ok": lambda: _spawn(_rank_and_world),
        "fail": lambda: _spawn(_fail),
        "hang": lambda: _spawn(_hang, nprocs=1, join_timeout_s=6.0),
        # the timeout covers the rendezvous too: wide enough for a rank that
        # starts late on a loaded host
        "dead_peer": lambda: _spawn(_wait_for_a_dead_peer, timeout_s=15.0),
    }
    outs, took = {}, {}

    def run(name):
        t0 = time.monotonic()
        try:
            outs[name] = runs[name]()
        except (RuntimeError, TimeoutError) as e:
            outs[name] = e
        took[name] = time.monotonic() - t0

    threads = [threading.Thread(target=run, args=(name,)) for name in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    assert outs["ok"] == [(0, 2, "cpu"), (1, 2, "cpu")]
    # a failing rank's traceback reaches the caller
    assert isinstance(outs["fail"], RuntimeError)
    assert "rank 1 of 2 failed" in str(outs["fail"]) and "on purpose" in str(outs["fail"])
    # a hung rank is killed at the join timeout
    assert isinstance(outs["hang"], TimeoutError) and took["hang"] < 60.0
    # a collective waiting for a rank that left ends at the group's timeout
    waited, left = outs["dead_peer"]
    assert left == "left" and waited is not None and waited < 60.0
    assert multiprocessing.active_children() == []


def test_group_from_torchrun_environment(monkeypatch):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    assert process_group.launched_by_torchrun()
    group = process_group.from_env(None, "cpu", timeout_s=30.0)
    try:
        assert (group.rank, group.world_size, group.backend) == (0, 1, "gloo")
        x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        assert torch.equal(collectives.gather_workers(x, group), x)
    finally:
        process_group.destroy()


def test_refusals(group_run):
    # NCCL never runs two ranks on one card, nor off the card; no fallback
    with pytest.raises(ValueError, match="refuses two ranks"):
        process_group.check_backend("nccl", "cuda", torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="needs --device cuda"):
        process_group.check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="refuses two ranks"):
        launch.train_procs(["--arch", "fc_mnist", "--workers", "4", "--procs", "2",
                            "--device", "cuda", "--backend", "nccl"]
                           if not torch.cuda.is_available() else
                           ["--arch", "fc_mnist", "--workers", "4", "--device", "cuda",
                            "--procs", str(torch.cuda.device_count() + 1)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            process_group.rank_device("cuda", 0)
    with pytest.raises(SystemExit):
        launch.parse_args(["--workers", "10", "--procs", "3"])
    with pytest.raises(ValueError, match="train_procs"):
        launch.train(["--arch", "fc_mnist", "--workers", "4", "--procs", "2",
                      "--device", "cpu"])
    # the group form is the flat strategy on a (P,) data mesh over the
    # ranks; its checkpoints are no longer refused (they are gathered and
    # written by rank 0: tests/test_torch_mesh.py); a device mesh whose
    # size is not the process count is
    for r in group_run:
        assert r["group_form"] == {"local_workers": 2, "mesh": (("data",), (P,)),
                                   "strategy": "flat", "multi_process": True}
    with pytest.raises(SystemExit):
        launch.parse_args(["--mesh-shape", "2,2", "--procs", "2"])
