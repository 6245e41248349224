"""Device meshes of gloo ranks against the stacked mesh, and checkpoints of
a multi-process run.

Two spawned groups, each shared by its items through a module fixture
(every spawn pays the ranks' start-up): 2 ranks as a (1, 2) TP mesh
(training, checkpoints, serving), and
4 ranks as a (2, 2) flat mesh, then as a (2, 2, 1) hierarchical one. The
d_model=16 CNN, SASG, 4 workers, 2 images each, on the CPU.

- A device mesh's run equals the stacked mesh's of the same shape: sends,
  rounds and bits exact on every rank; params bitwise on (1, 2) (each rank
  computes all four workers' gradients, as the stacked run does), within
  the top-k tier of ``test_torch_train_step.py`` (2e-2) where the workers
  are split over ranks. Each rank holds half of every TP-sharded leaf.
- Checkpoints: a 2-rank run saves the one-process format (rank 0 writes
  the gathered arrays; the meta names the mesh and the strategy). A 2-rank
  restore continues bitwise equal to an uninterrupted run; a one-process
  stacked run restores the same checkpoint and continues; a restore at
  another worker count cold-starts the worker state from the restored
  params. The same for the launcher's ``--procs 2`` without
  ``--mesh-shape`` (fc_mnist): a 2-rank restore continues bitwise, and a
  one-process run restores every worker's state bitwise.
- A hierarchical strategy with FSDP over the in-pod data axis (the JAX
  package refuses it: an XLA partitioner limit) runs on the 4 ranks.
- Serving: reduced llama3_8b over the (1, 2) mesh (tensor-parallel
  forward, half of the KV heads on each rank) gives the unsharded engine's
  tokens, paged and dense.
- The launcher's ``--mesh-shape``: the strategy line, and ``--procs``
  that is not the mesh's size is refused.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.comm import process_group
from repro_torch.configs import get_config
from repro_torch.core.sasg import PRESETS
from repro_torch.core.types import tree_flatten_with_paths, tree_leaves
from repro_torch.dist.strategy import choose_strategy
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build
from repro_torch.optim import constant
from repro_torch.train import Trainer, TrainerConfig, build_train_step

M, STEPS, LR, SEED = 4, 4, 0.05, 2
PROCS_ARGV = ["--arch", "fc_mnist", "--algo", "sasg", "--workers", str(M), "--procs", "2",
              "--global-batch", str(2 * M), "--device", "cpu"]
JOIN_S = 300.0
KEYS = ("num_sent", "rounds_total", "bits_paper_total", "bits_wire_total")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(get_config("cnn_cifar"), d_model=16)


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _built(shape, group=None, workers=M):
    mesh = make_test_mesh(shape, _axes(shape), group=group)
    return build_train_step(build(_cfg()), PRESETS["sasg"](), workers, constant(LR),
                            device="cpu", group=group, mesh=mesh)


def _params(built, state):
    full = built.gather_state(state)
    paths, leaves, _ = tree_flatten_with_paths(full.params)
    return {p: x.numpy().copy() for p, x in zip(paths, leaves)}


def _run(shape, group=None, steps=STEPS):
    built = _built(shape, group)
    state = built.init(seed=SEED)
    stream = launch.data_stream(_cfg(), 2 * M)
    hist = []
    for t in range(steps):
        state, mets = built.step(state, stream.batch_at(t))
        hist.append({k: float(mets[k]) for k in KEYS})
    paths, leaves, _ = tree_flatten_with_paths(state.params)
    local = {p: tuple((x.to_local() if hasattr(x, "to_local") else x).shape)
             for p, x in zip(paths, leaves)}
    return {"history": hist, "params": _params(built, state), "local": local}


def _trainer(built, steps, ckpt_dir=None, every=100):
    return Trainer(built, launch.data_stream(_cfg(), 2 * M),
                   TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=every,
                                 ckpt_async=False), log_fn=lambda m: None)


def _serve(group=None, paged=None):
    """Reduced llama3_8b answering 3 requests through 2 slots, unsharded or
    over a (1, 2) device mesh: the completions and every tick's logits."""
    import numpy as np

    from repro_torch.serve import BatchedServer, Request, build_serve

    cfg = get_config("llama3_8b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    serve = build_serve(model)
    if group is not None:
        mesh = make_test_mesh((1, 2), ("data", "model"), group=group)
        serve = build_serve(model, mesh, None, "model", "data", group=group)
        params = serve.place(params)
    srv = BatchedServer(serve, params, cfg, 2, 32, paged=paged, block_size=8)
    rng = np.random.default_rng(0)
    for i in range(3):
        srv.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=10)
                           .astype(np.int32), max_new_tokens=4))
    logits = []
    while srv.tick():
        logits.append(srv.last_tick.logits.numpy().copy())
    heads = [tuple(st["pk" if "pk" in st else "k"].shape) for st in srv.cache["unit"]]
    return {"done": sorted((c["uid"], [int(t) for t in c["tokens"]]) for c in srv.completed),
            "logits": logits, "heads": heads}


def _procs_run(group, steps, ckpt=()):
    """fc_mnist through the launcher's ``--procs 2`` without ``--mesh-shape``
    (the group form): the full params and worker state, and the history."""
    trainer, state = launch.train(PROCS_ARGV + ["--steps", str(steps)] + list(ckpt),
                                  log_fn=lambda m: None, group=group)
    full = trainer.built.gather_state(state)
    paths, leaves, _ = tree_flatten_with_paths((full.params, full.wstate))
    return {"state": {p: x.numpy().copy() for p, x in zip(paths, leaves)},
            "history": trainer.history}


def _two_rank(group, ckpt_dir):
    out = {"mesh": _run((1, 2), group),
           "serve": {paged: _serve(group, paged) for paged in (None, False)}}
    for name, steps, d, every in (("u6", 6, None, 100), ("u8", 8, None, 100),
                                  ("c4", 4, ckpt_dir, 2), ("r6", 6, ckpt_dir, 100)):
        built = _built((1, 2), group)
        trainer = _trainer(built, steps, d, every)
        state = trainer.run(seed=SEED)
        out[name] = {"params": _params(built, state), "history": trainer.history}
    d = _procs_dir(ckpt_dir)
    out["procs"] = {"u6": _procs_run(group, 6),
                    "c4": _procs_run(group, 4, ["--ckpt-dir", d, "--ckpt-every", "2"]),
                    "r6": _procs_run(group, 6, ["--ckpt-dir", d])}
    return out


def _four_rank(group):
    out = {shape: _run(shape, group) for shape in ((2, 2), (2, 2, 1))}
    # FSDP over the in-pod data axis inside the hierarchical worker region:
    # the JAX package refuses it (an XLA partitioner CHECK); the port
    # gathers the params before the gradient either way
    mesh = make_test_mesh((2, 2, 1), _axes((2, 2, 1)), group=group)
    s = choose_strategy(mesh)
    built = build_train_step(build(_cfg()), PRESETS["sasg"](), M, constant(LR), device="cpu",
                             group=group, mesh=mesh, strategy=dataclasses.replace(
                                 s, fsdp_axis="data"))
    state = built.init(seed=SEED)
    stream = launch.data_stream(_cfg(), 2 * M)
    out["fsdp"] = []
    for t in range(2):
        state, mets = built.step(state, stream.batch_at(t))
        out["fsdp"].append({k: float(mets[k]) for k in KEYS + ("loss",)})
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


def _procs_dir(ckpt_dir):
    """The checkpoints of the group form's run, beside the mesh run's."""
    return ckpt_dir + "_procs"


@pytest.fixture(scope="module")
def two_ranks(ckpt_dir):
    return process_group.spawn(_two_rank, 2, "gloo", "cpu", args=(ckpt_dir,),
                               join_timeout_s=JOIN_S)


@pytest.fixture(scope="module")
def four_ranks():
    return process_group.spawn(_four_rank, 4, "gloo", "cpu", join_timeout_s=JOIN_S)


def _threads(world):
    """The stacked reference on the threads of one rank of ``world``
    (``process_group.spawn`` splits the cores; the CPU's kernels block
    their sums by thread count)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def _same(a, b) -> bool:
    """Bitwise equal arrays (any dtype)."""
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _check(ranks, want, bitwise):
    for r in ranks:
        assert r["history"] == want["history"]
        for p, w in want["params"].items():
            got = r["params"][p]
            assert got.shape == w.shape, p
            if bitwise:
                assert np.array_equal(got.view(np.int32), w.view(np.int32)), p
            else:
                assert np.max(np.abs(got - w)) < 2e-2, p


def test_tp_mesh_matches_stacked(two_ranks):
    _threads(2)
    want = _run((1, 2))
    _check([r["mesh"] for r in two_ranks], want, bitwise=True)
    split = 0
    for p, shp in two_ranks[0]["mesh"]["local"].items():
        full = want["params"][p].shape
        halves = [i for i, (a, b) in enumerate(zip(shp, full)) if a != b]
        assert len(halves) <= 1 and all(2 * shp[i] == full[i] for i in halves), (p, shp)
        split += bool(halves)
    assert split == 14   # every conv weight and the head's matrix; norms and biases whole


def test_four_rank_meshes_match_stacked(four_ranks):
    _threads(4)
    for shape in ((2, 2), (2, 2, 1)):
        _check([r[shape] for r in four_ranks], _run(shape), bitwise=False)
    # hierarchical with FSDP inside the pod runs on every rank, the same counters
    fsdp = [r["fsdp"] for r in four_ranks]
    assert all(h == fsdp[0] for h in fsdp)
    assert [h["num_sent"] for h in fsdp[0]][0] == M and all(np.isfinite(h["loss"])
                                                          for h in fsdp[0])


def test_checkpoint_of_two_ranks_continues_bitwise(two_ranks, ckpt_dir):
    from repro_torch.train import checkpoint as CKPT

    for r in two_ranks:
        # restored at step 4 and run to 6 == 6 uninterrupted steps
        for p, w in r["u6"]["params"].items():
            assert np.array_equal(r["r6"]["params"][p].view(np.int32), w.view(np.int32)), p
        assert r["r6"]["history"] == r["u6"]["history"][4:]
    meta = CKPT.manifest_meta(ckpt_dir, 4)
    assert meta["mesh_axes"] == ["data", "model"] and meta["mesh_shape"] == [1, 2]
    assert meta["strategy"] == "flat" and meta["membership"] == [True, ["data"], M]
    assert CKPT.candidate_steps(ckpt_dir) == [6, 4, 2]
    # the group form (--procs 2, no --mesh-shape): rank 0 writes every
    # worker's state, a 2-rank restore continues bitwise, and a one-process
    # run restores the same worker state bitwise (equal membership)
    d = _procs_dir(ckpt_dir)
    for r in two_ranks:
        got, want = r["procs"]["r6"], r["procs"]["u6"]
        for p, w in want["state"].items():
            assert _same(got["state"][p], w), p
        assert got["history"] == want["history"][4:]
    meta = CKPT.manifest_meta(d, 6)
    assert meta["mesh_axes"] == ["data"] and meta["mesh_shape"] == [2]
    assert meta["membership"] == [True, ["data"], M] and meta["num_workers"] == M
    cfg = get_config("fc_mnist")
    built = build_train_step(build(cfg), PRESETS["sasg"](), M, constant(0.1), device="cpu")
    logs = []
    trainer = Trainer(built, launch.data_stream(cfg, 2 * M),
                      TrainerConfig(total_steps=8, ckpt_dir=d), log_fn=logs.append)
    state, step = trainer._restore_latest(built.init(0))
    assert step == 6 and not any("changed" in m for m in logs), logs
    paths, leaves, _ = tree_flatten_with_paths((state.params, state.wstate))
    want = two_ranks[0]["procs"]["r6"]["state"]
    assert len(paths) == len(want)
    for p, x in zip(paths, leaves):
        assert _same(x.numpy(), want[p]), p


def test_checkpoint_of_two_ranks_restores_into_one_process(two_ranks, ckpt_dir, tmp_path):
    _threads(2)
    d = str(tmp_path / "ck")
    shutil.copytree(ckpt_dir, d)
    built = _built((1, 2))
    trainer = _trainer(built, 8, d)
    state = trainer.run(seed=SEED)
    want = two_ranks[0]["u8"]
    assert [{k: h[k] for k in KEYS} for h in trainer.history] == \
        [{k: h[k] for k in KEYS} for h in want["history"][6:]]
    for p, w in want["params"].items():
        assert np.max(np.abs(_params(built, state)[p] - w)) < 2e-2, p


def test_restore_at_another_worker_count_cold_starts(two_ranks, ckpt_dir, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(ckpt_dir, d)
    built = build_train_step(build(_cfg()), PRESETS["sasg"](), 2, constant(LR), device="cpu")
    logs = []
    trainer = Trainer(built, launch.data_stream(_cfg(), 4), TrainerConfig(
        total_steps=7, ckpt_dir=d), log_fn=logs.append)
    state, step = trainer._restore_latest(built.init(SEED))
    assert step == 6 and any("worker count changed 4 -> 2" in m for m in logs), logs
    assert torch.equal(state.wstate.tau, torch.ones(2, dtype=torch.int32))
    assert all(float(e.abs().max()) == 0.0 for e in tree_leaves(state.wstate.comp_state))
    for p, w in two_ranks[0]["r6"]["params"].items():
        got = dict(zip(*tree_flatten_with_paths(state.params)[:2]))[p].numpy()
        assert np.array_equal(got.view(np.int32), w.view(np.int32)), p


def test_serving_over_a_tp_mesh_gives_the_unsharded_tokens(two_ranks):
    """Reduced llama3_8b over (1, 2), paged and dense: each rank holds half
    of the KV heads; tokens equal to the unsharded engine's, every tick's
    logits within 1e-5 of max|logits| (the sums over the model axis
    reassociate the row-parallel products)."""
    _threads(2)
    for paged in (None, False):
        want = _serve(None, paged)
        for r in two_ranks:
            got = r["serve"][paged]
            assert got["done"] == want["done"] and len(got["logits"]) == len(want["logits"])
            for a, b in zip(got["logits"], want["logits"]):
                assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b))
            assert [h[-2] * 2 for h in got["heads"]] == [h[-2] for h in want["heads"]]


def test_launcher_mesh_shape(capsys):
    trainer, state = launch.train(
        ["--arch", "fc_mnist", "--algo", "sasg", "--mesh-shape", "2,2", "--global-batch", "8",
         "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("[train] arch=fc_mnist algo=sasg mesh={'data': 2, 'model': 2} strategy=flat "
            "workers=2 stages=1") in out, out
    assert trainer.built.num_workers == 2 and len(trainer.history) == 2
    launch.train(["--arch", "fc_mnist", "--algo", "sgd", "--mesh-shape", "2,2,1",
                  "--global-batch", "8", "--steps", "1", "--device", "cpu"])
    assert "strategy=plain" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch.parse_args(["--mesh-shape", "1,2", "--procs", "3"])
    with pytest.raises(SystemExit):
        launch.parse_args(["--mesh-shape", "1,2,3,4"])
