"""The port's training step against the JAX package's, end to end.

JAX runs ``repro.train.build_train_step`` on a 4x1 ("data", "model") mesh
of CPU devices: four workers and no tensor parallelism, so its per-shard
block geometry is the single-device port's. The port runs the same four
workers stacked on one device. Both start from the same params (carried by
``params_from_numpy``) and see the same numpy batches.

Per step: sends and counters exact (counters at rtol 1e-6, float32
accumulation); loss at rtol 1e-4 (fp32 reassociation in the grads);
params within 1e-5 for the dense exchanges (sgd, lasg) and within 2e-2
for the top-k ones (sparse, sasg), where a reassociated gradient may flip
a near-tied top-k pick (the tie-flip tier of conftest.py's
flat_pipe_check).

The d_model=16 CNN at two images per worker is ill-conditioned for some
param draws: fp32 round-off is amplified ~1e3 through its backward, in
either package depending on the draw (JAX PRNGKey(0) puts the JAX run
9e-5 off its fp64 trajectory after one step; PRNGKey(1) does the same to
the port's). The draw used here, PRNGKey(2), keeps both fp32 runs within
2e-7 of fp64 over the four steps, so the 1e-5 tier tests the port and not
the conditioning.

Reduced llama3_8b with SASG (2 sequences of 16 tokens per worker from the
bigram token stream) takes every LM leaf class through the exchange: the
256x128 embed, the stacked (n_units, d, ...) attention and MLP weights,
the norms and the head; the same tiers hold."""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.core.sasg import PRESETS as JAX_PRESETS
from repro.data import (indexed_classification_stream, indexed_token_stream,
                        synthetic_classification)
from repro.dist.strategy import choose_strategy
from repro.models import build as jax_build
from repro.optim import constant as jax_constant
from repro.train import build_train_step as jax_build_train_step
from repro_torch.configs import get_config
from repro_torch.core.sasg import PRESETS
from repro_torch.core.types import tree_leaves
from repro_torch.models import build, params_from_numpy
from repro_torch.optim import constant
from repro_torch.train import build_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
M, STEPS, LR = 4, 4, 0.05


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


def _configs(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if arch == "cnn_cifar":
        jcfg = dataclasses.replace(jcfg, d_model=16)
        tcfg = dataclasses.replace(tcfg, d_model=16)
    if arch == "llama3_8b":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    return jcfg, tcfg


def _stream(arch, global_batch):
    if arch == "llama3_8b":
        return indexed_token_stream(256, global_batch, 16, seed=0)
    img = (28, 28, 1) if arch == "fc_mnist" else (32, 32, 3)
    xs, ys = synthetic_classification(256, 10, img, seed=0)
    return indexed_classification_stream(xs, ys, global_batch, seed=0)


@pytest.mark.parametrize("arch,preset,lr,steps", [
    (arch, preset, LR, STEPS)
    for arch in ("fc_mnist", "cnn_cifar") for preset in ("sgd", "sparse", "lasg", "sasg")
] + [
    # long enough at a larger lr for workers to skip: the stale-payload
    # branch of the exchange
    ("fc_mnist", "sasg", 0.1, 16), ("fc_mnist", "lasg", 0.1, 16),
    ("llama3_8b", "sasg", LR, STEPS),
])
def test_train_step_matches_jax(arch, preset, lr, steps):
    jcfg, tcfg = _configs(arch)
    mesh = compat.make_mesh((M, 1), ("data", "model"), devices=jax.devices()[:M])
    strategy = choose_strategy(mesh, sasg_enabled=True)
    assert strategy.name == "flat" and strategy.num_workers == M
    jbuilt = jax_build_train_step(jax_build(jcfg), JAX_PRESETS[preset](), mesh,
                                  strategy, jax_constant(lr))
    tbuilt = build_train_step(build(tcfg), PRESETS[preset](), M, constant(lr),
                              device="cpu")
    assert (tbuilt.bits_paper, tbuilt.bits_wire) == (jbuilt.bits_paper, jbuilt.bits_wire)

    jstate = jbuilt.init(jax.random.PRNGKey(2))
    tstate = tbuilt.init(params=params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    stream = _stream(arch, 2 * M)
    param_tol = 1e-5 if preset in ("sgd", "lasg") else 2e-2
    sent = []
    for step in range(steps):
        batch = stream.batch_at(step)
        jstate, jm = jbuilt.jit_step(jstate, batch)
        tstate, tm = tbuilt.step(tstate, batch)
        assert float(tm["num_sent"]) == float(jm["num_sent"]), step
        sent.append(float(tm["num_sent"]))
        for key in ("rounds_total", "bits_paper_total", "bits_wire_total", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        diff = max(
            float(np.max(np.abs(a.numpy() - np.asarray(b))))
            for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params))
        )
        assert diff < param_tol, (step, diff)
    if steps > STEPS:
        assert min(sent) < M, sent  # some worker skipped
    if preset in ("lasg", "sasg"):
        # the rule ran: taus match the JAX workers' per-worker counters
        np.testing.assert_array_equal(tstate.wstate.tau.numpy(),
                                      np.asarray(jstate.wstate.tau))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    """Nor anything of the JAX repo's top-level ``benchmarks`` package, which
    imports JAX; the port's own paper scripts are in
    ``repro_torch/benchmarks``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    port_benchmarks = ROOT / "src" / "repro_torch" / "benchmarks"
    assert {p.name for p in files if p.parent == port_benchmarks} >= {
        "simulator.py", "table1_comm_model.py", "table2_rounds_bits.py",
        "table3_comm_time.py", "fig_curves.py", "run.py"}
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax", "benchmarks"), (
                path, mod)


def test_entry_points_default_to_the_card():
    """No device -> cuda; without a card that raises instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tcfg = get_config("fc_mnist")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_step(build(tcfg), PRESETS["sasg"](), 2, constant(0.1))
    from repro_torch.launch import train as launch_train

    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "fc_mnist", "--steps", "1"])


def test_lr_schedules_match_jax():
    from repro.optim import step_decay as jax_step_decay
    from repro_torch.optim import step_decay

    for jfn, tfn in ((jax_constant(0.02), constant(0.02)),
                     (jax_step_decay(0.1, [3, 7], 0.5), step_decay(0.1, [3, 7], 0.5))):
        for step in range(10):
            got = tfn(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert got.item() == float(jfn(jax.numpy.int32(step))), step
