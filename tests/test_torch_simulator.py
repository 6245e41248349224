"""The port's paper experiments against the JAX repo's.

- The simulator (``repro_torch.benchmarks.simulator``) against
  ``benchmarks.simulator.make_simulator`` on fc_mnist at full width, M=10,
  for the four algorithms of Table 2 (the reference's presets: top-1%,
  ``topk_impl="sharded"``, block 64, D=10, alpha_scale 0.5), 16 steps at lr
  0.1, where workers skip. Both start from the JAX init (carried by
  ``params_from_numpy``) and see the same numpy batches. Per step: sends
  exact, ``rounds`` and ``bits_paper`` exact (host floats on both sides);
  params within 1e-5 for the dense exchanges (sgd, lasg) and 2e-2 for the
  top-k ones (sparse, sasg), the tiers of ``test_torch_train_step.py``.
- Table 1 and Table 3's arithmetic: ``CommModel`` totals,
  ``LinkModel.upload_time`` and the per-upload bits equal the JAX ones.
- A short ``run_model`` on the CPU, the claims check, Table 3 and the
  figures on its output.
"""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks.simulator import make_simulator as jax_make_simulator  # noqa: E402
from benchmarks.table2_rounds_bits import _algo_cfg as jax_algo_cfg  # noqa: E402
from repro.comm import account as jax_account  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import CompressorConfig as JaxCompressorConfig  # noqa: E402
from repro.core.metrics import CommModel as JaxCommModel  # noqa: E402
from repro.core.metrics import LinkModel as JaxLinkModel  # noqa: E402
from repro.core.metrics import model_dimension as jax_model_dimension  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    fig_curves,
    table1_comm_model,
    table2_rounds_bits,
    table3_comm_time,
)
from repro_torch.benchmarks.simulator import make_simulator  # noqa: E402
from repro_torch.comm.bits import account  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.metrics import CommModel, LinkModel, model_dimension  # noqa: E402
from repro_torch.core.types import tree_leaves  # noqa: E402
from repro_torch.data import synthetic_classification  # noqa: E402
from repro_torch.models import build, params_from_numpy  # noqa: E402

M, STEPS, LR = 10, 16, 0.1


@pytest.fixture(scope="module")
def fc_setup():
    jmodel = jax_build(jax_get_config("fc_mnist"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # Table 2's data and draws: 10 samples per worker from the training split
    xs, ys = synthetic_classification(5120, 10, (28, 28, 1), seed=0)
    idx = np.random.default_rng(0).integers(0, 4096, size=(STEPS, M, 10))
    return jmodel, jparams, xs[idx], ys[idx]


@pytest.mark.parametrize("algo", ["sgd", "sparse", "lasg", "sasg"])
def test_simulator_matches_jax(fc_setup, algo):
    jmodel, jparams, x, y = fc_setup
    model = build(get_config("fc_mnist"))
    jinit, jstep, jbits_paper, jbits_wire = jax_make_simulator(
        jax_algo_cfg(algo), jmodel.loss_fn, M)
    init, step, bits_paper, bits_wire = make_simulator(
        table2_rounds_bits._algo_cfg(algo), model.loss_fn, M, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert bits_paper(tparams) == jbits_paper(jparams)
    assert bits_wire(tparams) == jbits_wire(jparams)
    jstate, tstate = jinit(jparams), init(tparams)
    tol = 1e-5 if algo in ("sgd", "lasg") else 2e-2
    sent = []
    for t in range(STEPS):
        batches = {"x": x[t], "labels": y[t]}
        jstate, jn = jstep(jstate, batches, LR, jax.random.PRNGKey(t))
        tstate, tn = step(tstate, batches, LR)
        assert tn == jn, (t, tn, jn)
        assert (tstate.rounds, tstate.bits_paper) == (jstate.rounds, jstate.bits_paper), t
        diff = max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
                   for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)))
        assert diff < tol, (t, diff)
        sent.append(tn)
    if algo in ("lasg", "sasg"):
        assert min(sent) < M, sent  # some worker skipped: the stale branch ran
        np.testing.assert_array_equal(tstate.wstate.tau.numpy(), np.asarray(jstate.tau))
    else:
        assert sent == [M] * STEPS


def test_table1_and_table3_arithmetic_match_jax():
    for d, k, m in ((11_173_962, 111_740, 10), (2_776_906, 27_769, 7)):
        ours, ref = CommModel(d, k, m), JaxCommModel(d, k, m)
        for method in ("sgd", "sparse"):
            assert ours.total_bits(method, 100) == ref.total_bits(method, 100)
            assert ours.bits_per_iter(method) == ref.bits_per_iter(method)
        for method in ("lasg", "sasg"):
            assert ours.total_bits(method, 100, 600) == ref.total_bits(method, 100, 600)
            assert ours.bits_per_iter(method, 3) == ref.bits_per_iter(method, 3)
        with pytest.raises(ValueError):
            ours.total_bits("sasg", 100)
    for seq in (True, False):
        ours = LinkModel(1e9, 1e-4, seq)
        ref = JaxLinkModel(1e9, 1e-4, seq)
        for bits, n in ((32.0 * 2_776_906, 10), (1_132_736.0, 6.5), (0.0, 0)):
            assert ours.upload_time(bits, n) == ref.upload_time(bits, n)
    assert table1_comm_model.run(log=lambda m: None)["table1"][3]["total_bits"] == \
        JaxCommModel(11_173_962, 111_740, 10).total_bits("sasg", 100, 600)
    # Table 3's inputs: the model dimension and the top-1% per-upload bits
    jparams = jax.eval_shape(jax_build(jax_get_config("cnn_cifar")).init,
                             jax.random.PRNGKey(0))
    tparams = build(get_config("cnn_cifar")).init(torch.Generator(), device="cpu")
    assert model_dimension(tparams) == jax_model_dimension(jparams) == 2_776_906
    kw = dict(name="topk_ef", k_ratio=0.01, topk_impl="sharded", block_size=64)
    assert account(CompressorConfig(**kw), tparams).paper == \
        jax_account(JaxCompressorConfig(**kw), jparams).paper


def test_short_table2_run_and_the_tables_on_its_output(tmp_path, monkeypatch):
    lines = []
    res, curves = table2_rounds_bits.run_model(
        "fc_mnist", steps=4, lr=0.05, target_acc=0.0, eval_every=2, log=lines.append,
        topk_impl="kernel", device="cpu")
    assert set(res) == set(table2_rounds_bits.ALGOS)
    for algo, row in res.items():
        assert row["hit_target"] and [p["step"] for p in curves[algo]] == [2, 4]
        assert row["topk_impl"] == ("kernel" if algo in ("sparse", "sasg") else None)
        assert row["rounds_to_target"] == curves[algo][0]["rounds"]
    assert res["sgd"]["rounds_total"] == res["sparse"]["rounds_total"] == 4 * M
    assert res["sasg"]["bits_total"] < res["sgd"]["bits_total"] / 10
    assert "topk_impl=kernel" in lines[1]
    # the claims check runs when SASG hit its target, and says so when not
    assert table2_rounds_bits.check_claims(res, lines.append)
    missed = {a: dict(r) for a, r in res.items()}
    missed["sasg"]["hit_target"] = False
    assert not table2_rounds_bits.check_claims(missed, lines.append)
    assert lines[-1].strip().startswith("NOT CHECKED")
    assert table2_rounds_bits.claims(missed) is None
    bad = {a: dict(r) for a, r in res.items()}
    bad["sasg"]["bits_to_target"] = bad["sgd"]["bits_to_target"]
    assert table2_rounds_bits.claims(bad) == {"bits_10x_under_sgd": False,
                                              "rounds_within_1.05x_sparse": True}
    with pytest.raises(AssertionError, match="10x"):
        table2_rounds_bits.check_claims(bad, lines.append)
    slow = {a: dict(r) for a, r in res.items()}
    slow["sasg"]["rounds_to_target"] = 1.06 * slow["sparse"]["rounds_to_target"]
    with pytest.raises(AssertionError, match="exceed Sparse"):
        table2_rounds_bits.check_claims(slow, lines.append)

    # Table 3 on a Table-2 result where SASG skipped 35% of the uploads;
    # the auxiliary gradient is timed below, at 2 of its 100 iterations
    out = str(tmp_path)
    with open(os.path.join(out, "table2.json"), "w") as f:
        json.dump({"fc_mnist": {"sgd": {"rounds_total": 400.0},
                                "sasg": {"rounds_total": 260.0}}}, f)
    with open(os.path.join(out, "curves_fc_mnist.json"), "w") as f:
        json.dump(curves, f)
    monkeypatch.setattr(table3_comm_time, "aux_grad_seconds",
                        lambda model, params, device, iters: 1.25)
    t3 = table3_comm_time.run(out_dir=out, log=lines.append, device="cpu")["table3"]
    skip = 1.0 - 260.0 / 400.0
    assert t3["skip_fraction"] == skip and t3["aux_grad_s"] == 1.25
    assert t3["server_mem_lasg"] == 4 * 2_776_906 * M
    link = JaxLinkModel(1e9, 1e-4, True)
    assert t3["comm_time_s"]["sgd"] == link.upload_time(32.0 * 2_776_906, M) * 100
    sparse_bits = jax_account(JaxCompressorConfig(name="topk_ef", k_ratio=0.01,
                                                  topk_impl="sharded", block_size=64),
                              jax.eval_shape(jax_build(jax_get_config("cnn_cifar")).init,
                                             jax.random.PRNGKey(0))).paper
    assert t3["comm_time_s"]["sasg"] == link.upload_time(sparse_bits, M * (1 - skip)) * 100
    assert fig_curves.run(out_dir=out, log=lines.append) == {"fig_curves": True}


def test_aux_gradient_is_timed_on_the_given_device():
    # the timing loop at the d_model=16 width (full width: the card's run)
    model = build(dataclasses.replace(get_config("cnn_cifar"), d_model=16))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert table3_comm_time.aux_grad_seconds(model, params, torch.device("cpu"), 2) > 0
