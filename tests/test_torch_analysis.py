"""The port's analysis package (``repro_torch.analysis``) in ONE test item.

One item, as ``tests/test_torch_chaos.py`` is one: the suite runs under
pytest-xdist's ``--dist load`` on 6 workers, whose first chunk is
``N // 24`` items, and from N = 816 that chunk puts the reference's
longest tests on one worker (ROADMAP "Test budget",
``tools/xdist_schedule.py``). Torch on one intra-op thread; ~20 s.

- The lint rules on snippets, as ``tests/test_analysis_lint.py`` holds the
  JAX package's: ``axis-name`` (literal axes where a group or mesh
  dimension is picked, parameter defaults and mesh construction allowed),
  ``tracer-leak`` (host syncs, value reads and branches on torch values,
  host numpy; static helpers allowed; scoped), ``dsize-collective`` under
  every import alias of ``torch.distributed`` and its submodules, DTensor's
  movers, and NOT a call into the port's own ``repro_torch.dist``; the
  pragma, fingerprints surviving line moves, distinct fingerprints for
  identical snippets, the baseline round trip, a deterministic report.
- The port's sweep: ``src/repro_torch`` only, clean against its committed
  baseline, no stale entry, every entry with a reason; an injected
  ``dist.all_reduce`` outside ``comm/`` is new against the baseline; the
  registry rule clean, and an injected compressor with no bit accounting
  caught.
- The comm audit's five cells on the CPU: every number equal to the JAX
  package's analytic expectations for the same cells, evaluated live
  (``repro.comm.bits`` through the JAX step's ``bits_wire``, the JAX
  audit's ``_expected_exchange`` and ``_pipe_model``:
  ``PipelineCommModel`` with ``pipeline_gather_bits``), and so to the
  committed ``BENCH_comm_audit.json`` figures; the stage gradient traffic
  k-sized; a pipelined cell on the dense stage combine seen and failed
  by the gate; the wire log on against off bitwise; an injected counter drift,
  a d-sized worker-axis all-reduce and a dense stage-axis all-reduce each
  failing the gate; the CLI's ``--check`` on the CPU writing its report
  under ``artifacts/bench_torch/`` (not ``BENCH_comm_audit.json``), and
  the bench gates failing a record past its bound.
"""
import dataclasses
import json
import textwrap

import pytest
import torch

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import comm_audit
from repro_torch.analysis.findings import load_baseline, split_by_baseline, write_baseline
from repro_torch.analysis.lint import lint_source, report_rows, run_lint
from repro_torch.analysis.rules.registry import check_registry_consistency
from repro_torch.comm import collectives
from repro_torch.comm.transport import Transport
from repro_torch.core import compressors as C
from repro_torch.core.types import tree_leaves, tree_map

CORE = "repro_torch/core/_snippet.py"      # inside every rule's scope

# the committed BENCH_comm_audit.json: per-device exchange bytes per cell,
# and the two pipelined cells' ring bytes
EXCHANGE_BYTES = {"cnn_flat_sasg": 87_664, "cnn_flat_sasg_pertensor": 71_152,
                  "cnn_pipe2_sasg": 87_664, "cnn_pipe2_sasg_ringcomp": 87_664,
                  "cnn_flat_lasg_dense": 700_264}
RING_BYTES = {"cnn_pipe2_sasg": 1_572_864, "cnn_pipe2_sasg_ringcomp": 99_840}
STAGE_GRAD_BYTES = 6_052


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread: small tensors, and under pytest-xdist
    a pool of one thread per core would oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lint(src, path=CORE, rule=None):
    findings = lint_source(textwrap.dedent(src), path=path)
    return [f for f in findings if rule is None or f.rule == rule]


# ---------------------------------------------------------------------------
# the rules on snippets
# ---------------------------------------------------------------------------

def _check_axis_names():
    fs = _lint("""
        from repro_torch.comm import collectives
        from repro_torch.comm.collectives import StageAxis
        from repro_torch.comm.process_group import axis_group
        def f(x, groups, mesh, group):
            a = collectives.mean_over(x, groups["data"])
            b = mesh.get_group("model")
            c = collectives.gather_spec(x, (None, "model"), groups)
            d = StageAxis(2, None, "stage")
            e = axis_group(group, mesh, "data")
            g = mesh["stage"]
            return a, b, c, d, e, g
    """, rule="axis-name")
    assert len(fs) == 6 and all("hardcoded axis name" in f.message for f in fs), fs
    assert _lint("""
        from repro_torch.comm.collectives import StageAxis
        from repro_torch.launch.mesh import make_test_mesh
        def f(x, groups, mesh, strategy, axis="stage"):
            a = groups[strategy.worker_axes[0]]
            b = StageAxis(2, None, axis)
            m = make_test_mesh((2,), ("data",))
            return a, b, m, mesh.get_group(axis)
    """, rule="axis-name") == []


def _check_tracer_leaks():
    fs = _lint("""
        import numpy as np
        import torch
        def f(x):
            a = x.item()
            b = float(torch.sum(x))
            if torch.any(x > 0):
                x = x + 1
            c = np.sum(x)
            d = x.cpu()
            e = x.tolist()
            g = x.numpy()
            return a, b, c, d, e, g
    """, rule="tracer-leak")
    assert len(fs) == 7, fs
    msgs = " ".join(f.message for f in fs)
    assert ".item()" in msgs and "host" in msgs and "branch" in msgs and "np.sum" in msgs
    # aliases resolve: `import torch as T` is torch, `from numpy import sum` numpy
    assert len(_lint("""
        import torch as T
        from numpy import asarray
        def f(x):
            while T.all(x > 0):
                x = x - 1
            return asarray(x)
    """, rule="tracer-leak")) == 2
    assert _lint("""
        import numpy as np
        import torch
        def f(x):
            if x.dim() > 2 and x.shape[0] > 1 and x.dtype == torch.float32:
                x = x.reshape(-1)
            n = int(np.prod(x.shape)) * x.element_size() + x.numel()
            eps = float(torch.finfo(x.dtype).eps)
            return torch.zeros((n,), dtype=x.dtype) + eps
    """, rule="tracer-leak") == []
    src = """
        import torch
        def f(x):
            return float(torch.sum(x))
    """
    assert _lint(src, path="repro_torch/core/x.py", rule="tracer-leak")
    assert _lint(src, path="repro_torch/train/step.py", rule="tracer-leak")
    # the launchers and the training loop run host-side by design
    assert _lint(src, path="repro_torch/launch/x.py", rule="tracer-leak") == []
    assert _lint(src, path="repro_torch/train/loop.py", rule="tracer-leak") == []
    assert _lint("""
        import numpy as np
        TABLE = np.sum([[1, 2], [3, 4]], axis=0)
    """, rule="tracer-leak") == []


# every spelling of a data mover outside the seam; each flagged once
DSIZE_ALIASES = {
    "as dist": "import torch.distributed as dist\ndef f(g):\n    dist.all_reduce(g)\n",
    "as td": "import torch.distributed as td\ndef f(o, g):\n    td.all_gather(o, g)\n",
    "from-import": ("from torch.distributed import all_gather_into_tensor as agt\n"
                    "def f(o, g):\n    agt(o, g)\n"),
    "full path": "import torch.distributed\ndef f(g):\n    torch.distributed.broadcast(g, 0)\n",
    "from torch": "from torch import distributed as d\ndef f(g):\n    d.reduce_scatter(g, [g])\n",
    "c10d": ("import torch.distributed.distributed_c10d as c10d\n"
             "def f(g):\n    c10d.send(g, 1)\n"),
    "functional": ("import torch.distributed._functional_collectives as funcol\n"
                   "def f(g, pg):\n    return funcol.all_reduce(g, 'sum', pg)\n"),
    "p2p": ("import torch.distributed as dist\n"
            "def f(ops):\n    return dist.batch_isend_irecv(ops)\n"),
    "object": "import torch.distributed as dist\ndef f(o):\n    dist.all_gather_object([], o)\n",
    "lazy import": ("def f(g):\n    import torch.distributed as dist\n"
                    "    dist.all_to_all_single(g, g)\n"),
    "dtensor": "def f(x):\n    return x.full_tensor()\n",
    "redistribute": "def f(x, mesh, pl):\n    return x.redistribute(mesh, pl)\n",
    "distribute": ("from torch.distributed.tensor import distribute_tensor\n"
                   "def f(x, mesh, pl):\n    return distribute_tensor(x, mesh, pl)\n"),
    "from_local check": ("from torch.distributed.tensor import DTensor\n"
                         "def f(x, mesh, pl):\n"
                         "    return DTensor.from_local(x, mesh, pl, run_check=True)\n"),
}


def _check_dsize_collectives():
    for name, src in DSIZE_ALIASES.items():
        fs = _lint(src, path="repro_torch/train/_rogue.py", rule="dsize-collective")
        assert len(fs) == 1 and "repro_torch.comm seam" in fs[0].message, (name, fs)
        # the seam itself is exempt: collectives are its job
        assert _lint(src, path="repro_torch/comm/x.py", rule="dsize-collective") == [], name
    # the port's own `dist` package, metadata, from_local without the check
    assert _lint("""
        from repro_torch import dist
        import repro_torch.dist as rdist
        import torch.distributed as td
        from torch.distributed.tensor import DTensor
        def f(x, mesh, pl, all_gather):
            a = dist.pipeline.pipeline_apply(x, [], [], None)
            b = rdist.all_gather(x)
            c = td.get_rank() + td.get_world_size()
            td.barrier()
            d = DTensor.from_local(x, mesh, pl, run_check=False)
            return a, b, c, d, all_gather(x)
    """, path="repro_torch/train/_ok.py", rule="dsize-collective") == []
    assert _lint("""
        import torch.distributed as dist
        def f(g):
            dist.all_reduce(g)  # repro-lint: ignore[dsize-collective]
    """, rule="dsize-collective") == []


def _check_fingerprints_and_baseline(tmp_path):
    src = "import torch.distributed as dist\ndef f(g):\n    return dist.all_reduce(g)\n"
    f1 = _lint(src, rule="dsize-collective")[0]
    f2 = _lint("\n\n\n" + src, rule="dsize-collective")[0]
    assert f1.line != f2.line and f1.fingerprint == f2.fingerprint
    fs = _lint("""
        import torch.distributed as dist
        def f(g):
            a = dist.all_reduce(g)
            b = dist.all_reduce(g)
            return a, b
    """, rule="dsize-collective")
    assert len(fs) == 2 and fs[0].fingerprint != fs[1].fingerprint
    assert {f.occurrence for f in fs} == {0, 1}
    path = str(tmp_path / "baseline.json")
    write_baseline([f1], justifications={f1.fingerprint: "test reason"}, path=path)
    bl = load_baseline(path)
    new, accepted = split_by_baseline([f1], bl)
    assert new == [] and accepted == [f1]
    assert bl.entries[f1.fingerprint]["justification"] == "test reason"
    assert bl.stale([]) == [f1.fingerprint]


def _check_sweep(monkeypatch):
    findings = run_lint()
    assert findings and all(f.path.startswith("repro_torch/") for f in findings)
    bl = load_baseline()
    new, _ = split_by_baseline(findings, bl)
    assert new == [], "un-baselined lint findings:\n" + "\n".join(map(str, new))
    assert bl.stale(findings) == []
    for e in bl.entries.values():
        assert len(e["justification"]) > 20 and "TODO" not in e["justification"], e
    a = json.dumps({"findings": report_rows(findings)}, indent=1, sort_keys=True)
    b = json.dumps({"findings": report_rows(run_lint())}, indent=1, sort_keys=True)
    assert a == b
    # an injected data mover outside the seam is new against the baseline
    fs = _lint("""
        import torch.distributed as dist
        def rogue(update):
            dist.all_reduce(update)
            return update
    """, path="repro_torch/train/_rogue.py", rule="dsize-collective")
    assert len(fs) == 1 and split_by_baseline(fs, bl)[0] == fs
    # the registry: clean, and a compressor with no bit accounting caught
    assert check_registry_consistency() == []
    monkeypatch.setitem(C._REGISTRY, "mystery_codec", C._REGISTRY["identity"])
    fs = check_registry_consistency()
    assert any(f.snippet == "mystery_codec" and "no bits_wire coverage" in f.message
               for f in fs), fs
    monkeypatch.delitem(C._REGISTRY, "mystery_codec")


# ---------------------------------------------------------------------------
# the comm audit against the JAX package's analytic counters
# ---------------------------------------------------------------------------

def _jax_expectations(cell):
    """The JAX package's analytic numbers for ``cell``, evaluated live (no
    HLO compile): its step's ``bits_wire`` (``repro.comm.bits``), its
    exchange expectation, and for pipelined cells its ``PipelineCommModel``
    with ``pipeline_gather_bits``."""
    from repro.analysis import hlo_audit

    jcell = hlo_audit.AuditCell(**dataclasses.asdict(cell))
    model, _mesh, strategy, built = hlo_audit._build_cell(jcell)
    _, exchange = hlo_audit._expected_exchange(built.exchange.transport.kind,
                                               strategy.num_workers, built.bits_wire)
    out = {"bits_wire": built.bits_wire, "exchange": exchange}
    if strategy.pipelined:
        pipe = hlo_audit._pipe_model(jcell, model, strategy, built)
        out.update(ring=2 * pipe.ring_bits_per_step() / 8.0 / strategy.pipeline_stages,
                   gather=pipe.gather_bits / 8.0,
                   pipe_bytes=int(pipe.bits_per_step() // 8))
    return out


def _check_audit_matrix():
    report = comm_audit.run_audit(device="cpu")
    assert comm_audit.check_report(report) == []
    for cell in comm_audit.DEFAULT_CELLS:
        rec = report["cells"][cell.name]
        want = _jax_expectations(cell)
        assert rec["bits_wire"] == want["bits_wire"], cell.name
        assert rec["logged_exchange_wire_bytes"] == rec["expected_exchange_wire_bytes"]
        assert rec["logged_exchange_wire_bytes"] == want["exchange"] == \
            EXCHANGE_BYTES[cell.name], cell.name
        assert rec["drift"] == 0.0 and rec["dsized_collectives"] == [], rec
        if cell.pipeline_stages > 1:
            assert rec["ring_wire_bytes"] == rec["ring_model_wire_bytes"] == want["ring"] \
                == RING_BYTES[cell.name], rec
            assert rec["stage_gather_wire_bytes"] == want["gather"], rec
            assert rec["stage_grad_wire_bytes"] == STAGE_GRAD_BYTES <= \
                2 * want["bits_wire"] / 8, rec
            assert rec["pipe_model_bytes_per_step"] == want["pipe_bytes"]
            kinds = {(r["kind"], r["op"]) for r in rec["ring_collectives"]}
            assert kinds == {("permute", "ring_shift_parts"),
                             ("all-reduce", "ring_broadcast_parts")}
            assert all(r["axes"] == ["stage"] for r in rec["ring_collectives"])
    return report


def _check_dense_stage_combine_is_seen():
    """A pipelined cell off the payload path (per-tensor top-k takes the
    dense stage combine): the stacked run logs the combine each stage's
    device makes, equal to ``pipeline_gather_bits``, and the gate fails it
    as d-sized stage-gradient traffic (the kind of stage-axis all-reduce
    the JAX audit finds on ``cnn_pipe2_sasg``)."""
    cell = dataclasses.replace(comm_audit.DEFAULT_CELLS[2], name="cnn_pipe2_pertensor",
                               layout="per_tensor")
    rec = comm_audit.audit_cell(cell, device="cpu")
    assert rec["drift_ok"] and rec["ring_ok"] and rec["stage_gather_ok"], rec
    assert rec["stage_gather_wire_bytes"] == rec["stage_gather_model_wire_bytes"] > 0
    assert {(r["kind"], r["op"]) for r in rec["dsized_collectives"]} == {
        ("all-reduce", "stage_combine_leaf")}
    assert not rec["stage_grad_ok"]
    problems = comm_audit.check_report({"cells": {cell.name: rec}})
    assert any("d-sized" in p for p in problems) and any("gradient" in p for p in problems)


def _params_after(cell, log: bool):
    model, built = comm_audit.build_cell(cell, "cpu")
    state = built.init(0)
    for seed in range(2):
        batch = comm_audit.cell_batch(cell, seed)
        if log:
            with collectives.wire_log():
                state, _ = built.step(state, batch)
        else:
            state, _ = built.step(state, batch)
    return tree_leaves(state.params)


def _check_log_is_free(cell):
    """The wire log reads shapes only: params bitwise with it on and off."""
    on, off = _params_after(cell, True), _params_after(cell, False)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def _check_injections(monkeypatch):
    flat, pipe = comm_audit.DEFAULT_CELLS[0], comm_audit.DEFAULT_CELLS[2]
    # a 5% error in the counters (a forgotten index byte) trips the 1% gate
    model, built, batch, rows = comm_audit.run_cell(flat, "cpu")
    rec = comm_audit.audit_step(model, built._replace(bits_wire=built.bits_wire * 1.05),
                                batch, rows)
    assert not rec["drift_ok"]
    problems = comm_audit.check_report({"cells": {flat.name: rec}, "tolerance": 0.01})
    assert problems and "drift" in problems[0]

    orig = Transport.densify

    def rogue_workers(self, contrib, like):
        # a worker-axis all-gather of the DENSE update
        out = orig(self, contrib, like)
        return tree_map(lambda x: collectives.gather_workers(
            x.unsqueeze(0).expand((self.num_workers,) + tuple(x.shape)), self.group,
            self.span)[0], out)

    monkeypatch.setattr(Transport, "densify", rogue_workers)
    rec = comm_audit.audit_cell(flat, device="cpu")
    assert not rec["dsized_ok"] and rec["dsized_collectives"]
    assert all(r["axes"] == ["data"] for r in rec["dsized_collectives"])
    assert "d-sized" in comm_audit.check_report({"cells": {flat.name: rec}})[0]

    def rogue_stages(self, contrib, like):
        # the old d-sized trunk exchange back on the stage axis: each
        # worker's dense update all-reduced over the stages
        out = orig(self, contrib, like)
        if self.stage is None:
            return out
        st = self.stage.stage
        stacked = tree_map(lambda x: x.unsqueeze(0).expand(
            (self.local_workers,) + tuple(x.shape)), out)
        summed = collectives.psum_tree([stacked] * len(st.stages), st)
        return tree_map(lambda x: x[0] / st.size, summed)

    monkeypatch.setattr(Transport, "densify", rogue_stages)
    rec = comm_audit.audit_cell(pipe, device="cpu")
    assert not rec["dsized_ok"]
    assert {(r["kind"], r["op"]) for r in rec["dsized_collectives"]} == {
        ("all-reduce", "psum_tree")}
    assert all("stage" in r["axes"] for r in rec["dsized_collectives"])
    assert not rec["stage_grad_ok"] and rec["ring_ok"]
    problems = comm_audit.check_report({"cells": {pipe.name: rec}})
    assert any("d-sized" in p for p in problems) and any("gradient" in p for p in problems)
    monkeypatch.setattr(Transport, "densify", orig)


def _check_cli(tmp_path, monkeypatch):
    """``--check`` on the CPU: exit 0, the report under artifacts/bench_torch
    of the working directory (never BENCH_comm_audit.json); a bench record
    past its bound fails the gate."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--check", "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "artifacts" / "bench_torch" / "comm_audit.json")
                        .read_text())
    assert set(report["cells"]) == set(EXCHANGE_BYTES)
    assert not (tmp_path / "BENCH_comm_audit.json").exists()
    bench = tmp_path / "artifacts" / "bench_torch"
    bl = load_baseline()
    (bench / "pipeline.json").write_text(json.dumps(
        {"pipelined": {"pipe_ring_bits_per_step": 798_720.0}}))
    (bench / "elastic.json").write_text(json.dumps({"cells": [
        {"plan": "crash", "completed": True, "steps_lost": 4, "expect_bitexact": True,
         "bitexact_vs_clean": True, "replay_exact": True}]}))
    (bench / "serve.json").write_text(json.dumps({"cells": [
        {"arch": "llama3_8b", "concurrency": 2, "paged": True, "bitexact_vs_dense": True,
         "high_water_bytes": 10.0, "dense_equiv_bytes": 20.0, "cache_dtype": "float32"}]}))
    problems, notes = cli.bench_problems(bl, str(bench))
    assert problems == [] and len(notes) == 3
    (bench / "pipeline.json").write_text(json.dumps(
        {"pipelined": {"pipe_ring_bits_per_step": 10_485_760.0}}))
    (bench / "elastic.json").write_text(json.dumps({"cells": [
        {"plan": "crash", "completed": True, "steps_lost": 9, "expect_bitexact": True,
         "bitexact_vs_clean": False, "max_param_diff_vs_clean": 1e-3,
         "replay_exact": True}]}))
    problems, _ = cli.bench_problems(bl, str(bench))
    assert len(problems) == 3 and "ceiling" in problems[0], problems
    assert cli.main(["--audit-only", "--check", "--device", "cpu"]) == 1


def test_analysis_slice(one_thread, tmp_path, monkeypatch):
    _check_axis_names()
    _check_tracer_leaks()
    _check_dsize_collectives()
    _check_fingerprints_and_baseline(tmp_path)
    _check_sweep(monkeypatch)
    _check_audit_matrix()
    _check_dense_stage_combine_is_seen()
    _check_log_is_free(comm_audit.DEFAULT_CELLS[3])   # the compressed ring's cell
    _check_log_is_free(comm_audit.DEFAULT_CELLS[0])
    _check_injections(monkeypatch)
    _check_cli(tmp_path, monkeypatch)
