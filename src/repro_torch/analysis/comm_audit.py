"""Pass 2: the comm audit — logged wire bytes vs the bit counters.

The port's counterpart of the JAX package's HLO audit (``repro/analysis/
hlo_audit.py``). Torch has no HLO to read, so the bytes come from the comm
seam itself: ``comm.collectives.wire_log`` records every collective the
step makes, per device of the mesh, with the ring model's wire bytes (an
all-gather (n-1)/n of its result, an all-reduce 2(n-1)/n, a permute its
result). For a small config x strategy x layout matrix (the JAX audit's
five cells) it builds the real train step, runs one step under the log,
and then:

- cross-checks the exchange's wire bytes against ``bits_wire``. The
  exchange is the worker-axis all-gather of the payload for every layout,
  dense included: the port all-gathers dense payloads too, to sum them in
  worker order (``comm/collectives.py``). Per device that is ``(n-1)/n x
  M x bits_wire / 8`` over n devices of the worker axes, ``(M-1) x
  bits_wire / 8`` at one worker a device, where the JAX audit expects a
  ring all-reduce's ``2(M-1)/M`` for dense payloads. The two agree at
  M = 2; at M = 10 the port's dense exchange moves M/2 = 5x the bytes.
  Drift beyond the tolerance (default 1%) fails the audit. The
  quantizers (qsgd, signsgd_ef, terngrad) are outside this gate: no cell
  runs one, and they move their decoded fp32 payload, 32 bits a
  coordinate where ``comm/bits.py`` bills 1-9, until the packed
  quantizer wire (ROADMAP queue 1, item 12b) lands.
- itemizes every *d-sized* collective that is not the exchange: a row
  whose per-device result is at least ``min(0.5 x largest param leaf,
  one compressed upload)`` bytes for each worker the device holds (one in
  the matrix, as in the JAX audit). The pipeline's activation ring (the
  ring shifts, whose rows must be the ``ActivationLayout``-encoded hop's
  parts, and the output broadcast, whose rows must be the encoded output
  block's parts) is itemized under ``ring_collectives`` and must match
  ``core.metrics.PipelineCommModel`` (``ring_drift`` <= ``RING_TOL``,
  scaled by the pipeline passes a step takes, by the stages, and by the
  workers a device holds). Everything else on the stage axis is gradient
  traffic (``stage_grad_wire_bytes``): it must stay k-sized (at most two
  compressed uploads), and its payload gather and prepare-side sums must
  equal ``train.step.pipeline_gather_bits``.

Runs on ``cuda`` unless the caller passes ``device="cpu"``; the bytes are
static, so both give the same report. The cells are stacked meshes, so
the collectives that only ranks make (``comm/collectives.py``: the
gathers over a model axis, the means over an inner data axis and plain
data parallelism's) are outside what it sees.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_TOL = 0.01
# the ring against PipelineCommModel and the stage gather against
# pipeline_gather_bits: both are byte-exact on the matrix (drift 0); the
# tolerance absorbs nothing else
RING_TOL = 0.01
RING_OPS = ("ring_shift_parts", "ring_broadcast_parts")
STAGE_GATHER_OPS = ("gather_block_payload", "psum_tree", "stage_combine_leaf")


@dataclass(frozen=True)
class AuditCell:
    """One build-and-audit point of the config x strategy x layout matrix."""

    name: str
    algo: str = "sasg"                    # preset in repro_torch.core.sasg.PRESETS
    arch: str = "cnn_cifar"
    d_model: int = 16
    k_ratio: float = 0.05
    max_delay: int = 4
    batch: int = 8
    mesh_shape: Tuple[int, ...] = (2,)
    mesh_axes: Tuple[str, ...] = ("data",)
    pipeline_stages: int = 1
    layout: Optional[str] = None          # compressor layout override
    # activation-ring wire layout override: (wire_dtype, k_ratio, block_size)
    act_layout: Optional[Tuple[str, float, int]] = None
    allow_dsized: bool = False            # escape hatch; no default cell uses it


DEFAULT_CELLS: Tuple[AuditCell, ...] = (
    AuditCell(name="cnn_flat_sasg"),
    AuditCell(name="cnn_flat_sasg_pertensor", layout="per_tensor"),
    AuditCell(name="cnn_pipe2_sasg", mesh_shape=(2, 2), mesh_axes=("data", "stage"),
              pipeline_stages=2),
    # the compressed ring: its rows carry the encoded (values, u8 indices)
    # parts, not the dense block
    AuditCell(name="cnn_pipe2_sasg_ringcomp", mesh_shape=(2, 2),
              mesh_axes=("data", "stage"), pipeline_stages=2,
              act_layout=("float32", 0.05, 256)),
    AuditCell(name="cnn_flat_lasg_dense", algo="lasg"),
)


def build_cell(cell: AuditCell, device="cuda"):
    """(model, built step) of one cell on a stacked mesh."""
    from repro_torch.comm.transport import ActivationLayout
    from repro_torch.configs import get_config
    from repro_torch.core.sasg import PRESETS
    from repro_torch.dist.strategy import choose_strategy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build
    from repro_torch.optim import constant
    from repro_torch.train import build_train_step

    if cell.arch != "cnn_cifar":
        raise NotImplementedError(f"the audit builds batches for cnn_cifar only, got "
                                  f"{cell.arch!r}")
    model = build(dataclasses.replace(get_config(cell.arch), d_model=cell.d_model))
    dev = torch.device(device)
    mesh = make_test_mesh(cell.mesh_shape, cell.mesh_axes, device_type=dev.type)
    kw = {"max_delay": cell.max_delay}
    if cell.algo in ("sasg", "sparse"):
        kw["k_ratio"] = cell.k_ratio
    if cell.algo == "sgd":
        kw = {}
    scfg = PRESETS[cell.algo](**kw)
    if cell.layout is not None:
        scfg = dataclasses.replace(
            scfg, compressor=dataclasses.replace(scfg.compressor, layout=cell.layout))
    if cell.act_layout is not None:
        scfg = dataclasses.replace(scfg, act_layout=ActivationLayout(*cell.act_layout))
    strategy = choose_strategy(mesh, sasg_enabled=True, pipeline_stages=cell.pipeline_stages,
                               trunk_layers=model.pipeline.n_layers if model.pipeline else 0)
    built = build_train_step(model, scfg, None, constant(0.05), device=dev, mesh=mesh,
                             strategy=strategy)
    return model, built


def cell_batch(cell: AuditCell, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(cell.batch, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, size=(cell.batch,)).astype(np.int32)}


# ---------------------------------------------------------------------------
# expectations from the shapes
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _template(model):
    return model.init(torch.Generator().manual_seed(0), device="meta")


def workers_per_device(built) -> int:
    """The workers one device of the data axes holds."""
    sizes = dict(zip(built.mesh.mesh_dim_names, tuple(built.mesh.shape)))
    data = math.prod(sizes[a] for a in built.strategy.batch_axes)
    return max(built.num_workers // data, 1)


def expected_exchange_bytes(built) -> float:
    """Per-device wire bytes of the exchange: an all-gather of the M
    workers' payloads over the devices of the worker axes."""
    n = built.exchange.transport.span.size
    return (n - 1) / n * built.num_workers * built.bits_wire / 8.0 if n > 1 else 0.0


def _prepare_shape(model, batch: dict, num_workers: int) -> tuple:
    """One worker's ``pipeline.prepare`` output shape, on the meta device."""
    one = {}
    for k, v in batch.items():
        shape = (int(v.shape[0]) // num_workers,) + tuple(v.shape[1:])
        if k == "labels":
            dtype = torch.long
        else:
            dtype = v.dtype if isinstance(v, torch.Tensor) else torch.as_tensor(v[:1]).dtype
        one[k] = torch.empty(shape, dtype=dtype, device="meta")
    return tuple(model.pipeline.prepare(_template(model), one).shape)


def pipe_expectations(model, built, batch: dict) -> dict:
    """The pipelined step's stage traffic from its shapes: the
    ``PipelineCommModel`` the step publishes, the ring's part sizes per
    device, and the model's per-device ring and gather bytes."""
    from repro_torch.comm.transport import ActivationLayout
    from repro_torch.core import metrics as CM
    from repro_torch.dist.pipeline import resolve_microbatches
    from repro_torch.train.step import pipeline_gather_bits

    strategy, cfg = built.strategy, built.exchange.config
    S = strategy.pipeline_stages
    h = _prepare_shape(model, batch, built.num_workers)
    nm = resolve_microbatches(h[0], strategy.microbatches or S)
    act = math.prod(h) // nm
    layout = cfg.act_layout or ActivationLayout()
    gather_bits = pipeline_gather_bits(built.exchange.transport, _template(model),
                                       model.pipeline, strategy, cfg.selection)
    pipe = CM.PipelineCommModel(
        stages=S, n_micro=nm, act_elems=act, bits_per_elem=32, gather_bits=gather_bits,
        engine=cfg.pipeline_engine, hop_payload_bits=layout.payload_bits(act),
        bcast_payload_bits=layout.payload_bits(nm * act))
    wpd = workers_per_device(built)
    micro = (wpd, h[0] // nm) + h[1:]
    full = (wpd, nm) + micro[1:]
    ring_parts = {_nbytes(p) for shape in (micro, full)
                  for p in layout.zero_parts(shape, "meta", 1)}
    passes = 2 if cfg.selection.enabled else 1
    return {
        "model": pipe,
        "ring_part_bytes": ring_parts,
        "passes": passes,
        "ring_model_wire_bytes": passes * pipe.ring_bits_per_step() / 8.0 / S * wpd,
        "gather_model_wire_bytes": pipe.gather_bits / 8.0 * wpd,
    }


def dsized_threshold(model, built) -> float:
    """Half the largest param leaf, but never above one compressed upload;
    per worker a device holds (the JAX audit's one)."""
    from repro_torch.core.types import tree_leaves

    largest = max(_nbytes(x) for x in tree_leaves(_template(model)))
    return workers_per_device(built) * min(0.5 * largest, built.bits_wire / 8.0)


# ---------------------------------------------------------------------------
# the audit of one step's rows
# ---------------------------------------------------------------------------

def _count_rows(rows: Sequence[dict]) -> List[dict]:
    """Identical rows (one per leaf and call) merged into counted rows,
    largest result first."""
    keys = ("kind", "op", "shapes", "axes", "result_bytes", "wire_bytes")
    counted: Dict[tuple, int] = {}
    for r in rows:
        k = tuple((f, tuple(r[f]) if f == "axes" else r[f]) for f in keys)
        counted[k] = counted.get(k, 0) + 1
    out = [dict(k, count=n) for k, n in counted.items()]
    for r in out:
        r["axes"] = list(r["axes"])
    return sorted(out, key=lambda r: (-r["result_bytes"], r["kind"], r["op"], r["shapes"]))


def audit_step(model, built, batch: dict, rows: Sequence[dict], tol: float = DEFAULT_TOL,
               allow_dsized: bool = False) -> dict:
    """Audit the wire-log rows of one step of ``built`` on ``batch`` (split
    out of ``audit_cell`` so tests and the card's run can inject)."""
    t = built.exchange.transport
    strategy = built.strategy
    worker = tuple(sorted(t.span.axes))
    stage_ax = strategy.stage_axis if strategy.pipelined else None

    def is_exchange(r):
        return r["op"] == "exchange" and tuple(sorted(r["axes"])) == worker

    pipe = pipe_expectations(model, built, batch) if stage_ax else None

    def is_ring(r):
        return (pipe is not None and stage_ax in r["axes"] and r["op"] in RING_OPS
                and r["result_bytes"] in pipe["ring_part_bytes"])

    expected = expected_exchange_bytes(built)
    logged = sum(r["wire_bytes"] for r in rows if is_exchange(r))
    drift = abs(logged - expected) / expected if expected else 0.0
    threshold = dsized_threshold(model, built)
    dsized = [r for r in rows if r["result_bytes"] >= threshold
              and not is_exchange(r) and not is_ring(r)]
    sizes = dict(zip(built.mesh.mesh_dim_names, tuple(built.mesh.shape)))
    record = {
        "algo": built.exchange.config.name,
        "layout": t.compressor.layout,
        "exchange_kind": t.kind,
        "exchange_op": "all-gather",
        "mesh": {a: int(s) for a, s in sizes.items()},
        "num_workers": built.num_workers,
        "pipeline_stages": strategy.pipeline_stages,
        "bits_paper": built.bits_paper,
        "bits_wire": built.bits_wire,
        "expected_exchange_wire_bytes": expected,
        "logged_exchange_wire_bytes": logged,
        "exchange_collectives": sum(1 for r in rows if is_exchange(r)),
        "drift": drift,
        "drift_ok": drift <= tol,
        "dsized_threshold_bytes": int(threshold),
        "dsized_collectives": _count_rows(dsized),
        "dsized_ok": allow_dsized or not dsized,
        "allow_dsized": allow_dsized,
        "total_collectives": len(rows),
        "total_wire_bytes": round(sum(r["wire_bytes"] for r in rows), 1),
        "moved_bytes": sum(r["moved_bytes"] for r in rows),
    }
    if pipe is not None:
        stage_rows = [r for r in rows if stage_ax in r["axes"]]
        ring = [r for r in stage_rows if is_ring(r)]
        stage_wire = sum(r["wire_bytes"] for r in stage_rows)
        ring_wire = sum(r["wire_bytes"] for r in ring)
        gather_wire = sum(r["wire_bytes"] for r in stage_rows if r["op"] in STAGE_GATHER_OPS)
        grad_wire = stage_wire - ring_wire
        ring_expect = pipe["ring_model_wire_bytes"]
        gather_expect = pipe["gather_model_wire_bytes"]
        ring_drift = abs(ring_wire - ring_expect) / ring_expect if ring_expect else 0.0
        gather_drift = (abs(gather_wire - gather_expect) / gather_expect
                        if gather_expect else 0.0)
        k_sized = 2.0 * built.bits_wire / 8.0 * workers_per_device(built)
        record.update({
            "stage_axis_wire_bytes": round(stage_wire, 1),
            "ring_collectives": _count_rows(ring),
            "ring_wire_bytes": round(ring_wire, 1),
            "stage_grad_wire_bytes": round(grad_wire, 1),
            "stage_grad_bound_bytes": k_sized,
            "stage_grad_ok": grad_wire <= k_sized,
            "stage_gather_wire_bytes": round(gather_wire, 1),
            "stage_gather_model_wire_bytes": round(gather_expect, 1),
            "stage_gather_drift": gather_drift,
            "stage_gather_ok": gather_drift <= RING_TOL,
            "pipe_model_bytes_per_step": int(pipe["model"].bits_per_step() // 8),
        })
        if built.exchange.config.pipeline_engine == "1f1b":
            # the ring is reclassified, not exempt: its bytes must be the
            # model's (GPipe's dense ring has no such model, as in JAX)
            record.update({
                "ring_passes": pipe["passes"],
                "ring_model_wire_bytes": round(ring_expect, 1),
                "ring_drift": ring_drift,
                "ring_ok": ring_drift <= RING_TOL,
            })
    return record


def run_cell(cell: AuditCell, device="cuda", seed: int = 0):
    """(model, built, batch, rows) of one step of a cell under the wire log."""
    from repro_torch.comm import collectives

    model, built = build_cell(cell, device)
    batch = cell_batch(cell, seed)
    state = built.init(seed)
    with collectives.wire_log() as rows:
        built.step(state, batch)
    return model, built, batch, rows


def audit_cell(cell: AuditCell, tol: float = DEFAULT_TOL, device="cuda") -> dict:
    """Build one cell, run one step under the wire log, audit it."""
    model, built, batch, rows = run_cell(cell, device)
    return audit_step(model, built, batch, rows, tol, cell.allow_dsized)


def run_audit(cells: Sequence[AuditCell] = DEFAULT_CELLS, tol: float = DEFAULT_TOL,
              device="cuda") -> dict:
    """Audit the whole matrix -> the report (``artifacts/bench_torch/
    comm_audit.json`` by default)."""
    return {
        "tolerance": tol,
        "device": str(device),
        "note": ("per-device wire bytes logged in the comm seam (ring collective model) "
                 "vs the analytic repro_torch.comm.bits counters; d-sized = result >= "
                 "min(largest param leaf / 2, one upload)"),
        "cells": {c.name: audit_cell(c, tol, device) for c in cells},
    }


def check_report(report: dict) -> List[str]:
    """Gate: problems that must fail the check. Empty list = audit clean."""
    problems: List[str] = []
    tol = report.get("tolerance", DEFAULT_TOL)
    for name, rec in sorted(report.get("cells", {}).items()):
        if not rec.get("drift_ok", True):
            problems.append(
                f"{name}: exchange wire drift {100 * rec['drift']:.2f}% (logged "
                f"{rec['logged_exchange_wire_bytes']:.0f} B vs counters "
                f"{rec['expected_exchange_wire_bytes']:.0f} B) exceeds {100 * tol:.1f}%")
        if not rec.get("dsized_ok", True):
            items = ", ".join(f"{r['kind']} {r['shapes']} over {'/'.join(r['axes'])} "
                              f"({r['op']})" for r in rec.get("dsized_collectives", [])[:4])
            problems.append(f"{name}: d-sized collective(s) outside the accounted exchange "
                            f"on a cell that forbids them: {items}")
        if not rec.get("ring_ok", True):
            problems.append(
                f"{name}: activation-ring wire {rec['ring_wire_bytes']:.0f} B diverges "
                f"{100 * rec['ring_drift']:.2f}% from the PipelineCommModel "
                f"({rec['ring_model_wire_bytes']:.0f} B over {rec['ring_passes']} pipeline "
                f"pass(es)); the ring is reclassified, not exempt")
        if not rec.get("stage_gather_ok", True):
            problems.append(
                f"{name}: stage gather {rec['stage_gather_wire_bytes']:.0f} B diverges "
                f"{100 * rec['stage_gather_drift']:.2f}% from pipeline_gather_bits "
                f"({rec['stage_gather_model_wire_bytes']:.0f} B)")
        if not rec.get("stage_grad_ok", True):
            problems.append(
                f"{name}: stage-axis gradient traffic {rec['stage_grad_wire_bytes']:.0f} B "
                f"exceeds two compressed uploads ({rec['stage_grad_bound_bytes']:.0f} B)")
    return problems
