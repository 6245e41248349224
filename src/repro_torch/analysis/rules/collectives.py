"""Rule ``dsize-collective``: data-moving collectives belong to the comm seam.

Port of ``repro/analysis/rules/collectives.py``. The paper's bit savings
live or die on what crosses the wire, so every ``torch.distributed`` call
that moves data (``all_gather``, ``all_reduce``, ``reduce_scatter``,
``all_to_all``, ``broadcast``, ``gather``, ``scatter``, the point-to-point
``send``/``recv``/``isend``/``irecv``/``batch_isend_irecv``, the
``*_object`` forms, the functional collectives, ``distribute_tensor``) and
DTensor's data movers (``full_tensor``, ``redistribute``) must live inside
``repro_torch/comm/``: the seam whose wire log and bit counters see
everything that crosses (``comm.collectives.wire_log``).

A call matches by what its callee is bound to through the module's
imports, under any alias (``rules._common``), never by its spelling.

Exempt:
- metadata (``get_rank``, ``get_world_size``, ``barrier``, ``new_group``);
- ``DTensor.from_local(..., run_check=False)``: it wraps a local shard and
  moves nothing (with ``run_check=True`` it is flagged);
- ``repro_torch/comm/`` itself and ``repro_torch/analysis/``.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding

from ._common import ScopedVisitor, collective_name

EXEMPT_PATHS = ("repro_torch/comm/", "repro_torch/analysis/")


class _Visitor(ScopedVisitor):
    def __init__(self, ctx):
        super().__init__()
        self.ctx = ctx
        self.findings: List[Finding] = []

    def visit_Call(self, node):  # noqa: N802
        name = collective_name(node, self.ctx.imports)
        if name is not None:
            self.findings.append(self.ctx.finding(
                "dsize-collective", node, self.qualname,
                f"data-moving collective {name} outside the repro_torch.comm seam; "
                "route it through comm.collectives (or record it in "
                "analysis/baseline.json with a justification) so the wire log and "
                "the bit counters see it",
            ))
        self.generic_visit(node)


def check_dsize_collectives(ctx) -> List[Finding]:
    if any(ctx.path.startswith(p) for p in EXEMPT_PATHS):
        return []
    v = _Visitor(ctx)
    v.visit(ctx.tree)
    return v.findings
