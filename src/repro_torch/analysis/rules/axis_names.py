"""Rule ``axis-name``: no hardcoded mesh axis names where a collective's
group or mesh dimension is picked.

Port of ``repro/analysis/rules/axis_names.py``. Every axis a collective
runs over must be *bound*, threaded in from the strategy
(``dist.strategy.Strategy``), never a string literal at the site that
picks it: a literal silently breaks when ``choose_strategy`` renames or
carves axes (the pipeline ``stage`` carve), and is invisible to the
mesh-role bookkeeping. The sites:

- a subscript of a group or mesh table by a literal (``groups["data"]``,
  ``mesh["model"]``);
- ``DeviceMesh.get_group`` / ``get_local_rank`` / ``get_coordinate``
  with a literal, ``axis_group(group, mesh, "data")``;
- a literal axis inside the partition-spec entries of ``gather_spec``;
- ``StageAxis(size, group, "stage")``, ``Span(("data",), n)`` and the
  ``worker_axes`` / ``name`` keywords of the seam.

A literal as a *parameter default* (``def f(axis="stage")``) is fine: the
caller can rebind it. Building a mesh (``make_test_mesh(shape, ("data",))``,
``init_device_mesh``) names its axes rather than picking one, as
``dist/strategy.py`` does, and is not a site.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.findings import Finding

from ._common import ScopedVisitor, attr_chain, string_literals

# callee name -> positional slot of its axis argument (keywords below)
_AXIS_ARG = {"get_group": 0, "get_local_rank": 0, "get_coordinate": 0,
             "axis_group": 2, "gather_spec": 1, "StageAxis": 2, "Span": 0}
_AXIS_KWARGS = ("mesh_dim", "axis", "axes", "entries", "name", "worker_axes")
_TABLES = ("group", "mesh")


def _callee(call: ast.Call) -> str:
    chain = attr_chain(call.func)
    return chain[-1] if chain else ""


def _axis_argument(call: ast.Call):
    name = _callee(call)
    if name not in _AXIS_ARG and name not in ("build_exchange", "build_transport"):
        return None
    for kw in call.keywords:
        if kw.arg in _AXIS_KWARGS:
            return kw.value
    pos = _AXIS_ARG.get(name)
    if pos is not None and len(call.args) > pos:
        return call.args[pos]
    return None


class _Visitor(ScopedVisitor):
    def __init__(self, ctx):
        super().__init__()
        self.ctx = ctx
        self.findings: List[Finding] = []

    def _flag(self, node, names, where):
        self.findings.append(self.ctx.finding(
            "axis-name", node, self.qualname,
            f"hardcoded axis name {names!r} in {where}; thread the axis from the "
            "strategy (a parameter default is fine)",
        ))

    def visit_Call(self, node):  # noqa: N802
        axis = _axis_argument(node)
        if axis is not None and string_literals(axis):
            self._flag(node, string_literals(axis), _callee(node))
        self.generic_visit(node)

    def visit_Subscript(self, node):  # noqa: N802
        chain = attr_chain(node.value)
        if (chain and any(t in chain[-1].lower() for t in _TABLES)
                and isinstance(node.slice, ast.Constant) and isinstance(node.slice.value, str)):
            self._flag(node, [node.slice.value], f"{chain[-1]}[...]")
        self.generic_visit(node)


def check_axis_names(ctx) -> List[Finding]:
    v = _Visitor(ctx)
    v.visit(ctx.tree)
    return v.findings
