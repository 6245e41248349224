"""Rule ``tracer-leak``: host syncs and data-dependent Python control flow
in code that runs under ``torch.func`` transforms or inside the step.

Port of ``repro/analysis/rules/tracer.py``, with the same rule id so the
two baselines read side by side. In torch the step is eager, so nothing
fails to trace; what the rule catches is the same pattern's cost and
fragility: a host sync stalls the card's stream every step, and Python
control flow on a tensor's value fails under ``torch.func.vmap`` /
``grad`` (a batched tensor has no single value) and specializes a run on
its data. Scoped to the modules whose functions run under the transforms
or in the step (core, comm, dist, models, kernels, optim, and
``train/step.py``); launch, configs, the serving engine and the training
loop run host-side by design.

Flags, inside function bodies:

- ``x.item()``, ``x.tolist()``, ``x.numpy()``, ``x.cpu()``: host syncs;
- ``float(...)``/``int(...)``/``bool(...)`` over an expression that calls
  into ``torch.*`` (static helpers like ``torch.finfo`` are exempt);
- ``if``/``while``/``assert``/conditional expressions whose test calls
  into ``torch.*``;
- a curated set of ``np.*`` value ops (``np.asarray``, ``np.sum``, ...):
  host numpy over a tensor syncs (``np.prod`` over shapes stays allowed).

Calls match by what their callee is bound to through the module's imports
(``rules._common``), under any alias.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.findings import Finding

from ._common import ScopedVisitor, attr_chain

TRACED_SCOPES = (
    "repro_torch/core/", "repro_torch/comm/", "repro_torch/dist/", "repro_torch/models/",
    "repro_torch/kernels/", "repro_torch/optim/", "repro_torch/train/step.py",
)

# torch.<name> that read dtypes, devices, shapes or global switches, not
# tensor values
_STATIC_ATTRS = frozenset({
    "dtype", "device", "Size", "finfo", "iinfo", "is_tensor", "is_floating_point",
    "is_complex", "get_default_dtype", "promote_types", "result_type", "can_cast",
    "is_grad_enabled", "is_inference_mode_enabled", "are_deterministic_algorithms_enabled",
    "cuda", "backends", "distributed", "jit", "compiler", "version",
})
_HOST_SYNCS = ("item", "tolist", "numpy", "cpu")

# np.<name> calls that consume array *values* (host-side math)
_NP_VALUE_OPS = frozenset(
    {"asarray", "array", "copy", "sum", "mean", "max", "min", "abs", "exp",
     "log", "sqrt", "dot", "matmul", "where", "argmax", "argmin", "argsort",
     "linalg", "concatenate", "stack", "einsum"}
)


def _torch_value_call(ctx, node: ast.AST) -> bool:
    """Does ``node`` contain a call into ``torch.*`` that reads values?"""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        for path in ctx.imports.resolve(n.func):
            parts = path.split(".")
            if parts[0] == "torch" and len(parts) >= 2 and parts[1] not in _STATIC_ATTRS:
                return True
    return False


def _numpy_value_op(ctx, call: ast.Call) -> str:
    for path in ctx.imports.resolve(call.func):
        parts = path.split(".")
        if parts[0] == "numpy" and len(parts) >= 2 and parts[1] in _NP_VALUE_OPS:
            return parts[1]
    return ""


class _Visitor(ScopedVisitor):
    def __init__(self, ctx):
        super().__init__()
        self.ctx = ctx
        self.findings: List[Finding] = []
        self._depth = 0  # >0 inside a function body

    def _scoped(self, node, label):
        is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        self._depth += is_fn
        super()._scoped(node, label)
        self._depth -= is_fn

    def _flag(self, node, msg):
        self.findings.append(self.ctx.finding("tracer-leak", node, self.qualname, msg))

    def visit_Call(self, node):  # noqa: N802
        if self._depth:
            func = node.func
            if (isinstance(func, ast.Attribute) and func.attr in _HOST_SYNCS
                    and (func.attr == "cpu" or not node.args)):
                self._flag(node, f".{func.attr}() syncs to the host; step code must "
                                 "stay on the device")
            chain = attr_chain(func)
            if (len(chain) == 1 and chain[0] in ("float", "int", "bool")
                    and node.args and _torch_value_call(self.ctx, node.args[0])):
                self._flag(node, f"{chain[0]}() over a torch expression reads a "
                                 "tensor's value on the host")
            op = _numpy_value_op(self.ctx, node)
            if op:
                self._flag(node, f"host numpy op np.{op} in step code; use torch (np is "
                                 "only safe on static shapes/dtypes)")
        self.generic_visit(node)

    def _check_test(self, node, kind):
        if self._depth and _torch_value_call(self.ctx, node.test):
            self._flag(node, f"Python {kind} on a torch value; use torch.where or a "
                             "mask instead of host control flow on tensors")

    def visit_If(self, node):  # noqa: N802
        self._check_test(node, "branch")
        self.generic_visit(node)

    def visit_While(self, node):  # noqa: N802
        self._check_test(node, "loop")
        self.generic_visit(node)

    def visit_Assert(self, node):  # noqa: N802
        self._check_test(node, "assert")
        self.generic_visit(node)

    def visit_IfExp(self, node):  # noqa: N802
        self._check_test(node, "conditional expression")
        self.generic_visit(node)


def check_tracer_leaks(ctx) -> List[Finding]:
    if not any(ctx.path.startswith(p) or ctx.path == p.rstrip("/") for p in TRACED_SCOPES):
        return []
    v = _Visitor(ctx)
    v.visit(ctx.tree)
    return v.findings
