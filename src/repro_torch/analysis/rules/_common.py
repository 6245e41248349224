"""Shared AST helpers for lint rules: what a name is bound to, not how it
is spelled.

Port of ``repro/analysis/rules/_common.py`` for torch. A call matches a
collective by the dotted path its callee resolves to through the module's
imports (``import torch.distributed as dist``, ``... as td``, ``from
torch.distributed import all_gather``, ``torch.distributed.distributed_c10d``,
``torch.distributed._functional_collectives``), never by the spelling
``dist.``: the port's own ``repro_torch.dist`` package (``dist.pipeline``,
``dist.sharding``) is no collective, and ``td.all_reduce`` is one.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

TORCH_DIST = "torch.distributed"

# torch.distributed (and its submodules') calls that move data between
# processes; metadata (get_rank, get_world_size, barrier, new_group, ...)
# moves none
DATA_COLLECTIVES = frozenset({
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_gather_coalesced",
    "all_gather_tensor", "all_gather_tensor_autograd", "all_gather_into_tensor_coalesced",
    "all_reduce", "all_reduce_coalesced", "all_reduce_multigpu",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
    "reduce_scatter_tensor_autograd", "all_to_all", "all_to_all_single",
    "all_to_all_single_autograd", "broadcast", "broadcast_object_list", "gather",
    "gather_object", "scatter", "scatter_object_list", "send", "recv", "isend", "irecv",
    "send_object_list", "recv_object_list", "batch_isend_irecv", "permute_tensor",
    "distribute_tensor", "distribute_module",
})
# DTensor methods that move data: matched by name, since a static pass
# cannot tell a DTensor receiver (the names are DTensor's own)
DTENSOR_MOVERS = frozenset({"full_tensor", "redistribute"})


def attr_chain(node: ast.AST) -> Tuple[str, ...]:
    """('td', 'all_reduce') for ``td.all_reduce``; () when not a pure
    Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _package_of(path: str) -> Tuple[str, ...]:
    """('repro_torch', 'comm') for 'repro_torch/comm/transport.py'."""
    parts = path.replace("\\", "/").split("/")[:-1]
    return tuple(parts)


class Imports:
    """Every name the module's imports bind (at any depth: the port imports
    inside functions), and the dotted paths it is bound to."""

    def __init__(self, tree: ast.AST, path: str = ""):
        self.bound: Dict[str, Set[str]] = {}
        pkg = _package_of(path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self._bind(a.asname, a.name)
                    else:
                        head = a.name.split(".")[0]
                        self._bind(head, head)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg[:len(pkg) - (node.level - 1)] if node.level > 1 else pkg
                    mod = ".".join(base + ((node.module,) if node.module else ()))
                else:
                    mod = node.module or ""
                for a in node.names:
                    if a.name != "*":
                        self._bind(a.asname or a.name, f"{mod}.{a.name}" if mod else a.name)

    def _bind(self, name: str, target: str) -> None:
        self.bound.setdefault(name, set()).add(target)

    def resolve(self, node: ast.AST) -> Set[str]:
        """The dotted paths a Name/Attribute chain may stand for (empty when
        its head is no imported name: a local, a parameter, an attribute
        of an object)."""
        chain = attr_chain(node)
        if not chain or chain[0] not in self.bound:
            return set()
        rest = ".".join(chain[1:])
        return {f"{t}.{rest}" if rest else t for t in self.bound[chain[0]]}


def collective_name(call: ast.Call, imports: Imports) -> Optional[str]:
    """The data-moving collective ``call`` invokes, or None: a
    ``torch.distributed`` function (of any submodule) that moves data, a
    DTensor mover method, or ``DTensor.from_local(..., run_check=True)``
    (its check is a collective)."""
    func = call.func
    for path in imports.resolve(func):
        parts = path.split(".")
        if (path.startswith(TORCH_DIST + ".") and parts[-1] in DATA_COLLECTIVES):
            return parts[-1]
        if parts[-1] == "from_local" and _run_check(call):
            return "from_local"
    if isinstance(func, ast.Attribute) and func.attr in DTENSOR_MOVERS:
        return func.attr
    return None


def _run_check(call: ast.Call) -> bool:
    return any(kw.arg == "run_check" and not (isinstance(kw.value, ast.Constant)
                                              and kw.value.value is False)
               for kw in call.keywords)


def string_literals(node: ast.AST) -> List[str]:
    """All string constants anywhere inside ``node``."""
    return [
        n.value for n in ast.walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    ]


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing qualname (functions/classes)."""

    def __init__(self) -> None:
        self._stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._stack) if self._stack else "<module>"

    def _scoped(self, node, label: str) -> None:
        self._stack.append(label)
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node):       # noqa: N802 (ast API casing)
        self._scoped(node, node.name)

    def visit_AsyncFunctionDef(self, node):  # noqa: N802
        self._scoped(node, node.name)

    def visit_ClassDef(self, node):          # noqa: N802
        self._scoped(node, node.name)

    def visit_Lambda(self, node):            # noqa: N802
        self._scoped(node, "<lambda>")
