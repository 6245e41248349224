"""The AST lint: parse every ``src/repro_torch`` module, run the rules.

Port of ``repro/analysis/lint.py``. Rules see a :class:`FileContext`
(parsed tree + package-relative path + the module's resolved imports) and
return :class:`~repro_torch.analysis.findings.Finding` objects.
Fingerprints are content-derived (see ``findings.py``); an inline escape
hatch exists for single sites (``# repro-lint: ignore[rule-id]`` on the
offending line) but the committed baseline with a justification is the
preferred mechanism: it keeps all known exceptions in one reviewable place.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .findings import Finding

_PRAGMA_RE = re.compile(r"#\s*repro-lint:\s*ignore\[([\w,\s-]+)\]")


def default_root() -> str:
    """The ``repro_torch`` package directory this module lives in; never
    the ``src`` around it, which holds the JAX package too."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class FileContext:
    path: str                     # package-relative posix path ("repro_torch/...")
    source: str
    tree: ast.AST
    lines: List[str]
    _counts: Dict[Tuple[str, str, str], int] = field(default_factory=dict)
    _imports: Optional[object] = None

    @classmethod
    def parse(cls, source: str, path: str) -> "FileContext":
        return cls(
            path=path.replace(os.sep, "/"),
            source=source,
            tree=ast.parse(source, filename=path),
            lines=source.splitlines(),
        )

    @property
    def imports(self):
        """What the module's names are bound to (``rules._common.Imports``)."""
        if self._imports is None:
            from .rules._common import Imports

            self._imports = Imports(self.tree, self.path)
        return self._imports

    def _pragma_ignored(self, rule: str, lineno: int) -> bool:
        if 1 <= lineno <= len(self.lines):
            m = _PRAGMA_RE.search(self.lines[lineno - 1])
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                return rule in rules or "all" in rules
        return False

    def finding(self, rule: str, node: ast.AST, qualname: str,
                message: str) -> Optional[Finding]:
        snippet = ast.unparse(node)
        key = (rule, qualname, snippet)
        occ = self._counts.get(key, 0)
        self._counts[key] = occ + 1
        lineno = getattr(node, "lineno", 0)
        if self._pragma_ignored(rule, lineno):
            return None
        return Finding(
            rule=rule, path=self.path, line=lineno, qualname=qualname,
            snippet=snippet, message=message, occurrence=occ,
        )


def _run_file_rules(ctx: FileContext) -> List[Finding]:
    from .rules import AST_RULES

    out: List[Finding] = []
    for rule_fn in AST_RULES.values():
        out.extend(f for f in rule_fn(ctx) if f is not None)
    return out


def lint_source(source: str, path: str = "repro_torch/_snippet.py") -> List[Finding]:
    """Lint one source string (rule unit tests use this)."""
    return _run_file_rules(FileContext.parse(source, path))


def iter_python_files(root: Optional[str] = None):
    """Yield (abs_path, path relative to the root's parent) for every .py
    file of the package at ``root``, sorted for deterministic reports."""
    root = os.path.abspath(root or default_root())
    base = os.path.dirname(root)
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        if "__pycache__" in dirnames:
            dirnames.remove("__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                ap = os.path.join(dirpath, fn)
                yield ap, os.path.relpath(ap, base).replace(os.sep, "/")


def run_lint(root: Optional[str] = None,
             include_semantic: bool = True, device="cpu") -> List[Finding]:
    """Full lint sweep: per-file AST rules + whole-package semantic rules
    (their tensors on ``device``)."""
    findings: List[Finding] = []
    for abs_path, rel_path in iter_python_files(root):
        with open(abs_path, encoding="utf-8") as f:
            source = f.read()
        findings.extend(_run_file_rules(FileContext.parse(source, rel_path)))
    if include_semantic:
        from .rules import SEMANTIC_RULES

        for rule_fn in SEMANTIC_RULES.values():
            findings.extend(rule_fn(device=device))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.occurrence))
    return findings


def report_rows(findings: List[Finding]) -> List[dict]:
    return [f.row() for f in findings]
