"""Lint rule registry.

An AST rule is a callable ``rule(ctx) -> list[Finding]`` where ``ctx`` is a
:class:`repro_torch.analysis.lint.FileContext` (parsed tree + path + the
module's resolved imports). Semantic rules (which import the port's
modules and check runtime registries rather than source text) run once
per sweep, not per file, and are listed separately.
"""
from __future__ import annotations

from .axis_names import check_axis_names
from .collectives import check_dsize_collectives
from .registry import check_registry_consistency
from .tracer import check_tracer_leaks

# per-file AST rules: rule id -> callable(FileContext) -> [Finding]
AST_RULES = {
    "axis-name": check_axis_names,
    "tracer-leak": check_tracer_leaks,
    "dsize-collective": check_dsize_collectives,
}

# whole-package semantic rules: rule id -> callable(device=...) -> [Finding]
SEMANTIC_RULES = {
    "registry-consistency": check_registry_consistency,
}
