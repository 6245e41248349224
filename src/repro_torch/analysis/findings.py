"""Findings, fingerprints, and the committed baseline.

Port of ``repro/analysis/findings.py`` (the same fingerprints, so the two
baselines read side by side).

A :class:`Finding` is one lint hit. Its **fingerprint** is content-derived
(rule id, repo-relative path, enclosing function qualname, the normalized
source of the offending node, and an occurrence counter for identical nodes
in the same scope) — deliberately *not* line-based, so unrelated edits above
a finding do not invalidate the baseline.

The baseline (``repro_torch/analysis/baseline.json``, committed) lists fingerprints of
known, intentionally-accepted findings, each with a one-line justification.
``--check`` fails on any finding whose fingerprint is absent; baseline
entries that no longer fire are reported as stale (warning, not failure, so
a fix elsewhere never breaks the gate).
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


@dataclass(frozen=True)
class Finding:
    rule: str          # rule id, e.g. "dsize-collective"
    path: str          # repo-relative posix path
    line: int          # 1-based line (display only; not in the fingerprint)
    qualname: str      # enclosing function/class qualname ("<module>" at top)
    snippet: str       # normalized source of the offending node
    message: str
    occurrence: int = 0  # disambiguates identical snippets in one scope

    @property
    def fingerprint(self) -> str:
        key = "|".join(
            [self.rule, self.path, self.qualname, self.snippet,
             str(self.occurrence)]
        )
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def row(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "qualname": self.qualname,
            "snippet": self.snippet,
            "message": self.message,
            "occurrence": self.occurrence,
            "fingerprint": self.fingerprint,
        }

    def __str__(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.rule}] {self.message}"
            f"  ({self.qualname}: {self.snippet[:80]})"
            f"  [fingerprint {self.fingerprint}]"
        )


@dataclass
class Baseline:
    """Committed known-findings list + audit reference numbers."""

    entries: Dict[str, dict] = field(default_factory=dict)  # fingerprint -> row
    audit: dict = field(default_factory=dict)               # cell -> reference
    # bench ceilings, e.g. max_ring_bits_per_step: the port's
    # artifacts/bench_torch/pipeline.json must keep the compressed 1F1B
    # activation ring below this (``--check`` fails otherwise)
    pipeline_bench: dict = field(default_factory=dict)
    # serve-bench gates: every paged cell of serve.json must be bit-exact vs
    # its dense twin and keep its pool high-water at or below the
    # dense-equivalent bytes (times max_paged_over_dense_bytes_ratio)
    serve_bench: dict = field(default_factory=dict)
    # elastic/chaos-bench gates (elastic.json): every recovery cell must
    # complete within max_steps_lost replayed steps, and cells whose fault
    # class promises bit-identity (expect_bitexact) must deliver it
    elastic_bench: dict = field(default_factory=dict)

    def accepts(self, f: Finding) -> bool:
        return f.fingerprint in self.entries

    def stale(self, findings: List[Finding]) -> List[str]:
        live = {f.fingerprint for f in findings}
        return sorted(fp for fp in self.entries if fp not in live)


def load_baseline(path: Optional[str] = None) -> Baseline:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return Baseline()
    with open(path) as f:
        raw = json.load(f)
    entries = {e["fingerprint"]: e for e in raw.get("findings", [])}
    return Baseline(
        entries=entries,
        audit=raw.get("audit", {}),
        pipeline_bench=raw.get("pipeline_bench", {}),
        serve_bench=raw.get("serve_bench", {}),
        elastic_bench=raw.get("elastic_bench", {}),
    )


def write_baseline(
    findings: List[Finding],
    justifications: Optional[Dict[str, str]] = None,
    audit: Optional[dict] = None,
    path: Optional[str] = None,
) -> str:
    """Serialize findings (+ optional audit reference) as the new baseline.

    ``justifications`` maps fingerprints to one-line reasons; unknown
    fingerprints get a TODO marker so the diff shows what needs a human
    sentence before committing.
    """
    path = path or BASELINE_PATH
    justifications = justifications or {}
    prev = load_baseline(path) if os.path.exists(path) else Baseline()
    rows = []
    for f in sorted(findings, key=lambda x: (x.path, x.rule, x.qualname,
                                             x.snippet, x.occurrence)):
        just = justifications.get(f.fingerprint)
        if just is None:
            prev_row = prev.entries.get(f.fingerprint, {})
            just = prev_row.get("justification", "TODO: justify or fix")
        rows.append({
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "path": f.path,
            "qualname": f.qualname,
            "snippet": f.snippet,
            "justification": just,
        })
    payload = {
        "findings": rows,
        "audit": audit if audit is not None else prev.audit,
        "pipeline_bench": prev.pipeline_bench,
        "serve_bench": prev.serve_bench,
        "elastic_bench": prev.elastic_bench,
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def split_by_baseline(
    findings: List[Finding], baseline: Baseline
) -> Tuple[List[Finding], List[Finding]]:
    """(new, accepted) partition of ``findings`` against the baseline."""
    new = [f for f in findings if not baseline.accepts(f)]
    accepted = [f for f in findings if baseline.accepts(f)]
    return new, accepted
