"""Rule ``registry-consistency``: compressors x layouts x bit counters agree.

Port of ``repro/analysis/rules/registry.py``. Semantic (imports the live
registries rather than parsing source): for every compressor registered
in ``repro_torch.core.compressors._REGISTRY``,

- ``build_compressor`` must realize a known payload layout
  (``per_shard | per_tensor | flat | dense``);
- ``repro_torch.comm.bits.account`` must cover it (a registered
  compressor with no ``bits_wire`` accounting is exactly the "hand-kept
  counters diverge" failure this package exists to prevent), and its wire
  bits must be positive and finite on a torch template;
- the legacy ``topk_impl`` spellings ("sharded", "block") and
  ``bucket="global"`` must keep resolving through
  ``CompressorConfig.resolved_impl/resolved_layout``, and the
  explicit-layout conflict guard must still raise.
"""
from __future__ import annotations

import math
from typing import List

from repro_torch.analysis.findings import Finding

_PATH = "repro_torch/core/compressors.py"
_LAYOUTS = {"per_shard", "per_tensor", "flat", "dense"}
_IMPLS = {"exact", "reference", "kernel"}


def _finding(name: str, message: str, path: str = _PATH) -> Finding:
    return Finding(
        rule="registry-consistency", path=path, line=0,
        qualname="_REGISTRY", snippet=name, message=message,
    )


def check_registry_consistency(registry=None, device="cpu") -> List[Finding]:
    """Findings over ``registry`` (default: the live one), the template's
    tensors on ``device``."""
    import torch

    from repro_torch.comm import bits as bits_lib
    from repro_torch.core import compressors as C

    registry = registry if registry is not None else C._REGISTRY
    findings: List[Finding] = []
    template = {"w": torch.zeros((64, 8), dtype=torch.float32, device=device),
                "b": torch.zeros((32,), dtype=torch.float32, device=device)}

    for name in sorted(registry):
        cfg = C.CompressorConfig(name=name)
        try:
            comp = C.build_compressor(cfg)
        except Exception as e:  # pragma: no cover - registry must build
            findings.append(_finding(
                name, f"registered compressor fails to build: {e!r}"))
            continue
        if comp.layout not in _LAYOUTS:
            findings.append(_finding(
                name, f"realized layout {comp.layout!r} is not one of "
                      f"{sorted(_LAYOUTS)}"))
        try:
            report = bits_lib.account(cfg, template)
            wire, paper = report.wire, report.paper
        except Exception as e:
            findings.append(_finding(
                name, "no bits_wire coverage in repro_torch.comm.bits.account "
                      f"({e!r}); every registered compressor must be "
                      "accounted", path="repro_torch/comm/bits.py"))
            continue
        if not (math.isfinite(wire) and wire > 0 and math.isfinite(paper)
                and paper > 0):
            findings.append(_finding(
                name, f"bits accounting degenerate (paper={paper}, "
                      f"wire={wire})", path="repro_torch/comm/bits.py"))

    # legacy spelling resolution (only meaningful for the default registry)
    if registry is C._REGISTRY:
        for legacy in ("sharded", "block"):
            cfg = C.CompressorConfig(topk_impl=legacy)
            if cfg.resolved_impl() not in _IMPLS:
                findings.append(_finding(
                    f"topk_impl={legacy!r}",
                    f"legacy spelling resolves to unknown impl "
                    f"{cfg.resolved_impl()!r}"))
            if cfg.resolved_layout() not in _LAYOUTS:
                findings.append(_finding(
                    f"topk_impl={legacy!r}",
                    f"legacy spelling resolves to unknown layout "
                    f"{cfg.resolved_layout()!r}"))
        if C.CompressorConfig(bucket="global").resolved_layout() != "flat":
            findings.append(_finding(
                "bucket='global'",
                "legacy global bucket no longer resolves to the flat layout"))
        try:
            C.build_compressor(
                C.CompressorConfig(layout="per_shard", topk_impl="exact"))
        except ValueError:
            pass  # the documented conflict guard
        else:
            findings.append(_finding(
                "layout='per_shard', topk_impl='exact'",
                "conflicting layout/impl no longer rejected; silent layout "
                "switching breaks the wire accounting"))
    return findings
