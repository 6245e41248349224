"""Communication accounting — paper Table 1/2/3 semantics.

Port of ``repro/core/metrics.py`` less ``PipelineCommModel`` (it comes
with the pipeline, ROADMAP item 9): rounds = uploads that carry fresh
information (|M^t| per step); bits = per-upload paper and wire bits times
the uploads; ``CommModel`` is Table 1's static cost model and
``LinkModel`` Table 3's analytic transport time.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .types import CommCounters, Tree, tree_size


@dataclass(frozen=True)
class CommModel:
    """Static per-iteration cost model (paper Table 1)."""

    d: int          # model dimension
    k: int          # sparsification level
    M: int          # number of workers

    def bits_per_iter(self, method: str, num_sent: float | None = None) -> float:
        m = num_sent if num_sent is not None else self.M
        return {
            "sgd": 32.0 * self.d * self.M,
            "sparse": 32.0 * self.k * self.M,
            "lasg": 32.0 * self.d * m,
            "sasg": 32.0 * self.k * m,
        }[method]

    def total_bits(self, method: str, T: int, sum_rounds: float | None = None) -> float:
        if method in ("sgd", "sparse"):
            return self.bits_per_iter(method) * T
        if sum_rounds is None:
            raise ValueError("adaptive methods need the realized sum |M^t|")
        per_upload = 32.0 * (self.k if method == "sasg" else self.d)
        return per_upload * sum_rounds


def accumulate(
    counters: CommCounters,
    num_sent: torch.Tensor,
    bits_paper_per_upload: float,
    bits_wire_per_upload: float,
) -> CommCounters:
    """Fold one step's uploads into the running (float32) counters."""
    return CommCounters(
        rounds=counters.rounds + num_sent,
        bits_paper=counters.bits_paper + num_sent * bits_paper_per_upload,
        bits_wire=counters.bits_wire + num_sent * bits_wire_per_upload,
    )


@dataclass(frozen=True)
class LinkModel:
    """Analytic transport-time model (paper Table 3 / Figs 5-6 setting).

    The paper measures GLOO point-to-point uploads at 1 Gbps per worker,
    the server receiving sequentially: ``sequential_uplink=True``; False
    models a fully parallel fabric."""

    bandwidth_bps: float = 1e9
    latency_s: float = 1e-4
    sequential_uplink: bool = True

    def upload_time(self, bits_per_upload: float, num_uploads: float) -> float:
        per = bits_per_upload / self.bandwidth_bps + self.latency_s
        if self.sequential_uplink:
            return per * num_uploads
        return per


def model_dimension(params: Tree) -> int:
    return tree_size(params)
