"""Communication accounting — paper Table 1/2 semantics.

Port of the counter part of ``repro/core/metrics.py``: rounds = uploads
that carry fresh information (|M^t| per step); bits = per-upload paper and
wire bits times the uploads.
"""
from __future__ import annotations

import torch

from .types import CommCounters


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
