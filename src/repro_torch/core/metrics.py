"""Communication accounting — paper Table 1/2/3 semantics.

Port of ``repro/core/metrics.py``: rounds = uploads that carry fresh
information (|M^t| per step); bits = per-upload paper and wire bits times
the uploads; ``CommModel`` is Table 1's static cost model,
``PipelineCommModel`` the pipeline's stage-axis traffic per step and
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
class PipelineCommModel:
    """Static per-step pipeline (stage-axis) traffic.

    Orthogonal to the upload counters: the activation ring runs every
    step, whatever the send/skip decisions. Two engines
    (``dist/pipeline.py``):

    - ``"gpipe"``: one dense microbatch activation per stage per tick over
      ``n_micro + stages - 1`` ticks, plus the finished-output broadcast
      (``n_micro`` activations per stage);
    - ``"1f1b"``: forward carries and backward cotangent carries,
      ``n_micro + stages - 2`` hops each per stage, in the
      ``ActivationLayout`` wire format (``hop_payload_bits``); the
      finished-output broadcast is priced as a stage-axis all-reduce of the
      encoded block, ``2(S-1)/S`` of ``bcast_payload_bits`` per stage.

    ``gather_bits``: the stage-axis gradient exchange per step (the k-sized
    payload gather plus the prepare-side sum on the payload path, or the
    dense stage combine on the fallback; ``train.step.pipeline_gather_bits``).
    """

    stages: int
    n_micro: int
    act_elems: int              # elements in ONE microbatch activation
    bits_per_elem: int = 32     # dense ring payload width (GPipe engine)
    gather_bits: float = 0.0    # stage-axis gradient-exchange bits per step
    engine: str = "gpipe"       # "gpipe" | "1f1b"
    hop_payload_bits: float | None = None    # encoded per-hop bits (1f1b)
    bcast_payload_bits: float | None = None  # encoded output-broadcast bits

    @property
    def ticks(self) -> int:
        if self.engine == "1f1b":
            return self.n_micro + 2 * (self.stages - 1)
        return self.n_micro + self.stages - 1

    def _dense_act_bits(self) -> float:
        return float(self.act_elems) * self.bits_per_elem

    def _hop_bits(self) -> float:
        if self.hop_payload_bits is not None:
            return float(self.hop_payload_bits)
        return self._dense_act_bits()

    def bits_per_stage_per_step(self) -> float:
        """Ring traffic one stage emits per training step."""
        if self.engine == "1f1b":
            shifts = 2 * max(self.n_micro + self.stages - 2, 0)
            return shifts * self._hop_bits()
        return float(self.ticks) * self._dense_act_bits()

    def ring_bits_per_step(self) -> float:
        """Activation-ring traffic per step, summed over stages: the
        per-tick carries plus the finished-output broadcast."""
        if self.engine == "1f1b":
            bcast = (float(self.bcast_payload_bits) if self.bcast_payload_bits is not None
                     else self.n_micro * self._dense_act_bits())
            ar = 2.0 * (self.stages - 1) / max(self.stages, 1)
            return self.stages * (self.bits_per_stage_per_step() + ar * bcast)
        return self.stages * (self.bits_per_stage_per_step()
                              + self.n_micro * self._dense_act_bits())

    def bits_per_step(self) -> float:
        """Total stage-axis traffic per step: ring + gradient exchange."""
        return self.ring_bits_per_step() + self.gather_bits


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
