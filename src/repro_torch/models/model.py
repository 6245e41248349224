"""Model API of the port: ``build(config) -> Model`` with init and loss.

Port of the paper-model part of ``repro/models/model.py``. Batches are
``{"x": images (B, ...) NHWC, "labels": (B,) int}``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig

from . import paper_nets as PN


class Model(NamedTuple):
    config: ModelConfig
    init: Callable[..., Any]                            # (generator, device) -> params
    loss_fn: Callable[[Any, Any], torch.Tensor]         # (params, batch) -> loss
    predict: Callable[[Any, Any], torch.Tensor]         # (params, batch) -> logits


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label], in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def _build_paper(cfg: ModelConfig) -> Model:
    is_fc = cfg.family == "mlp"
    apply = PN.fc_apply if is_fc else PN.cnn_apply

    def init(gen: torch.Generator, device=None):
        return (PN.fc_init if is_fc else PN.cnn_init)(gen, cfg, device=device)

    def loss_fn(params, batch):
        return _softmax_ce(apply(params, cfg, batch["x"]), batch["labels"])

    def predict(params, batch):
        return apply(params, cfg, batch["x"])

    return Model(cfg, init, loss_fn, predict)


def build(cfg: ModelConfig) -> Model:
    if cfg.family in ("mlp", "cnn"):
        return _build_paper(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported to repro_torch yet"
    )
