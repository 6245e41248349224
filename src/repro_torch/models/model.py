"""Model API of the port: ``build(config) -> Model`` with init, loss,
prefill, decode and cache init.

Port of ``repro/models/model.py``, with the JAX package's field names.
Paper-net batches are ``{"x": images (B, ...) NHWC, "labels": (B,) int}``
and their ``prefill`` slot holds the forward (logits), as in the JAX
package. LM batches are ``{"tokens": (B, S) int}``; the LM loss waits for
LM training (ROADMAP item 8).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import lm as LM
from . import paper_nets as PN


class Model(NamedTuple):
    config: ModelConfig
    init: Callable[..., Any]             # (generator, device) -> params
    loss_fn: Optional[Callable]          # (params, batch) -> loss; None for LMs
    prefill: Optional[Callable]          # (params, batch) -> (logits, cache); paper: logits
    decode_step: Optional[Callable]      # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Optional[Callable]       # (batch, max_seq, device) -> cache


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label], in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


# ---------------------------------------------------------------------------
# decoder-only LM families
# ---------------------------------------------------------------------------

def _build_lm(cfg: ModelConfig, use_kernel: bool) -> Model:
    def init(gen: torch.Generator, device=None):
        return LM.lm_init(gen, cfg, device)

    def prefill(params, batch):
        tokens = batch["tokens"]
        cache = LM.lm_init_cache(cfg, tokens.shape[0], tokens.shape[1], tokens.device)
        return LM.lm_forward(params, cfg, tokens, cache=cache, cache_pos=0,
                             use_kernel=use_kernel)

    def decode_step(params, cache, tokens, pos):
        return LM.lm_forward(params, cfg, tokens, cache=cache, cache_pos=pos,
                             use_kernel=use_kernel)

    def init_cache(batch, max_seq, device=None):
        return LM.lm_init_cache(cfg, batch, max_seq, device)

    return Model(cfg, init, None, prefill, decode_step, init_cache)


# ---------------------------------------------------------------------------
# paper models
# ---------------------------------------------------------------------------

def _build_paper(cfg: ModelConfig) -> Model:
    is_fc = cfg.family == "mlp"
    apply = PN.fc_apply if is_fc else PN.cnn_apply

    def init(gen: torch.Generator, device=None):
        return (PN.fc_init if is_fc else PN.cnn_init)(gen, cfg, device=device)

    def loss_fn(params, batch):
        return _softmax_ce(apply(params, cfg, batch["x"]), batch["labels"])

    def predict(params, batch):
        return apply(params, cfg, batch["x"])

    return Model(cfg, init, loss_fn, predict, None, None)


def build(cfg: ModelConfig, use_kernel: bool = True) -> Model:
    """``use_kernel`` selects the implementation of the SSD chunk term:
    the kernel path (``kernels/ssd_scan/ops.py``, the default) or the
    model's oracle. Both compute the same function; the selector exists so
    a run can hold one against the other."""
    if cfg.family in ("mlp", "cnn"):
        return _build_paper(cfg)
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet (ROADMAP item 8)")
    return _build_lm(cfg, use_kernel)
