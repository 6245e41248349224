"""Model API of the port: ``build(config) -> Model`` with init, loss,
prefill, decode and cache init.

Port of ``repro/models/model.py``, with the JAX package's field names.
Batch formats:

- paper nets: ``{"x": images (B, ...) NHWC, "labels": (B,) int}``; their
  ``prefill`` slot holds the forward (logits), as in the JAX package;
- LMs: ``{"tokens": (B, S) int, "labels": (B, S) int}``, plus
  ``"patch_embeds"`` (B, Np, d) for the VLM stub (a prefix of Np
  precomputed embeddings);
- the audio encoder-decoder: ``{"frames": (B, S_src, d), "tokens": (B,
  S_tgt) int, "labels": (B, S_tgt) int}`` (the frames are the stub
  frontend's precomputed embeddings).

The LM loss is the JAX package's chunked cross-entropy, the
encoder-decoder's an unchunked fp32 one. An SSD stack's loss runs its
chunk term through ``use_kernel``'s path both ways: the CUDA forward and
backward kernels on the card (``kernels/ssd_scan/ops.py::SsdChunk``), or
the oracle under autograd.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import dtype_of

from . import encdec as ED
from . import lm as LM
from . import paper_nets as PN

NUM_PATCH_TOKENS = 256     # VLM stub prefix length


class Model(NamedTuple):
    config: ModelConfig
    init: Callable[..., Any]             # (generator, device) -> params
    loss_fn: Callable                    # (params, batch) -> loss
    prefill: Optional[Callable]          # (params, batch) -> (logits, cache); paper: logits
    decode_step: Optional[Callable]      # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Optional[Callable]       # (batch, max_seq, device) -> cache
    # (batch, max_seq, num_blocks, block_size, cache_dtype, device) -> paged
    # cache; None when the pattern has no global-attention layer to page
    init_paged_cache: Optional[Callable] = None


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label], in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def chunked_ce(
    hidden: torch.Tensor,    # (B, S, d)
    head_w: torch.Tensor,    # (d, V)
    labels: torch.Tensor,    # (B, S)
    n_chunks: int = 8,
) -> torch.Tensor:
    """Cross-entropy with the (B, S, V) logits materialized one S-chunk at a
    time, summed chunk by chunk in order, as the JAX package's scan."""
    b, s, d = hidden.shape
    n_chunks = min(n_chunks, s)
    while s % n_chunks:
        n_chunks -= 1
    c = s // n_chunks
    total = None
    for i in range(n_chunks):
        h, lab = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        logits = (h @ head_w.to(h.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lab.long()[..., None])[..., 0]
        part = torch.sum(lse - gold)
        total = part if total is None else total + part
    return total / (b * s)


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# decoder-only LM families
# ---------------------------------------------------------------------------

def _build_lm(cfg: ModelConfig, use_kernel: bool, tp=None) -> Model:
    is_vlm = cfg.frontend == "patch_embed"

    def init(gen: torch.Generator, device=None):
        return LM.lm_init(gen, cfg, device)

    def loss_fn(params, batch):
        prefix = batch.get("patch_embeds") if is_vlm else None
        hidden, _ = LM.lm_forward(params, cfg, batch["tokens"], prefix_embeds=prefix,
                                  return_hidden=True, use_kernel=use_kernel)
        if prefix is not None:
            hidden = hidden[:, prefix.shape[1]:]
        return chunked_ce(hidden, _head_weight(params, cfg), batch["labels"])

    def prefill(params, batch):
        tokens = batch["tokens"]
        prefix = batch.get("patch_embeds") if is_vlm else None
        s = tokens.shape[1] + (prefix.shape[1] if prefix is not None else 0)
        cache = LM.lm_init_cache(cfg, tokens.shape[0], s, tokens.device)
        return LM.lm_forward(params, cfg, tokens, prefix_embeds=prefix, cache=cache,
                             cache_pos=0, use_kernel=use_kernel, tp=tp)

    def decode_step(params, cache, tokens, pos):
        return LM.lm_forward(params, cfg, tokens, cache=cache, cache_pos=pos,
                             use_kernel=use_kernel, tp=tp)

    def init_cache(batch, max_seq, device=None):
        return LM.lm_init_cache(cfg, batch, max_seq, device)

    def init_paged_cache(batch, max_seq, num_blocks, block_size, cache_dtype=None,
                         device=None):
        return LM.lm_init_paged_cache(cfg, batch, max_seq, num_blocks, block_size,
                                      cache_dtype, device)

    return Model(cfg, init, loss_fn, prefill, decode_step, init_cache,
                 init_paged_cache if "global" in cfg.attn_pattern else None)


# ---------------------------------------------------------------------------
# encoder-decoder (audio)
# ---------------------------------------------------------------------------

def _build_encdec(cfg: ModelConfig) -> Model:
    def init(gen: torch.Generator, device=None):
        return ED.encdec_init(gen, cfg, device)

    def loss_fn(params, batch):
        xkv = ED.cross_kv(params, cfg, ED.encode(params, cfg, batch["frames"]))
        logits, _ = ED.decode(params, cfg, batch["tokens"], xkv)
        return _softmax_ce(logits, batch["labels"])

    def prefill(params, batch):
        """As the JAX package's: the self cache is sized to the prompt, so a
        ``decode_step`` past it writes slot ``pos % S_tgt`` over the oldest
        key. Generation starts from ``init_cache(batch, max_seq)`` instead,
        its ``"xkv"`` replaced by ``cross_kv(encode(frames))``."""
        xkv = ED.cross_kv(params, cfg, ED.encode(params, cfg, batch["frames"]))
        b, s = batch["tokens"].shape
        cache = ED.encdec_init_cache(cfg, b, s, batch["tokens"].device)
        logits, cache = ED.decode(params, cfg, batch["tokens"], xkv, cache=cache, cache_pos=0)
        return logits, {"self": cache, "xkv": xkv}

    def decode_step(params, cache, tokens, pos):
        logits, self_cache = ED.decode(params, cfg, tokens, cache["xkv"], cache=cache["self"],
                                       cache_pos=pos)
        return logits, {"self": self_cache, "xkv": cache["xkv"]}

    def init_cache(batch, max_seq, device=None):
        # cross-attention K/V sized for a fixed source window at decode time
        src = min(max_seq, 4096)
        shape = (cfg.n_layers, batch, src, cfg.n_kv_heads, cfg.head_dim)
        dt = dtype_of(cfg.compute_dtype)
        xkv = {"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)}
        return {"self": ED.encdec_init_cache(cfg, batch, max_seq, device), "xkv": xkv}

    return Model(cfg, init, loss_fn, prefill, decode_step, init_cache)


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


def build(cfg: ModelConfig, use_kernel: bool = True, tp=None) -> Model:
    """``use_kernel`` selects the implementation of the SSD chunk term, in
    serving and in the loss: the kernel path (``kernels/ssd_scan/ops.py``,
    the default) or the model's oracle. Both compute the same function;
    the selector exists so a run can hold one against the other. ``tp``:
    an LM's prefill and decode run on one rank's tensor-parallel shards,
    ``cfg`` counting that rank's heads (``models/lm.py``,
    ``serve.engine.build_serve``)."""
    if cfg.family in ("mlp", "cnn"):
        return _build_paper(cfg)
    if cfg.is_encdec:
        return _build_encdec(cfg)
    return _build_lm(cfg, use_kernel, tp)
