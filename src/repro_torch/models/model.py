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
encoder-decoder's an unchunked fp32 one. ``remat`` (``"none" | "full" |
"dots"``, the last run as ``"full"``) recomputes each unit of the layer
stack in the backward (``models/remat.py``); ``Model.pipeline`` is the stage decomposition the
pipeline runs (``dist/pipeline.py``), None where the model has no
homogeneous trunk. An SSD stack's loss runs its
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
from . import layers as L
from . import lm as LM
from . import paper_nets as PN
from . import remat as REMAT

NUM_PATCH_TOKENS = 256     # VLM stub prefix length


class PipelineDef(NamedTuple):
    """Stage-decomposed view of a model for the pipeline (``dist.pipeline``).

    The homogeneous *trunk*, ``n_layers`` layers of one structure whose
    params lie stacked on a leading layer dim under ``trunk_path`` and
    whose activations keep one shape end to end, is what the stages split.
    ``prepare`` / ``finish`` hold everything before / after it and read
    no trunk leaf: a stage holds only its trunk slice.
    ``prepare_paths``: the params-tree prefixes only ``prepare`` reads
    (disjoint from ``finish``'s); with them the pipeline computes
    stage-local gradients (the payload-gather path). None where the split
    does not exist (tied embeddings): the dense stage combine then runs.
    """

    n_layers: int                  # trunk depth (stacked dim)
    trunk_path: tuple              # params-tree path of the trunk
    prepare: Callable              # (params, batch) -> h (B, ...)
    layer_fn: Callable             # (layer_params, h) -> h
    finish: Callable               # (params, h, batch) -> loss
    prepare_paths: Optional[tuple] = None


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
    pipeline: Optional[PipelineDef] = None   # stage decomposition (or None)
    remat: str = "none"                      # the policy ``build`` was given


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label], in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def chunked_ce(
    hidden: torch.Tensor,    # (B, S, d)
    head_w: torch.Tensor,    # (d, V), or (d, V/t): one rank's classes with ``tp``
    labels: torch.Tensor,    # (B, S)
    n_chunks: int = 8,
    tp=None,
) -> torch.Tensor:
    """Cross-entropy with the (B, S, V) logits materialized one S-chunk at a
    time, summed chunk by chunk in order, as the JAX package's scan.

    Vocabulary-parallel with ``tp`` (``dist.tensor_parallel.ModelAxis``):
    each rank holds the logits of its V/t classes only. Per chunk the max
    is taken over the ranks' maxima, and the sum of exponentials and the
    target logit (zero on every rank but the one that holds the label)
    are summed over the ranks in rank order; the full logits are never
    gathered. ``hidden`` is replicated over the ranks and enters through
    ``tp.copy_to``."""
    b, s, d = hidden.shape
    n_chunks = min(n_chunks, s)
    while s % n_chunks:
        n_chunks -= 1
    c = s // n_chunks
    if tp is not None:
        hidden = tp.copy_to(hidden)
    total = None
    for i in range(n_chunks):
        h, lab = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        logits = (h @ head_w.to(h.dtype)).float()
        if tp is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lab.long()[..., None])[..., 0]
        else:
            v = logits.shape[-1]
            top = tp.gather(logits.detach().amax(-1, keepdim=True), -1, op="ce_max").amax(-1)
            lse = top + torch.log(tp.reduce(torch.exp(logits - top[..., None]).sum(-1)))
            t = lab.long() - tp.rank * v
            mine = logits.gather(-1, t.clamp(0, v - 1)[..., None])[..., 0]
            gold = tp.reduce(torch.where((t >= 0) & (t < v), mine, torch.zeros_like(mine)))
        part = torch.sum(lse - gold)
        total = part if total is None else total + part
    return total / (b * s)


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# decoder-only LM families
# ---------------------------------------------------------------------------

def _lm_pipeline(cfg: ModelConfig, remat: str, use_kernel: bool) -> Optional[PipelineDef]:
    """Stage decomposition of the LM stack. Only homogeneous patterns (one
    layer kind per unit) pipeline: the trunk is ``params["unit"][0]`` with
    all ``n_layers`` layers stacked, and activations keep the (B, S, d)
    shape across every stage boundary. ``remat`` applies per trunk layer."""
    u, n_units, rem = LM._unit_layout(cfg)
    if u != 1 or rem != 0 or n_units < 1:
        return None
    kind = cfg.attn_pattern[0]
    is_vlm = cfg.frontend == "patch_embed"

    def prepare(params, batch):
        x = L.embed_apply(params, cfg, batch["tokens"])
        prefix = batch.get("patch_embeds") if is_vlm else None
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        return x

    def layer_fn(wl, h):
        positions = torch.arange(h.shape[1], device=h.device)
        return LM._layer_apply(wl, cfg, kind, h, positions, None, use_kernel)[0]

    def finish(params, h, batch):
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        prefix = batch.get("patch_embeds") if is_vlm else None
        if prefix is not None:
            h = h[:, prefix.shape[1]:]
        return chunked_ce(h, _head_weight(params, cfg), batch["labels"])

    return PipelineDef(
        n_units, ("unit", 0), prepare, REMAT.checkpoint(layer_fn, remat), finish,
        # tied embeddings are read by prepare AND finish: no disjoint split
        prepare_paths=None if cfg.tie_embeddings else (("embed",),),
    )


def _build_lm(cfg: ModelConfig, remat: str, use_kernel: bool, tp=None) -> Model:
    is_vlm = cfg.frontend == "patch_embed"
    tp_size = 1 if tp is None else tp.size

    def init(gen: torch.Generator, device=None):
        return LM.lm_init(gen, cfg, device)

    def loss_fn(params, batch):
        prefix = batch.get("patch_embeds") if is_vlm else None
        hidden, _ = LM.lm_forward(params, cfg, batch["tokens"], prefix_embeds=prefix,
                                  return_hidden=True, use_kernel=use_kernel, remat=remat,
                                  tp=tp)
        if prefix is not None:
            hidden = hidden[:, prefix.shape[1]:]
        head = _head_weight(params, cfg)
        # a whole head (a vocabulary the model axis does not divide): the
        # plain CE, whose hidden cotangent is whole on every rank already
        return chunked_ce(hidden, head, batch["labels"],
                          tp=tp if head.shape[-1] < cfg.vocab_size else None)

    def prefill(params, batch):
        tokens = batch["tokens"]
        prefix = batch.get("patch_embeds") if is_vlm else None
        s = tokens.shape[1] + (prefix.shape[1] if prefix is not None else 0)
        cache = LM.lm_init_cache(cfg, tokens.shape[0], s, tokens.device, tp_size)
        return LM.lm_forward(params, cfg, tokens, prefix_embeds=prefix, cache=cache,
                             cache_pos=0, use_kernel=use_kernel, tp=tp)

    def decode_step(params, cache, tokens, pos):
        return LM.lm_forward(params, cfg, tokens, cache=cache, cache_pos=pos,
                             use_kernel=use_kernel, tp=tp)

    def init_cache(batch, max_seq, device=None):
        return LM.lm_init_cache(cfg, batch, max_seq, device, tp_size)

    def init_paged_cache(batch, max_seq, num_blocks, block_size, cache_dtype=None,
                         device=None):
        return LM.lm_init_paged_cache(cfg, batch, max_seq, num_blocks, block_size,
                                      cache_dtype, device, tp_size)

    return Model(cfg, init, loss_fn, prefill, decode_step, init_cache,
                 init_paged_cache if "global" in cfg.attn_pattern else None,
                 _lm_pipeline(cfg, remat, use_kernel), remat)


# ---------------------------------------------------------------------------
# encoder-decoder (audio)
# ---------------------------------------------------------------------------

def _build_encdec(cfg: ModelConfig, remat: str) -> Model:
    def init(gen: torch.Generator, device=None):
        return ED.encdec_init(gen, cfg, device)

    def loss_fn(params, batch):
        xkv = ED.cross_kv(params, cfg, ED.encode(params, cfg, batch["frames"], remat))
        logits, _ = ED.decode(params, cfg, batch["tokens"], xkv, remat=remat)
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

    return Model(cfg, init, loss_fn, prefill, decode_step, init_cache, remat=remat)


# ---------------------------------------------------------------------------
# paper models
# ---------------------------------------------------------------------------

def _cnn_pipeline(cfg: ModelConfig) -> PipelineDef:
    """The CNN's stage decomposition: the full-width stride-1 trunk blocks
    pipeline; the stem and the stride-2 stages run replicated in prepare /
    finish (their activation shapes change). Activations cross the stages
    NHWC, the JAX package's layout, so a compressed ring's blocks cover
    the same elements there and here; each block computes NCHW."""

    def prepare(params, batch):
        return PN.cnn_stem(params, batch["x"]).permute(0, 2, 3, 1)

    def layer_fn(wl, h):
        return PN.cnn_trunk_block(wl, h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def finish(params, h, batch):
        return _softmax_ce(PN.cnn_head(params, h.permute(0, 3, 1, 2)), batch["labels"])

    return PipelineDef(PN.CNN_TRUNK_DEPTH, ("trunk",), prepare, layer_fn, finish,
                       prepare_paths=(("stem",), ("gn0",)))


def _build_paper(cfg: ModelConfig, tp=None) -> Model:
    is_fc = cfg.family == "mlp"
    apply = PN.fc_apply if is_fc else PN.cnn_apply

    def init(gen: torch.Generator, device=None):
        return (PN.fc_init if is_fc else PN.cnn_init)(gen, cfg, device=device)

    def loss_fn(params, batch):
        return _softmax_ce(apply(params, cfg, batch["x"], tp), batch["labels"])

    def predict(params, batch):
        return apply(params, cfg, batch["x"], tp)

    return Model(cfg, init, loss_fn, predict, None, None,
                 pipeline=None if is_fc else _cnn_pipeline(cfg))


def build(cfg: ModelConfig, remat: str = "none", use_kernel: bool = True, tp=None) -> Model:
    """``use_kernel`` selects the implementation of the SSD chunk term, in
    serving and in the loss: the kernel path (``kernels/ssd_scan/ops.py``,
    the default) or the model's oracle. Both compute the same function;
    the selector exists so a run can hold one against the other. ``tp``:
    the loss, prefill and decode run on one rank's tensor-parallel shards
    (a ``dist.tensor_parallel.ModelAxis``; an LM's ``cfg`` counting that
    rank's heads: ``tensor_parallel.local_config``), as training and
    ``serve.engine.build_serve`` run them. ``remat`` acts where a gradient is
    taken: the loss and the pipeline's layers; the paper nets take none
    (as in the JAX package)."""
    if remat not in REMAT.POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; have {REMAT.POLICIES}")
    if cfg.family in ("mlp", "cnn"):
        return _build_paper(cfg, tp)
    if cfg.is_encdec:
        return _build_encdec(cfg, remat)
    return _build_lm(cfg, remat, use_kernel, tp)
