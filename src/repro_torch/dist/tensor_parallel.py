"""Tensor-parallel compute over the model axis: its collectives as
autograd Functions, and which models run it.

The JAX package keeps the model axis automatic inside its ``shard_map``
(``repro/train/step.py``): XLA's partitioner computes each worker's
gradient on the params' model-axis shards, and serving runs the same
partitioned forward. The port writes that partitioning out. Each rank of
the model axis holds its shards of the params (``dist.sharding.
param_specs``: column-parallel ``wq/wk/wv``, ``w_gate/w_up``, conv
output channels and the heads' classes; row-parallel ``wo`` / ``w_down``;
the vocabulary-parallel embedding) and runs the forward of
``models/lm.py`` / ``models/paper_nets.py`` with ``tp=`` one
``ModelAxis``, whose operators are Megatron-LM's:

- ``copy_to`` (Megatron's *f*): identity forward, sum over the ranks
  backward; it stands before a column-parallel product of a replicated
  input, and on a replicated leaf that a rank uses on its own shard
  (``local_slice``: GroupNorm's scale and bias, the heads' biases, the
  SSD heads' vectors, RG-LRU's Lambda), so that every rank's gradient of
  that leaf is the whole one; after ``reduce`` (``total``) it makes a
  statistic of partial sums that each rank applies to its own shard (the
  gated RMSNorm's variance) a sum in both directions;
- ``reduce`` (*g*): sum forward, identity backward, after ``wo`` /
  ``w_down`` and for the vocabulary-parallel lookups;
- ``gather``: an all-gather forward whose backward keeps this rank's
  slice, for a replicated consumer (the logits before the loss);
- ``gather_for_local``: the all-gather whose result each rank consumes
  differently: the input of a product with a shard-local weight (a
  conv's input channels, RG-LRU's gates), an activation re-laid by heads
  (the SSD's fused projection), a weight each rank applies whole but
  back-propagates only from its own heads (the SSD's ``conv_w``), a KV
  head that the axis does not split. Its backward sums the ranks'
  cotangents and keeps this rank's slice: a reduce-scatter.

Every sum runs through ``comm.collectives`` in rank order, in fp32, so
the ranks hold the same bits of every replicated activation and every
replicated leaf's gradient. Each Function carries a ``vmap`` rule that
folds the mapped dim (the stacked workers of ``torch.func.vmap(grad)``)
into one collective, and its backward calls another Function, so the
backward's collective, which runs at the level of ``vmap``, gets the
rule too (the pattern of ``kernels/ssd_scan/ops.py``). DTensor stays out:
its collectives fail under ``vmap`` and over gloo on CUDA tensors.

``compute_path`` says whether a training run computes on the shards
(``"sharded"``) or gathers the params first (``"gathered (<reason>)"``):
the paper nets and the decoder-only LMs of attention, SSD, RG-LRU and
MoE layers whose widths the model axis divides compute on the shards (so
does a single KV head: each rank rebuilds it whole, as Megatron-LM
does; so do a vocabulary and an expert count that it does not divide:
the embedding and the head stay whole on every rank, the experts split
over ``d_expert``); the encoder-decoder, remat, the pipeline and FSDP
beside the model axis keep the gather (ROADMAP item 7c). ``blockers``
gives the reasons that concern the model alone; serving over a mesh
refuses on them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.comm import collectives

_ATTN_KINDS = ("global", "swa", "local")
_GN_GROUPS = 8   # the CNN's GroupNorm groups (models/paper_nets.py)


# ---------------------------------------------------------------------------
# the Functions (each with a vmap rule that folds the mapped dim)
# ---------------------------------------------------------------------------

def _front(x, d):
    """``x`` with its mapped dim ``d`` in front (``None``: not mapped)."""
    return x if d is None else x.movedim(d, 0)


class _Sum(torch.autograd.Function):
    """Sum over the ranks forward (``collectives.sum_over``, logged as
    ``op``); identity backward."""

    @staticmethod
    def forward(x, group, op):
        return collectives.sum_over(x, group, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, op):
        return _Sum.apply(_front(x, in_dims[0]), group, op), (None if in_dims[0] is None else 0)


class _Copy(torch.autograd.Function):
    """Identity forward; sum over the ranks backward (logged as
    ``copy_to``)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.group, "copy_to"), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Copy.apply(_front(x, in_dims[0]), group), (None if in_dims[0] is None else 0)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward (logged as ``op``); backward: this
    rank's slice of the cotangent."""

    @staticmethod
    def forward(x, dim, group, op):
        return collectives.gather_dim(x, dim, group, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.group.world_size
        return g.narrow(ctx.dim, ctx.group.rank * n, n), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group, op):
        if in_dims[0] is None:
            return _Gather.apply(x, dim, group, op), None
        return _Gather.apply(_front(x, in_dims[0]), dim + 1, group, op), 0


class _GatherForLocal(torch.autograd.Function):
    """All-gather along ``dim`` forward (logged as ``gather_for_local``);
    backward: the reduce-scatter of the cotangent."""

    @staticmethod
    def forward(x, dim, group):
        return collectives.gather_dim(x, dim, group, "gather_for_local")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.dim, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        if in_dims[0] is None:
            return _GatherForLocal.apply(x, dim, group), None
        return _GatherForLocal.apply(_front(x, in_dims[0]), dim + 1, group), 0


class _ReduceScatter(torch.autograd.Function):
    """``collectives.reduce_scatter`` along ``dim``: the backward of
    ``gather_for_local``. No double backward is taken through it."""

    @staticmethod
    def forward(x, dim, group):
        return collectives.reduce_scatter(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("reduce_scatter: no double backward through the model axis")

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        if in_dims[0] is None:
            return _ReduceScatter.apply(x, dim, group), None
        return _ReduceScatter.apply(_front(x, in_dims[0]), dim + 1, group), 0


# ---------------------------------------------------------------------------
# the model axis as a forward sees it
# ---------------------------------------------------------------------------

class ModelAxis:
    """The model axis's ranks (a ``WorkerGroup`` over the axis) as a
    tensor-parallel forward uses them, in training and in serving. Dims
    are those of the tensor the caller sees (negative ones count from the
    end), under ``vmap`` too."""

    def __init__(self, group, name: str = "model"):
        self.group = group
        self.name = name

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def size(self) -> int:
        return self.group.world_size

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(x, self.group, "reduce")

    def gather(self, x: torch.Tensor, dim: int = -1, op: str = "gather") -> torch.Tensor:
        return _Gather.apply(x, dim % x.dim(), self.group, op)

    def gather_for_local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherForLocal.apply(x, dim % x.dim(), self.group)

    def own(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's even share of ``x`` along ``dim`` (no communication)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def local_slice(self, leaf: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice of a replicated leaf used on its own shard of
        an activation; the leaf's gradient is the sum of the ranks' (each
        nonzero on its own slice only), the same bits on every rank."""
        return self.own(self.copy_to(leaf), dim)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partials ``x``, used on every rank's own
        shard (``reduce`` then ``copy_to``: a sum forward and backward, so
        each rank's partial gets every rank's cotangent)."""
        return self.copy_to(self.reduce(x))

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of this rank's vocabulary slice, zeros for the others'
        tokens, summed over the ranks (one nonzero term a row: exact)."""
        v = table.shape[0]
        t = tokens.long() - self.rank * v
        inside = ((t >= 0) & (t < v))[..., None]
        rows = table[t.clamp(0, v - 1)]
        return self.reduce(torch.where(inside, rows, torch.zeros_like(rows)))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather(x, -1)

    def sq_norm(self, parts, split) -> torch.Tensor:
        """The squared l2 norm of a full tree from this rank's per-leaf
        partial sums ``parts`` (fp32, each a scalar or one per worker):
        ``split[i]`` says whether leaf i is this rank's shard (its partials
        added over the ranks in rank order) or replicated (rank 0's). The
        leaves are added in order, so every rank gets the same bits. One
        all-gather of the partials."""
        every = collectives.gather_dim(torch.stack(list(parts)).unsqueeze(0), 0, self.group,
                                       "sq_norm")
        total = None
        for i, s in enumerate(split):
            v = every[0, i]
            for r in range(1, self.size if s else 1):
                v = v + every[r, i]
            total = v if total is None else total + v
        return total


# ---------------------------------------------------------------------------
# which models compute on their shards
# ---------------------------------------------------------------------------

def _ssd_widths(cfg) -> dict:
    """The widths an SSD layer's shards split: its heads, the fused input
    projection's columns and the conv's channels."""
    s = cfg.ssm
    d_inner = cfg.d_model * s.expand
    h, gn = d_inner // s.head_dim, s.n_groups * s.d_state
    return {"SSD heads": h, "SSD w_in columns": 2 * d_inner + 2 * gn + h,
            "SSD conv channels": d_inner + 2 * gn}


def blockers(cfg, t: int) -> list:
    """Why one of ``t`` model-axis ranks cannot run ``cfg``'s forward on its
    shards (``dist.sharding.param_specs``); empty when it can."""
    why, dims = [], {}
    if cfg.family in ("mlp", "cnn"):
        dims = {"d_model": cfg.d_model, "classes": cfg.vocab_size}
        if cfg.family == "cnn":
            dims["GroupNorm groups"] = _GN_GROUPS
    elif cfg.is_encdec or cfg.frontend not in (None, "patch_embed"):
        why.append(f"{cfg.name} is not a decoder-only LM")
    else:
        # a vocabulary the axis does not divide stays whole on every rank
        kinds = set(cfg.attn_pattern)
        if kinds & set(_ATTN_KINDS):
            dims["heads"] = cfg.n_heads
            hkv = cfg.n_kv_heads
            # a single kv head is whole on every rank, its weights split
            # along the head's own dims; more that the axis does not divide
            # wait for 7c
            if hkv % t and (hkv > 1 or cfg.head_dim % t):
                why.append(f"kv heads {hkv} not divisible by {t}"
                           + (" and more than one" if hkv > 1 else
                              f", head width {cfg.head_dim} not divisible by it"))
        m = cfg.moe
        if m is not None and kinds - {"ssd"}:
            # expert-parallel, else over d_expert (dist.sharding.param_specs)
            if m.num_experts % t and m.d_expert % t:
                why.append(f"MoE: neither {m.num_experts} experts nor d_expert {m.d_expert} "
                           f"divisible by {t}")
            if m.num_shared_experts:
                dims["MoE shared expert width"] = m.d_expert * m.num_shared_experts
        elif kinds - {"ssd"}:
            dims["d_ff"] = cfg.d_ff
        if "ssd" in kinds:
            dims.update(_ssd_widths(cfg))
            g = cfg.ssm.n_groups
            if g % t and t % g:
                why.append(f"SSD groups {g} neither divisible by {t} nor dividing it")
        if "rglru" in kinds:
            dims["RG-LRU width"] = cfg.rglru.lru_width or cfg.d_model
    bad = [f"{k} {v}" for k, v in dims.items() if v % t]
    if bad:
        why.append(", ".join(bad) + f" not divisible by {t}")
    return why


def compute_path(cfg, t: int, remat: str = "none", stages: bool = False,
                 fsdp: Optional[str] = None) -> str:
    """``"sharded"`` when a training step can compute each rank's gradient
    on its model-axis shards (``t`` ranks), else ``"gathered (<reason>)"``:
    the step gathers the full params over the model axis first.
    ``stages``: a pipelined strategy; ``fsdp``: an FSDP axis that splits
    the params beside the model axis in the exchange."""
    why = []
    if stages:
        why.append("pipeline stages")
    if remat != "none":
        why.append(f"remat {remat!r}")
    if fsdp is not None:
        why.append(f"FSDP over {fsdp!r} beside the model axis")
    why += blockers(cfg, t)
    return "sharded" if not why else f"gathered ({'; '.join(why)})"


def local_config(cfg, t: int):
    """The config one of ``t`` model-axis ranks computes with: an LM's
    query heads and MLP width divided by ``t`` (the head width kept), its
    kv heads too where ``t`` divides them (a single one each rank keeps
    whole); as it is for a paper net (its forward reads the widths off
    the params), for the SSD and RG-LRU widths, which the tensor-parallel
    forms take from the axis, for the vocabulary and for the MoE: the
    capacity and the one-hots need the global expert count, and
    ``layers.moe_apply`` reads the rank's experts or ``d_expert`` slice
    off the params."""
    if t == 1 or cfg.family in ("mlp", "cnn"):
        return cfg
    kinds = set(cfg.attn_pattern)
    kw = {}
    if kinds & set(_ATTN_KINDS):
        kw.update(n_heads=cfg.n_heads // t, d_head=cfg.head_dim,
                  n_kv_heads=cfg.n_kv_heads // t if cfg.n_kv_heads % t == 0 else cfg.n_kv_heads)
    if kinds - {"ssd"}:
        kw["d_ff"] = cfg.d_ff // t
    return dataclasses.replace(cfg, **kw)


def local_model(model, axis: ModelAxis):
    """``model`` as one rank of ``axis`` computes it: its loss, prefill and
    decode run the tensor-parallel forward on the rank's shards."""
    from repro_torch.models import build

    return build(local_config(model.config, axis.size), remat=model.remat, tp=axis)
