"""Decoder-only LM assembly: a loop over stacked layer units, with decode
caches and the VLM prefix-embedding stub. Port of ``repro/models/lm.py``.

Layers are grouped into repeating *units* (``cfg.attn_pattern``); the
params of unit position j are stacked over the ``n_units`` repeats along a
new leading dim (``params["unit"][j]``), as in the JAX package, and the
forward loops over that dim where the JAX package scans. Layers left over
after the last full unit sit unstacked in ``params["rem"]``.

Layer kinds, all of the JAX package's: ``"ssd"`` (Mamba-2), ``"global"``
(GQA attention on a dense or paged KV cache), ``"swa"`` and ``"local"``
(sliding-window attention on a dense ring of ``min(max_seq, 2 * window)``
slots, which stays dense inside a paged cache) and ``"rglru"`` (the
RG-LRU recurrent block, ``models/rglru.py``, with a (B, W) state and the
conv's trailing inputs). Every kind but ``"ssd"`` is followed by an MLP
or, with ``cfg.moe``, the MoE.

Tensor parallelism (serving over a mesh, ``serve.engine.build_serve``,
and training over a model axis, ``train/step.py``): with ``tp`` (a
``dist.tensor_parallel.ModelAxis``) the params are this rank's shards
along the model axis (the specs of ``dist.sharding.param_specs``) and
``cfg`` counts this rank's heads and MLP width. ``tp.embed`` looks up the
rank's slice of the vocabulary-parallel table and sums the slices,
``tp.copy_to`` hands the replicated normed input to the column-parallel
``wq/wk/wv`` and ``w_gate/w_up`` (its backward sums the ranks'
cotangents), ``tp.reduce`` sums the row-parallel outputs (``wo``,
``w_down``) over the ranks, and ``tp.logits`` gathers the column-parallel
head's slices (training's loss takes the rank's slice itself:
``model.chunked_ce``). A vocabulary that the axis does not divide leaves
the embedding and the head whole on every rank (``param_specs``): the
rank looks up the whole table with no ``reduce`` and computes the whole
logits with no gather (the residual stream's cotangent is whole on every
rank already). The attention kinds (their KV heads split, or whole on
every rank where the axis does not divide them), the SSD and the RG-LRU
layers and the MoE have tensor-parallel forms (``layers.attention_apply``,
``ssd.ssd_block_apply``, ``rglru.rglru_block_apply``,
``layers.moe_apply``: expert-parallel, or split over ``d_expert``), each
returning its rank's partial of the layer's output for ``tp.reduce``; the
recurrent layers' decode state holds the rank's heads or channels
(``lm_init_cache(..., tp_size=t)``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import dtype_of, tree_flatten, tree_leaves, tree_map, tree_unflatten

from . import layers as L
from . import remat as REMAT
from . import rglru as R
from . import ssd as S

Params = Any
_KINDS = ("ssd", "global", "swa", "local", "rglru")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# layer unit
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig, kind: str, device=None) -> Params:
    _check_kind(kind)
    p: dict = {"norm1": L.rmsnorm_init(cfg.d_model, torch.float32, device)}
    if kind == "ssd":   # mamba2 blocks have no separate MLP
        p["ssd"] = S.ssd_block_init(gen, cfg, device)
        return p
    if kind == "rglru":
        p["rglru"] = R.rglru_block_init(gen, cfg, device)
    else:
        p["attn"] = L.attention_init(gen, cfg, device)
    p["norm2"] = L.rmsnorm_init(cfg.d_model, torch.float32, device)
    if cfg.moe is not None:
        p["moe"] = L.moe_init(gen, cfg, device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, device=device)
    return p


def _layer_state_init(cfg: ModelConfig, kind: str, batch: int, max_seq: int, device=None,
                      tp_size: int = 1):
    """Decode-time per-layer state: the SSD or RG-LRU state (one of
    ``tp_size`` model-axis ranks' share), or a dense KV cache with a
    per-slot position table (slots advance independently under the
    continuous-batching engine, DESIGN.md §9). A windowed layer keeps a
    ring of ``min(max_seq, 2 * window)`` slots."""
    _check_kind(kind)
    if kind == "ssd":
        return S.ssd_init_state(cfg, batch, device, tp_size)
    if kind == "rglru":
        return R.rglru_init_state(cfg, batch, device, tp_size)
    cache_len = max_seq if kind == "global" else min(max_seq, cfg.window * 2)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    dt = L._dtype(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def _layer_apply(params: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 positions: Optional[torch.Tensor] = None, state=None,
                 use_kernel: bool = False, block_table=None, tp=None):
    _check_kind(kind)
    reduce = (lambda y: y) if tp is None else tp.reduce
    copy_to = (lambda y: y) if tp is None else tp.copy_to
    h = copy_to(L.rmsnorm(params["norm1"], x, cfg.norm_eps))
    if kind == "ssd":   # no MLP
        out, new_state = S.ssd_block_apply(params["ssd"], cfg, h, state, use_kernel, tp)
        return x + reduce(out), new_state
    if kind == "rglru":
        out, new_state = R.rglru_block_apply(params["rglru"], cfg, h, state, tp)
    else:
        out, new_state = L.attention_apply(params["attn"], cfg, h, positions, kind=kind,
                                           cache=state, block_table=block_table, tp=tp)
    x = x + reduce(out)
    h2 = copy_to(L.rmsnorm(params["norm2"], x, cfg.norm_eps))
    if cfg.moe is not None:
        return x + reduce(L.moe_apply(params["moe"], cfg, h2, tp=tp)), new_state
    return x + reduce(L.mlp_apply(params["mlp"], cfg, h2)), new_state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _unit_layout(cfg: ModelConfig):
    u = len(cfg.attn_pattern)
    n_units = cfg.n_layers // u
    rem = cfg.n_layers - n_units * u
    return u, n_units, rem


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _stacked_init(make, n: int):
    """``_stack([make() for _ in range(n)])`` without holding the n
    unstacked trees: each is copied into its row and dropped, so a
    full-width init peaks at the stacked leaves plus one layer."""
    tree = make()
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), tree)
    for i in range(n):
        if i:
            tree = make()
        for o, x in zip(tree_leaves(out), tree_leaves(tree)):
            o[i].copy_(x)
    return out


def lm_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    if cfg.is_encdec or cfg.frontend not in (None, "patch_embed"):
        raise ValueError(f"{cfg.name}: not a decoder-only LM (models/encdec.py builds "
                         "encoder-decoders)")
    u, n_units, rem = _unit_layout(cfg)
    params: dict = dict(L.embed_init(gen, cfg, device))
    # stacked unit params: for each position j in the unit, leaves stacked
    # over n_units along a new leading dim
    params["unit"] = [
        _stacked_init(lambda: _layer_init(gen, cfg, cfg.attn_pattern[j], device), n_units)
        for j in range(u)
    ]
    params["rem"] = [_layer_init(gen, cfg, cfg.attn_pattern[j], device) for j in range(rem)]
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, torch.float32, device)
    if not cfg.tie_embeddings:
        params.update(L.lm_head_init(gen, cfg, device))
    return params


def lm_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
                  tp_size: int = 1) -> Any:
    """The dense decode cache; ``tp_size``: one model-axis rank's (its
    share of each recurrent state; ``cfg`` counts its KV heads)."""
    u, n_units, rem = _unit_layout(cfg)
    unit = [
        tree_map(lambda x: x.expand((n_units,) + x.shape).contiguous(),
                 _layer_state_init(cfg, cfg.attn_pattern[j], batch, max_seq, device, tp_size))
        for j in range(u)
    ]
    remst = [_layer_state_init(cfg, cfg.attn_pattern[j], batch, max_seq, device, tp_size)
             for j in range(rem)]
    return {"unit": unit, "rem": remst}


def lm_init_paged_cache(cfg: ModelConfig, batch: int, max_seq: int, num_blocks: int,
                        block_size: int, cache_dtype=None, device=None,
                        tp_size: int = 1) -> Any:
    """Paged decode cache (DESIGN.md §9).

    Global-attention layers store K/V in a pool of ``num_blocks`` blocks,
    (num_blocks, block_size, Hkv, Dh) per layer, addressed through ONE
    per-sequence block table ``"bt"`` (batch, max_seq // block_size; -1 =
    unassigned): token t of slot b lives at block ``bt[b, t //
    block_size]``, offset ``t % block_size``, in every layer's own pool.
    Windowed rings and recurrent states are bounded per slot already and
    stay dense. ``cache_dtype`` is the codec's wire dtype (None: the
    compute dtype, bitwise the dense cache)."""
    if max_seq % block_size:
        raise ValueError(f"max_seq {max_seq} is not a multiple of block_size {block_size}")
    u, n_units, rem = _unit_layout(cfg)
    dt = dtype_of(cache_dtype or cfg.compute_dtype)

    def st(kind):
        if kind != "global":
            return _layer_state_init(cfg, kind, batch, max_seq, device, tp_size)
        shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
        return {
            "pk": torch.zeros(shape, dtype=dt, device=device),
            "pv": torch.zeros(shape, dtype=dt, device=device),
            "ppos": torch.full((num_blocks, block_size), -1, dtype=torch.int32,
                               device=device),
        }

    unit = [tree_map(lambda x: x.expand((n_units,) + x.shape).contiguous(),
                     st(cfg.attn_pattern[j])) for j in range(u)]
    return {
        "unit": unit,
        "rem": [st(cfg.attn_pattern[j]) for j in range(rem)],
        "bt": torch.full((batch, max_seq // block_size), -1, dtype=torch.int32,
                         device=device),
    }


def _positions(seq: int, cache_pos, device) -> torch.Tensor:
    """(S,) positions from a scalar ``cache_pos`` (None = 0), or (B, S)
    from a per-slot (B,) vector; frozen rows (cache_pos < 0) are pushed to
    -2**30 so every position of the row stays negative, not just the
    first."""
    t = torch.arange(seq, device=device)
    if cache_pos is None:
        return t
    cp = torch.as_tensor(cache_pos, device=device)
    if cp.dim():
        cp = torch.where(cp < 0, -(2 ** 30), cp.to(torch.int64))
        return cp[:, None] + t
    return cp + t


def _unstack(stack, n: int) -> list:
    """The ``n`` layers' trees of a tree stacked on a leading layer dim,
    each leaf unbound once: its backward stacks the layers' gradients once,
    where ``a[i]`` per layer fills a full-size zero gradient per layer
    (under ``vmap(grad)`` one per worker) and sums ``n`` of them."""
    leaves, treedef = tree_flatten(stack)
    cols = [a.unbind(0) for a in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


def lm_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,               # (B, S)
    prefix_embeds: Optional[torch.Tensor] = None,   # VLM stub: (B, Np, d)
    cache: Optional[Any] = None,
    cache_pos=None,                     # decode write position: scalar or (B,)
    use_kernel: bool = False,
    return_hidden: bool = False,
    tp=None,
    remat: str = "none",
):
    """Returns ``(logits-or-hidden, new_cache_or_None)``.

    ``cache_pos`` may be a per-slot (B,) vector (continuous batching):
    each row's tokens then sit at positions ``cache_pos[b] + arange(S)``;
    rows with ``cache_pos[b] < 0`` are frozen (attention cache writes
    dropped, outputs discarded by the caller; a recurrent layer's rows are
    restored by ``serve.paged_cache.select_slots``). ``use_kernel`` selects
    the SSD chunk kernel path of ``models/ssd.py``. A paged cache carries
    its block table under a top-level ``"bt"`` key: the pool places of
    this forward's tokens are computed from it once (``layers.
    paged_index``) for every attention layer, and the table is returned in
    the new cache. No ``.item()`` and
    no branch on tensor values: the forward runs under ``torch.func.vmap``.
    ``tp``: this rank's shards of a tensor-parallel forward (module
    docstring). ``remat`` (``"none" | "full" | "dots"``, the last run as
    ``"full"``) recomputes each unit (one period of ``attn_pattern``) in
    the backward (``models/remat.py``), as the JAX package's
    ``_stack_body`` checkpoints it; a forward with a cache takes no
    gradient and ignores it.
    """
    block_table = cache.get("bt") if isinstance(cache, dict) else None
    if tp is None or params["embed"].shape[0] == cfg.vocab_size:   # a whole table
        x = L.embed_apply(params, cfg, tokens)
    else:
        x = tp.embed(params["embed"], tokens).to(L._dtype(cfg))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = _positions(x.shape[1], cache_pos, x.device)
    paged = None
    if block_table is not None:
        # where this forward's tokens go in the pools: the same in every layer
        ppos = next(st["ppos"] for st in cache["unit"] + cache["rem"] if "ppos" in st)
        paged = L.paged_index(block_table, L.positions_2d(positions, x.shape[0]),
                              *ppos.shape[-2:])
    u, n_units, rem = _unit_layout(cfg)

    states = [[] for _ in range(u)]     # states[j][i]: unit i, position j
    layers = [_unstack(params["unit"][j], n_units) for j in range(u)]   # [j][i]
    if cache is None and remat != "none":
        def unit_body(x, unit_params):
            # tensors the recompute reads are made inside it, not captured
            pos = _positions(x.shape[1], None, x.device)
            for j in range(u):
                x, _ = _layer_apply(unit_params[j], cfg, cfg.attn_pattern[j], x, pos,
                                    None, use_kernel, None, tp)
            return x

        body = REMAT.checkpoint(unit_body, remat)
        for i in range(n_units):
            x = body(x, [layers[j][i] for j in range(u)])
    else:
        for i in range(n_units):
            for j in range(u):
                st = None if cache is None else tree_map(lambda a: a[i], cache["unit"][j])
                x, ns = _layer_apply(layers[j][i], cfg, cfg.attn_pattern[j], x, positions, st,
                                     use_kernel, paged, tp)
                states[j].append(ns)
    new_unit_cache = None
    if cache is not None:
        new_unit_cache = [_stack(s) for s in states] if n_units else []

    new_rem = []
    for j in range(rem):
        st = None if cache is None else cache["rem"][j]
        x, ns = _layer_apply(params["rem"][j], cfg, cfg.attn_pattern[j], x, positions, st,
                             use_kernel, paged, tp)
        new_rem.append(ns)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_cache = None
    if cache is not None:
        new_cache = {"unit": new_unit_cache, "rem": new_rem}
        if block_table is not None:
            new_cache["bt"] = block_table
    if return_hidden:
        return x, new_cache
    if cfg.tie_embeddings:
        logits = x.float() @ params["embed"].t().float()
    else:
        logits = L.lm_head_apply(params, cfg, x)
    if tp is not None and logits.shape[-1] < cfg.vocab_size:
        logits = tp.logits(logits)
    return logits, new_cache
