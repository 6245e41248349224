"""Serving engine: continuous batching over ``decode_step``, on one device.

Port of ``repro/serve/engine.py`` (DESIGN.md §9). The JAX engine shards
params and cache over a mesh and jit-compiles one tick per width; the
port runs eagerly, a tick a plain call: on one device, or over a
(1, t) device mesh as t ranks of a tensor-parallel forward
(``build_serve``), each holding its shard of the params and its heads of
the cache, every rank running the same engine loop in lockstep.

:class:`BatchedServer` runs the vLLM-style loop: a FIFO request queue with
admission control, a :class:`~repro_torch.serve.scheduler.Scheduler`
driving per-slot positions through chunked prefill interleaved with
decode ticks, slot recycling that resets the recycled rows, and, for
models with global-attention layers, the paged KV cache
(``serve.paged_cache``): blocks allocated at admission, written through a
block table, quantized on write at the codec's wire dtype, and poisoned
when freed. For an SSD architecture every multi-token tick width is a
multiple of the SSD chunk (``_allowed_widths``), so a prefill tick runs
the chunked SSD (the CUDA chunk kernel on the card) in every layer, and a
width-1 tick the recurrent step.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models.model import Model

from .paged_cache import (
    BlockAllocator,
    cache_bytes,
    cache_layout,
    paged_bits_per_token,
    release_blocks,
    reset_slots,
    select_slots,
)
from .scheduler import PREFILL, Request, Scheduler, TickPlan

__all__ = ["BatchedServer", "BuiltServe", "Request", "TickRecord", "build_serve"]


class BuiltServe(NamedTuple):
    prefill: Callable            # (params, batch) -> (logits, cache)
    decode_step: Callable        # (params, cache, tokens, pos) -> (logits, cache)
    init_cache: Callable         # (batch, max_seq, device) -> cache
    init_paged_cache: Optional[Callable] = None   # None: nothing to page
    place: Callable = lambda params: params   # full params -> this rank's
    param_specs: Any = None      # dist.sharding specs of the params on the mesh


class TickRecord(NamedTuple):
    """What one engine tick ran: the slots reset before it, its plan, and
    the logits of the plan's tokens (B, width, vocab)."""

    admitted: List[int]
    plan: TickPlan
    logits: torch.Tensor


def build_serve(model: Model, mesh=None, fsdp: Optional[str] = None,
                tp: Optional[str] = None, dp: Optional[str] = "data",
                group=None) -> BuiltServe:
    """The serving functions of ``model``; over a mesh, port of
    ``repro/serve/engine.py::build_serve``: params placed by
    ``dist.sharding.param_specs``, the cache by each rank's model.

    Without a mesh, or on a ``StackedMesh`` (nothing split), the model's
    own functions. On a ``DeviceMesh`` over ``group``'s ranks with a
    ``tp`` axis of size t > 1, each rank holds its TP shard of the params
    (``place``: full params -> DTensors; the model is never gathered) and
    runs the tensor-parallel forward of ``models/lm.py`` on it, its cache
    (``tensor_parallel.local_model``'s ``init_cache``) holding its
    n_kv_heads / t heads (a single KV head whole, as ``cache_specs``
    keeps it) and its heads or channels of each recurrent state where the
    JAX package's ``cache_specs`` replicates them (ROADMAP §3): the SSD's
    ``h`` and the RG-LRU's ``h`` and ``conv``. Needs a model whose widths
    ``tensor_parallel.blockers`` accepts (the MoE's experts or
    ``d_expert`` divisible by t, ...; a vocabulary it does not divide
    stays whole on every rank), no FSDP and a data axis of size 1:
    anything else raises ``NotImplementedError`` (ROADMAP item 7c). The forward's collectives
    are ``dist.tensor_parallel.ModelAxis``'s, which training shares."""
    if model.decode_step is None:
        raise ValueError(f"{model.config.name}: the model has no decode step to serve")
    from repro_torch.launch.mesh import is_device_mesh

    if not is_device_mesh(mesh):
        pspecs = None
        if mesh is not None:
            from repro_torch.dist.sharding import param_specs

            pspecs = param_specs(model.init(torch.Generator().manual_seed(0), device="meta"),
                                 mesh, fsdp, tp)
        return BuiltServe(model.prefill, model.decode_step, model.init_cache,
                          model.init_paged_cache, param_specs=pspecs)
    return _build_tp_serve(model, mesh, fsdp, tp, dp, group)


def _build_tp_serve(model: Model, mesh, fsdp, tp, dp, group) -> BuiltServe:
    from repro_torch.comm.process_group import axis_group
    from repro_torch.core.types import tree_flatten, tree_unflatten
    from repro_torch.dist import tensor_parallel
    from repro_torch.dist.sharding import is_spec, param_specs, place
    from repro_torch.dist.strategy import axis_sizes

    if group is None:
        raise ValueError("a DeviceMesh needs the WorkerGroup of its ranks (group=...)")
    cfg = model.config
    sizes = axis_sizes(mesh)
    t = sizes.get(tp, 1) if tp else 1
    why = []
    if fsdp is not None and sizes.get(fsdp, 1) > 1:
        why.append(f"FSDP over {fsdp!r}")
    if dp is not None and sizes.get(dp, 1) > 1:
        why.append(f"rows over the {dp!r} axis")
    if t > 1:
        why += [f"{cfg.name}: {w}" for w in tensor_parallel.blockers(cfg, t)]
    if why:
        raise NotImplementedError("serving over this mesh: " + "; ".join(why)
                                  + " (ROADMAP item 7c)")
    pspecs = param_specs(model.init(torch.Generator().manual_seed(0), device="meta"),
                         mesh, fsdp, tp)
    if t == 1:
        local_model = model
    else:
        local_model = tensor_parallel.local_model(
            model, tensor_parallel.ModelAxis(axis_group(group, mesh, tp), tp))

    def local(params):
        return tree_map(lambda x: x.to_local() if hasattr(x, "to_local") else x, params)

    def place_params(params):
        leaves, treedef = tree_flatten(params)
        specs = tree_leaves(pspecs, is_leaf=is_spec)
        return tree_unflatten(treedef, [place(x, sp, mesh) for x, sp in zip(leaves, specs)])

    return BuiltServe(
        prefill=lambda params, batch: local_model.prefill(local(params), batch),
        decode_step=lambda params, cache, tokens, pos: local_model.decode_step(
            local(params), cache, tokens, pos),
        init_cache=local_model.init_cache, init_paged_cache=local_model.init_paged_cache,
        place=place_params, param_specs=pspecs)


def _allowed_widths(cfg: ModelConfig, prefill_chunk: int) -> Tuple[int, ...]:
    """Tick widths the arch can execute: prefill_chunk halved down to 1.
    SSD archs additionally require every multi-token width to be a multiple
    of the SSD scan chunk (``ssd_chunked`` raises on seq % chunk != 0)."""
    ws = set()
    w = max(1, int(prefill_chunk))
    while w >= 1:
        ws.add(w)
        w //= 2
    if "ssd" in cfg.attn_pattern:
        c = cfg.ssm.chunk_size
        ws = {w for w in ws if w == 1 or w % c == 0}
    return tuple(sorted(ws, reverse=True))


class BatchedServer:
    """Continuous-batching server over a fixed decode batch size.

    Greedy sampling (argmax). The cache lives on the params' device.
    ``paged=None`` enables the paged KV cache when the model has
    global-attention layers to page (``cache_dtype`` then selects the
    blocks' wire dtype; ``None`` = compute dtype, bitwise the dense
    cache); ``paged=True`` on a model with nothing to page raises
    ``ValueError``. ``num_blocks`` defaults to the dense-equivalent pool,
    ``batch_size * max_seq // block_size``."""

    def __init__(self, serve: BuiltServe, params, cfg: ModelConfig,
                 batch_size: int, max_seq: int, *,
                 paged: Optional[bool] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 cache_dtype: Optional[str] = None,
                 prefill_chunk: int = 8, max_queue: Optional[int] = None):
        if paged is None:
            paged = serve.init_paged_cache is not None
        if paged and serve.init_paged_cache is None:
            raise ValueError(f"{cfg.name}: no global-attention layers to page")
        self.serve = serve
        self.params = params
        self.cfg = cfg
        self.batch = batch_size
        self.max_seq = max_seq
        self.max_queue = max_queue
        self.paged = paged
        self.layout = cache_layout(cfg, cache_dtype if paged else None)
        self.device = tree_leaves(params)[0].device
        self.allocator: Optional[BlockAllocator] = None
        if paged:
            if max_seq % block_size:
                raise ValueError(f"max_seq {max_seq} % block_size {block_size}")
            nb_seq = max_seq // block_size
            if num_blocks is None:
                num_blocks = batch_size * nb_seq       # dense-equivalent pool
            self.allocator = BlockAllocator(num_blocks, block_size)
            self.cache = serve.init_paged_cache(batch_size, max_seq, num_blocks, block_size,
                                                self.layout.wire_dtype, self.device)
            # the host's copy of the block table, written at admission
            self._bt = np.full((batch_size, nb_seq), -1, np.int32)
        else:
            self.cache = serve.init_cache(batch_size, max_seq, self.device)
        self.scheduler = Scheduler(
            batch_size, max_seq, widths=_allowed_widths(cfg, prefill_chunk),
            allocator=self.allocator,
        )
        self.completed: List[dict] = []
        self.last_tick: Optional[TickRecord] = None
        self.stats = {
            "ticks": 0, "prefill_tokens": 0, "decode_tokens": 0,
            "cache_bytes": cache_bytes(self.cache),
        }

    # -- request lifecycle ---------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request. Raises ValueError when it can never fit
        (prompt + max_new - 1 > max_seq); returns False when the queue is
        at ``max_queue`` (backpressure), True otherwise."""
        self.scheduler.validate(req)
        if self.max_queue is not None and len(self.scheduler.queue) >= self.max_queue:
            return False
        self.scheduler.submit(req)
        return True

    def _admit(self) -> List[int]:
        admitted = self.scheduler.admit()
        if admitted:
            # recycle the slots: pos rows -> -1, recurrent rows -> 0, so the
            # new occupant can never read the previous one's cache
            mask = torch.zeros((self.batch,), dtype=torch.bool)
            mask[admitted] = True
            self.cache = reset_slots(self.cache, mask.to(self.device))
            if self.paged:
                for i in admitted:
                    blocks = self.scheduler.slots[i].blocks
                    self._bt[i] = -1
                    self._bt[i, :len(blocks)] = blocks
                self.cache["bt"] = torch.from_numpy(self._bt.copy()).to(self.device)
        return admitted

    def tick(self) -> bool:
        """One engine step: admit, plan, run, commit. False when idle."""
        admitted = self._admit()
        plan = self.scheduler.plan()
        if plan is None:
            return False
        prompt_fed = sum(
            plan.width for i in plan.active
            if self.scheduler.slots[i].state == PREFILL
        )
        tokens = torch.from_numpy(plan.tokens).to(self.device)
        pos = torch.from_numpy(plan.pos).to(self.device)
        logits, new_cache = self.serve.decode_step(self.params, self.cache, tokens, pos)
        self.cache = select_slots(new_cache, self.cache, pos >= 0)
        sampled = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        self.last_tick = TickRecord(admitted, plan, logits)
        completions, freed = self.scheduler.apply(plan, sampled)
        self.completed.extend(completions)
        if freed:
            # poison the freed blocks' position rows; table rows are
            # rewritten at the slot's next admission
            self.allocator.free(freed)
            self.cache = release_blocks(self.cache, freed)
        self.stats["ticks"] += 1
        self.stats["prefill_tokens"] += prompt_fed
        self.stats["decode_tokens"] += len(plan.samplers)
        return True

    def drain(
        self, max_ticks: int = 10000, strict: bool = False
    ) -> Tuple[List[dict], List[int]]:
        """Run until idle or ``max_ticks``. Returns ``(completed, pending)``
        where ``pending`` is the uids still in flight or queued — never a
        silent truncation. ``strict=True`` raises instead when the tick
        budget expires with work outstanding."""
        t = 0
        while self.scheduler.n_pending > 0 and t < max_ticks:
            if not self.tick():
                break
            t += 1
        pending = self.scheduler.pending_uids()
        if strict and pending:
            raise RuntimeError(
                f"drain: {len(pending)} requests unfinished after "
                f"{max_ticks} ticks (uids {pending})"
            )
        return self.completed, pending

    # -- accounting ----------------------------------------------------

    def cache_stats(self) -> dict:
        """Cache memory and wire accounting: with the paged cache, the
        blocks pinned at peak against the dense-equivalent cache."""
        out = dict(self.stats)
        out["paged"] = self.paged
        out["cache_dtype"] = self.layout.wire_dtype
        if self.paged:
            bits_tok = paged_bits_per_token(self.cfg, self.layout)
            al = self.allocator
            out["kv_bits_per_token"] = bits_tok
            out["block_high_water"] = al.high_water
            out["num_blocks"] = al.num_blocks
            out["high_water_bytes"] = al.high_water * al.block_size * bits_tok / 8
            out["dense_equiv_bytes"] = self.batch * self.max_seq * bits_tok / 8
        return out
