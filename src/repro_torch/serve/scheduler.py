"""Slot scheduler for the continuous-batching serve engine.

Port of ``repro/serve/scheduler.py``: host-side numpy, the same module.

Request lifecycle (DESIGN.md §9): ``queued -> prefill -> decode -> done``.
Admission is all-or-nothing — a request enters a slot only when a slot is
free AND (paged mode) its full block budget ``ceil((prompt + max_new - 1)
/ block_size)`` is allocatable, so an admitted request can never stall
mid-flight on cache capacity.

Every engine tick has a *width* w (tokens fed per active slot):

- ``w == 1`` — a decode tick. Every slot with a pending token participates:
  decode slots feed their last sampled token, prefill slots feed their next
  prompt token.
- ``w > 1`` — a chunked-prefill tick. Only prefill slots with at least w
  prompt tokens remaining participate (a partial chunk would scatter
  padding into live cache positions); decode slots are frozen for the tick
  (position -1: the model drops their writes and masks their reads).

Chunked prefill interleaves with decoding by fairness flag: after any
chunked tick, the next tick is forced to width 1 whenever a decode slot is
waiting, so admitting a long prompt can at most double the latency between
two decode tokens rather than stalling them for the whole prefill.

A prefill slot whose remaining prompt is exactly the tick width completes
prefill in that tick and consumes the tick's sample (the last prompt
token's logits ARE the first generated token's distribution) — prefill
needs no extra "first decode" tick.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .paged_cache import BlockAllocator

QUEUED, PREFILL, DECODE, DONE = "queued", "prefill", "decode", "done"


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16


@dataclass
class SlotEntry:
    req: Request
    state: str = PREFILL
    n_fed: int = 0                # tokens committed to the cache so far
    generated: List[int] = field(default_factory=list)
    blocks: List[int] = field(default_factory=list)

    @property
    def prompt_remaining(self) -> int:
        return len(self.req.prompt) - self.n_fed


@dataclass
class TickPlan:
    width: int
    tokens: np.ndarray            # (B, width) int32, zeros on frozen slots
    pos: np.ndarray               # (B,) int32 base positions, -1 frozen
    active: List[int]             # slot indices participating this tick
    samplers: List[int]           # slots consuming sampled[slot] this tick


class Scheduler:
    """Host-side request queue + slot state machine.

    Owns no device state: the engine passes its plans to the model and
    feeds the sampled tokens back through :meth:`apply`."""

    def __init__(
        self,
        batch_size: int,
        max_seq: int,
        widths: Sequence[int] = (1,),
        allocator: Optional[BlockAllocator] = None,
    ):
        self.batch = batch_size
        self.max_seq = max_seq
        self.widths = tuple(sorted(set(int(w) for w in widths), reverse=True))
        assert self.widths and self.widths[-1] == 1, self.widths
        self.allocator = allocator
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[SlotEntry]] = [None] * batch_size
        self._decode_due = False

    # -- admission -----------------------------------------------------

    def cache_tokens(self, req: Request) -> int:
        """Cache positions a request occupies: the final sampled token is
        returned but never fed, so it needs no slot."""
        return len(req.prompt) + req.max_new_tokens - 1

    def validate(self, req: Request) -> None:
        if len(req.prompt) < 1 or req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: empty prompt or max_new < 1")
        need = self.cache_tokens(req)
        if need > self.max_seq:
            raise ValueError(
                f"request {req.uid}: needs {need} cache tokens > max_seq "
                f"{self.max_seq} — would silently overwrite its own cache"
            )

    def submit(self, req: Request) -> None:
        self.validate(req)
        self.queue.append(req)

    def admit(self) -> List[int]:
        """Move queued requests into free slots (and, paged, allocate their
        full block budget). Returns the slot indices admitted this call —
        the engine must reset those cache rows before the next tick."""
        admitted = []
        for i in range(self.batch):
            if not self.queue or self.slots[i] is not None:
                continue
            req = self.queue[0]
            blocks: List[int] = []
            if self.allocator is not None:
                need = self.allocator.blocks_for(self.cache_tokens(req))
                if not self.allocator.can_allocate(need):
                    break  # FIFO: don't let small requests starve the head
                blocks = self.allocator.allocate(need)
            self.queue.popleft()
            self.slots[i] = SlotEntry(req=req, blocks=blocks)
            admitted.append(i)
        return admitted

    # -- planning ------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def n_pending(self) -> int:
        return self.n_active + len(self.queue)

    def pending_uids(self) -> List[int]:
        return [s.req.uid for s in self.slots if s is not None] + [
            r.uid for r in self.queue
        ]

    def _pick_width(self) -> int:
        any_decode = any(s and s.state == DECODE for s in self.slots)
        if self._decode_due and any_decode:
            return 1
        for w in self.widths:
            if w == 1:
                break
            if any(
                s and s.state == PREFILL and s.prompt_remaining >= w
                for s in self.slots
            ):
                return w
        return 1

    def plan(self) -> Optional[TickPlan]:
        if self.n_active == 0:
            return None
        w = self._pick_width()
        tokens = np.zeros((self.batch, w), np.int32)
        pos = np.full((self.batch,), -1, np.int32)
        active: List[int] = []
        samplers: List[int] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if s.state == PREFILL:
                if s.prompt_remaining < w:
                    continue  # frozen: partial chunks don't participate
                tokens[i] = s.req.prompt[s.n_fed : s.n_fed + w]
                pos[i] = s.n_fed
                active.append(i)
                if s.prompt_remaining == w:
                    samplers.append(i)
            else:  # DECODE: one pending token, only fits a width-1 tick
                if w != 1:
                    continue
                tokens[i, 0] = s.generated[-1]
                pos[i] = s.n_fed
                active.append(i)
                samplers.append(i)
        # a chunked tick skipped the decode slots: they go first next tick
        self._decode_due = w > 1
        return TickPlan(width=w, tokens=tokens, pos=pos,
                        active=active, samplers=samplers)

    # -- commit --------------------------------------------------------

    def apply(
        self, plan: TickPlan, sampled: np.ndarray
    ) -> Tuple[List[dict], List[int]]:
        """Advance slot state by one executed tick. ``sampled`` is the
        (B,)-shaped greedy sample of the tick's last-column logits. Returns
        ``(completions, freed_blocks)``; completed slots are already freed
        (the engine resets their cache rows on the next admission)."""
        completions: List[dict] = []
        freed: List[int] = []
        for i in plan.active:
            s = self.slots[i]
            s.n_fed += plan.width if s.state == PREFILL else 1
            if i in plan.samplers:
                s.state = DECODE
                s.generated.append(int(sampled[i]))
                if len(s.generated) >= s.req.max_new_tokens:
                    completions.append(
                        {"uid": s.req.uid, "tokens": list(s.generated)}
                    )
                    freed.extend(s.blocks)
                    self.slots[i] = None
        return completions, freed
