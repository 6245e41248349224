from .engine import BatchedServer, BuiltServe, Request, TickRecord, build_serve
from .paged_cache import (
    BlockAllocator,
    cache_bytes,
    cache_layout,
    paged_bits_per_token,
    release_blocks,
    reset_slots,
    select_slots,
)
from .scheduler import Scheduler, SlotEntry, TickPlan

__all__ = [
    "BatchedServer",
    "BlockAllocator",
    "BuiltServe",
    "Request",
    "Scheduler",
    "SlotEntry",
    "TickPlan",
    "TickRecord",
    "build_serve",
    "cache_bytes",
    "cache_layout",
    "paged_bits_per_token",
    "release_blocks",
    "reset_slots",
    "select_slots",
]
