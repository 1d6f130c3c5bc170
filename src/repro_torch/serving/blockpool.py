"""Fixed-size KV block pool: allocator + block-indexed device cache layout.

PyTorch counterpart of ``repro.serving.blockpool``, attention-arch subset:
every full-attention leaf (``k``/``v``/``pos``) is cut into one global pool
of ``block_size``-token blocks, ``(layers, num_blocks + 2, block_size,
...)``, addressed through per-request block tables.  Two sentinel blocks
close the pool: ``null`` (frozen, ``pos == -1``; ``-1`` table entries read
it) and ``scratch`` (absorbs writes past a table; never read).

The JAX package threads an immutable pool through every step; here the
leaves are updated in place (the forward writes through the tables,
``wipe_blocks`` resets freed blocks' positions).  Slot-shaped leaves
(recurrent state, sliding rings, cross caches) belong to families not yet
ported, so this pool holds paged leaves only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Set

import torch

from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import cache_spec

#: default KV block size (tokens per block)
DEFAULT_BLOCK_SIZE = 16


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static description of the paged cache layout."""

    block_size: int
    num_blocks: int  # real allocatable blocks (excludes null + scratch)
    blocks_per_table: int  # table width: ceil(capacity / block_size)
    has_paged: bool = True

    @property
    def null_bid(self) -> int:
        return self.num_blocks

    @property
    def scratch_bid(self) -> int:
        return self.num_blocks + 1

    @property
    def view_capacity(self) -> int:
        return self.blocks_per_table * self.block_size


def build_layout(
    cfg: ModelConfig, capacity: int, block_size: int, num_blocks: int
) -> Layout:
    if block_size < 1:
        raise ValueError(f"block_size {block_size} must be >= 1")
    return Layout(block_size=block_size, num_blocks=num_blocks,
                  blocks_per_table=-(-capacity // block_size))


def init_cache(cfg: ModelConfig, lay: Layout, device: torch.device) -> Any:
    """Device storage: every leaf of ``cache_spec`` with its (batch,
    capacity) axes replaced by (num_blocks + 2, block_size); positions
    start at -1 (empty)."""
    spec = cache_spec(cfg, 1, 1)

    def make(leaf):
        if isinstance(leaf, dict):
            return {k: make(v) for k, v in leaf.items()}
        shape, dtype = leaf
        shape = (shape[0], lay.num_blocks + 2, lay.block_size) + shape[3:]
        if dtype == torch.int32:
            return torch.full(shape, -1, dtype=dtype, device=device)
        return torch.zeros(shape, dtype=dtype, device=device)

    return make(spec)


def wipe_blocks(pool: Any, lay: Layout, bids: List[int]) -> Any:
    """Reset freed blocks' positions to -1 in place, so stale absolute
    positions never mask into a future owner's attention."""
    if not bids:
        return pool
    pos = pool["blocks"]["0"]["pos"]
    pos[:, torch.tensor(bids, dtype=torch.long, device=pos.device)] = -1
    return pool


# ---------------------------------------------------------------------------
# host-side allocator
# ---------------------------------------------------------------------------


class BlockAllocator:
    """Ref-counted free-list allocator over ``num_blocks`` block ids.

    ``cached`` marks blocks registered with the prefix cache: their
    refcount reaching zero leaves them *resident* (evictable by the cache's
    LRU policy) instead of free.  The allocator never touches the device —
    the cache pool wipes freed blocks before reuse.
    """

    def __init__(self, num_blocks: int):
        assert num_blocks >= 1
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.refs: List[int] = [0] * num_blocks
        self.cached: Set[int] = set()
        self.peak_in_use = 0
        # allocation-churn telemetry (obs.metrics gauges)
        self.num_allocs = 0
        self.num_frees = 0

    def num_free(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def num_evictable(self) -> int:
        """Cached blocks no live request references — reclaimable."""
        return sum(1 for b in self.cached if self.refs[b] == 0)

    def available(self) -> int:
        """Free now plus reclaimable-by-eviction."""
        return self.num_free() + self.num_evictable()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        bid = self._free.pop()
        assert self.refs[bid] == 0 and bid not in self.cached
        self.refs[bid] = 1
        self.num_allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use())
        return bid

    def incref(self, bid: int) -> None:
        self.refs[bid] += 1

    def decref(self, bid: int) -> int:
        assert self.refs[bid] > 0, f"double free of block {bid}"
        self.refs[bid] -= 1
        return self.refs[bid]

    def release(self, bid: int) -> None:
        """Return a zero-ref, uncached block to the free list."""
        assert self.refs[bid] == 0 and bid not in self.cached
        self.num_frees += 1
        self._free.append(bid)
