"""Paged cache manager: request slots + the KV block pool.

PyTorch counterpart of ``repro.serving.kv_cache``, attention-arch subset.
``CachePool`` owns the device pool (``serving.blockpool``), the block
allocator and the slot free list.  Slots carry no device state for the
dense family (its only leaves are paged); they still bound concurrency and
name the scratch row grouped verification pads with.  Pool leaves are
updated in place.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.models.base import ModelConfig
from repro_torch.serving import blockpool
from repro_torch.serving.blockpool import BlockAllocator, Layout  # noqa: F401


class CachePool:
    """``num_slots`` request slots (+1 scratch) plus ``num_blocks`` KV blocks
    of ``block_size`` tokens (+ null + scratch blocks).  The default pool
    size is ``num_slots * ceil(capacity / block_size)`` blocks, the dense
    manager's footprint, as in the JAX package."""

    def __init__(
        self,
        cfg: ModelConfig,
        num_slots: int,
        capacity: int,
        *,
        device: torch.device,
        block_size: int = blockpool.DEFAULT_BLOCK_SIZE,
        num_blocks: Optional[int] = None,
    ):
        self.cfg = cfg
        self.num_slots = num_slots
        self.capacity = capacity
        self.device = device
        bpt = -(-capacity // block_size)
        if num_blocks is None:
            num_blocks = num_slots * bpt
        self.layout = blockpool.build_layout(cfg, capacity, block_size, num_blocks)
        self.data = blockpool.init_cache(cfg, self.layout, device)
        self.alloc_blocks = BlockAllocator(num_blocks)
        self._free: List[int] = list(range(num_slots))

    # -- slots ------------------------------------------------------------

    @property
    def scratch_slot(self) -> int:
        return self.num_slots

    def alloc(self) -> int:
        return self._free.pop(0)

    def free(self, slot: int) -> None:
        self._free.append(slot)

    def num_free(self) -> int:
        return len(self._free)

    # -- blocks -----------------------------------------------------------

    @property
    def paged(self) -> bool:
        return self.layout.has_paged

    @property
    def block_size(self) -> int:
        return self.layout.block_size

    @property
    def blocks_per_table(self) -> int:
        return self.layout.blocks_per_table

    def num_free_blocks(self) -> int:
        return self.alloc_blocks.num_free()

    def free_blocks(self, bids: List[int]) -> None:
        """Wipe + return zero-ref, uncached blocks to the free list."""
        if not bids:
            return
        blockpool.wipe_blocks(self.data, self.layout, bids)
        for bid in bids:
            self.alloc_blocks.release(bid)

    def table_array(self, blocks_list: Sequence[Sequence[int]]) -> torch.Tensor:
        """(B, blocks_per_table) int32 tables on the pool's device, ``-1``-padded."""
        nblk = self.layout.blocks_per_table
        rows = []
        for blocks in blocks_list:
            assert len(blocks) <= nblk, "block table exceeds view capacity"
            rows.append(list(blocks) + [-1] * (nblk - len(blocks)))
        return torch.tensor(rows, dtype=torch.int32, device=self.device)
