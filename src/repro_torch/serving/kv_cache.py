"""Paged cache manager: request slots + the KV block pool.

PyTorch counterpart of ``repro.serving.kv_cache``, attention, rwkv,
hybrid and encoder-decoder archs.  ``CachePool`` owns the device pool
(``serving.blockpool``), the block allocator and the slot free list.
Full-attention KV is paged; slots hold the slot-kind leaves
(sliding-window rings, recurrent state) and the read-only cross caches,
one row each plus the scratch row grouped verification pads with, and
bound concurrency.  A freed slot is wiped.  Pool leaves are updated in
place.

``pool_forward`` runs one forward pass over the pool in either memory
lane: the paged lane row-packs the slot leaves by ``slots`` and reads and
writes paged leaves in place through the block tables
(``models.layers.attention_paged``); the gathered lane
(``paged_attention=False``) gathers per-row views, runs the dense forward
on them and scatters them back, as the JAX engine's legacy path does.  A
pool with slot leaves only (a sliding or an rwkv config) has no paged
lane.  ``pool_views`` and ``pool_writeback`` are its two halves, for
callers that run their own forward between them (``core.verifier``'s
recurrent replay).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.determinism import Schedule
from repro_torch.models.base import ModelConfig
from repro_torch.models.layers import PagedView
from repro_torch.models.transformer import forward
from repro_torch.serving import blockpool, statepool
from repro_torch.serving.blockpool import BlockAllocator, Layout  # noqa: F401

#: gathered-lane entry points (slot + block-table addressing)
gather = blockpool.gather
scatter = blockpool.scatter

#: paged-lane entry points: slot leaves row-packed, paged leaves whole
gather_mixed = blockpool.gather_mixed
scatter_mixed = blockpool.scatter_mixed


def slot_index(pool: Any, lay: Layout, slots: Sequence[int],
               device: torch.device) -> torch.Tensor:
    """``slots`` as a device index, after ``blockpool.check_slots``: no
    real slot may take two rows of one pass's scatter."""
    scratch = blockpool.scratch_slot(pool, lay)
    if scratch is not None:
        blockpool.check_slots(slots, scratch)
    return torch.as_tensor(list(slots), dtype=torch.long, device=device)


def pool_views(pool: Any, lay: Layout, idx: torch.Tensor, tables: torch.Tensor,
               *, paged: bool) -> Any:
    """The cache tree a forward over rows ``idx`` reads: slot leaves
    row-packed (copies) and paged leaves whole (``paged=True``), or
    ``(layers, B, view_capacity, ...)`` views gathered through ``tables``."""
    if paged:
        assert lay.has_paged, "a pool without paged leaves has no paged lane"
        return gather_mixed(pool, lay, idx)
    return gather(pool, lay, idx, tables)


def pool_writeback(pool: Any, lay: Layout, idx: torch.Tensor, tables: torch.Tensor,
                   cache: Any, *, paged: bool) -> Any:
    """Inverse of ``pool_views``: slot rows (and gathered views) written
    back in place; paged leaves were updated in place by the forward."""
    if paged:
        return scatter_mixed(pool, lay, idx, cache)
    return scatter(pool, lay, idx, tables, cache)


def pool_forward(
    params: Dict, cfg: ModelConfig, lay: Layout, pool: Any,
    slots: Sequence[int], tables: torch.Tensor, start_pos: torch.Tensor,
    schedule: Schedule, *, paged: bool, tokens: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    state_at: Optional[torch.Tensor] = None,
):
    """``forward`` over the pool for the rows' ``slots`` and ``tables``;
    returns ``(logits, pool)``.  ``paged=True`` (a pool with paged leaves)
    row-packs the slot leaves, passes the paged leaves whole for the
    forward to update in place, and writes the rows back;
    ``paged=False`` gathers ``(layers, B, view_capacity, ...)`` views and
    slot rows, runs the dense-cache forward on them and scatters them
    back.  ``state_at`` (B,) (a config with recurrent state): each row's
    state written back is the one after pass position ``state_at[b]``, the
    last real position of a padded prefill, so pads never advance it."""
    idx = slot_index(pool, lay, slots, tables.device)
    cache = pool_views(pool, lay, idx, tables, paged=paged)
    pview = PagedView(lay.block_size, lay.null_bid, lay.scratch_bid) if paged else None
    logits, cache, per_pos = forward(
        params, cfg, tokens, inputs_embeds=inputs_embeds, cache=cache,
        start_pos=start_pos, schedule=schedule, collect_states=state_at is not None,
        tables=tables if paged else None, paged=pview)
    if state_at is not None:
        cache = statepool.merge_rows(cache, statepool.select_index(per_pos, state_at))
    return logits, pool_writeback(pool, lay, idx, tables, cache, paged=paged)


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
        self.data = blockpool.init_cache(cfg, self.layout, num_slots, device)
        self.alloc_blocks = BlockAllocator(num_blocks)
        self._free: List[int] = list(range(num_slots))

    # -- slots ------------------------------------------------------------

    @property
    def scratch_slot(self) -> int:
        return self.num_slots

    def alloc(self) -> int:
        return self._free.pop(0)

    def free(self, slot: int) -> None:
        # wipe the slot's dense leaves so stale entries never mask in
        self.reset_slot(slot)
        self._free.append(slot)

    def reset_slot(self, slot: int) -> None:
        """Wipe a slot's dense leaves (ring positions to -1) without
        releasing it: a restore replays from the state a fresh slot has,
        not from the victim's post-speculation ring."""
        blockpool.wipe_slot(self.data, self.layout, slot)

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
        """(B, blocks_per_table) int32 tables on the pool's device, ``-1``-padded;
        zero-width for a pool without paged leaves, which addresses nothing
        through them."""
        nblk = self.layout.blocks_per_table if self.paged else 0
        rows = []
        for blocks in blocks_list:
            assert len(blocks) <= nblk, "block table exceeds view capacity"
            rows.append(list(blocks) + [-1] * (nblk - len(blocks)))
        return torch.tensor(rows, dtype=torch.int32, device=self.device)
