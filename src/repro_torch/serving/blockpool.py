"""Fixed-size KV block pool: allocator + block-indexed device cache layout.

PyTorch counterpart of ``repro.serving.blockpool``.
``build_layout`` classifies every cache leaf once, by shape, into one of
two kinds, plus a third by name:

* ``paged``: every full-attention leaf (``k``/``v``/``pos``) is cut into
  one global pool of ``block_size``-token blocks, ``(layers, num_blocks +
  2, block_size, ...)``, addressed through per-request block tables.  Two
  sentinel blocks close the pool: ``null`` (frozen, ``pos == -1``; ``-1``
  table entries read it) and ``scratch`` (absorbs writes past a table;
  never read).
* ``slot``: dense per-slot leaves, ``(layers, num_slots + 1, ...)``, the
  last row a scratch slot that verify pad rows write.  Sliding-window
  rings (``window + RING_SLACK`` slots a row) and recurrent state (rwkv's
  ``tm_shift``, ``cm_shift`` and ``wkv``, mamba's ``conv`` and ``ssm``) are
  slot leaves; a hybrid config's pool holds paged and slot leaves side by
  side.  Every scatter
  into slot leaves is an ``index_put_``, whose duplicate indices are
  nondeterministic on CUDA: pad rows may share the scratch slot, but no
  real slot may take two rows of one scatter (``check_slots``).
* ``cross``: an encoder-decoder config's cross cache (``cross/{k, v}``
  ``(layers, num_slots + 1, Se, KV, HD)``, ``cross/mask`` ``(1, num_slots
  + 1, Se)``: a layer axis of one).  Stored and row-packed like slot
  leaves, but read-only to the forward: the engine writes a slot's rows
  once, at admission and on every restore (``write_cross``), and the
  scatters after a pass skip them.  Verify pad rows read the scratch
  slot's, whose mask is all False.

``head_layers`` leaves (the ``first_k_dense`` layers) lead with a layer
axis of one, so they are classified and addressed like the block stack's:
full-attention head layers are paged on the paged lane and gathered on the
gathered lane.

The JAX package threads an immutable pool through every step; here the
leaves are updated in place (the paged forward writes through the tables,
``scatter`` and ``scatter_mixed`` write gathered rows and views back,
``wipe_blocks`` and ``wipe_slot`` reset freed blocks and slots,
``copy_blocks`` copies a prefix's blocks from one pool into another).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Set

import torch

from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import cache_spec

#: shape sentinels for leaf classification (never collide with real dims)
_SENT_B = 1_000_003
_SENT_C = 1_000_033

#: default KV block size (tokens per block)
DEFAULT_BLOCK_SIZE = 16


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static description of the cache layout.  ``kinds`` mirrors the cache
    tree with ``"paged"``, ``"slot"`` or ``"cross"`` per leaf; every leaf's
    batch axis (paged: block axis) is axis 1, after the layer axis."""

    kinds: Any
    block_size: int
    num_blocks: int  # real allocatable blocks (excludes null + scratch)
    blocks_per_table: int  # table width: ceil(capacity / block_size)
    has_paged: bool

    @property
    def null_bid(self) -> int:
        return self.num_blocks

    @property
    def scratch_bid(self) -> int:
        return self.num_blocks + 1

    @property
    def view_capacity(self) -> int:
        return self.blocks_per_table * self.block_size


def _map(fn, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def build_layout(
    cfg: ModelConfig, capacity: int, block_size: int, num_blocks: int
) -> Layout:
    """Classify every cache leaf by shape (sentinel batch and capacity
    dimensions): a leaf whose capacity axis follows its batch axis is
    paged, any other (a ring caps its capacity at ``window + RING_SLACK``)
    is slot-shaped; the ``cross`` subtree is ``"cross"``."""
    if block_size < 1:
        raise ValueError(f"block_size {block_size} must be >= 1")

    def classify(leaf):
        shape, _ = leaf
        assert shape[1] == _SENT_B, f"batch axis must follow the layer axis in {shape}"
        return "paged" if shape[2] == _SENT_C else "slot"

    spec = cache_spec(cfg, _SENT_B, _SENT_C)
    kinds = _map(classify, spec)
    if "cross" in spec:
        kinds["cross"] = _map(lambda leaf: "cross", spec["cross"])
    return Layout(kinds=kinds, block_size=block_size, num_blocks=num_blocks,
                  blocks_per_table=-(-capacity // block_size),
                  has_paged="paged" in _leaves(kinds))


def init_cache(cfg: ModelConfig, lay: Layout, num_slots: int,
               device: torch.device) -> Any:
    """Device storage: slot leaves carry ``num_slots + 1`` rows (the last
    the scratch slot); paged leaves carry ``num_blocks + 2`` blocks of
    ``block_size`` (+ null + scratch blocks).  Positions start at -1
    (empty)."""

    def make(leaf, kind):
        shape, dtype = leaf
        if kind != "paged":
            shape = (shape[0], num_slots + 1) + shape[2:]
        else:
            shape = (shape[0], lay.num_blocks + 2, lay.block_size) + shape[3:]
        if dtype == torch.int32:
            return torch.full(shape, -1, dtype=dtype, device=device)
        return torch.zeros(shape, dtype=dtype, device=device)

    return _map(make, cache_spec(cfg, _SENT_B, _SENT_C), lay.kinds)


def check_slots(slots: Sequence[int], scratch: int) -> None:
    """Raise unless every slot but ``scratch`` appears at most once: pad
    rows all write the scratch slot, and a real slot written twice by one
    ``index_put_`` would take either row on CUDA."""
    real = [s for s in slots if s != scratch]
    if len(set(real)) != len(real):
        raise AssertionError(f"slots {list(slots)}: a real slot takes two rows "
                             "of one scatter")


def scratch_slot(pool: Any, lay: Layout) -> Optional[int]:
    """The scratch slot of ``pool`` (its slot leaves' last row), or None
    when it has no slot leaves."""
    for leaf, kind in zip(_leaves(pool), _leaves(lay.kinds)):
        if kind != "paged":
            return leaf.shape[1] - 1
    return None


def wipe_blocks(pool: Any, lay: Layout, bids: List[int]) -> Any:
    """Reset freed blocks' positions to -1 in place, so stale absolute
    positions never mask into a future owner's attention."""
    if not bids:
        return pool

    def wipe(leaf, kind):
        if kind == "paged" and leaf.dtype == torch.int32:
            leaf[:, torch.tensor(bids, dtype=torch.long, device=leaf.device)] = -1
        return leaf

    return _map(wipe, pool, lay.kinds)


def wipe_slot(pool: Any, lay: Layout, slot: int) -> Any:
    """Reset a slot's dense leaves in place (ring positions to -1, the rest,
    recurrent state and cross caches included, to zero: a cross mask to
    False), so a released or restored slot starts pristine."""

    def wipe(leaf, kind):
        if kind != "paged":
            leaf[:, slot] = -1 if leaf.dtype == torch.int32 else 0
        return leaf

    return _map(wipe, pool, lay.kinds)


def write_cross(pool: Any, slot: int, cross: Any) -> Any:
    """Write one request's cross cache (``models.transformer.
    build_cross_cache`` at B = 1: every leaf with a row axis of one) into
    ``slot``'s cross leaves, in place."""

    def w(leaf, row):
        leaf[:, slot] = row[:, 0].to(leaf.dtype)
        return leaf

    pool["cross"] = _map(w, pool["cross"], cross)
    return pool


# ---------------------------------------------------------------------------
# device gather / scatter: slot leaves by slots, paged leaves by tables
# ---------------------------------------------------------------------------


def gather(pool: Any, lay: Layout, slots: torch.Tensor, tables: torch.Tensor) -> Any:
    """Per-row cache views (copies): slot and cross leaves take rows
    ``slots`` (B,); paged leaves ``(layers, NB+2, bs, ...)`` become ``(layers, B,
    view_capacity, ...)`` assembled from ``tables`` (B, blocks_per_table),
    ``-1`` entries reading the null block (positions -1, always masked)."""
    B, nblk = tables.shape
    flat = torch.where(tables < 0, lay.null_bid, tables).reshape(-1).long()

    def g(leaf, kind):
        if kind != "paged":
            return leaf[:, slots]
        out = leaf[:, flat]  # (layers, B*nblk, bs, ...)
        return out.reshape(leaf.shape[0], B, nblk * lay.block_size, *leaf.shape[3:])

    return _map(g, pool, lay.kinds)


def scatter(pool: Any, lay: Layout, slots: torch.Tensor, tables: torch.Tensor,
            update: Any) -> Any:
    """Write per-row views back into the pool in place: slot leaves by
    ``slots`` (pad rows share the scratch slot; cross leaves, which no
    forward writes, are skipped); paged leaves through the
    tables, ``-1`` entries dumping into the scratch block (view tails and
    pad rows, duplicate indices); duplicate real entries (prefix-shared
    blocks in one batch) carry bitwise-identical content, so write order is
    immaterial.  Run under ``core.determinism.deterministic_torch``, as the
    paged writes are."""
    B, nblk = tables.shape
    flat = torch.where(tables < 0, lay.scratch_bid, tables).reshape(-1).long()

    def s(leaf, kind, u):
        if kind == "slot":
            leaf[:, slots] = u.to(leaf.dtype)
            return leaf
        if kind == "cross":
            return leaf
        u2 = u.reshape(leaf.shape[0], B * nblk, lay.block_size, *leaf.shape[3:])
        for i in range(leaf.shape[0]):  # index the block axis of one layer
            leaf[i][flat] = u2[i].to(leaf.dtype)
        return leaf

    return _map(s, pool, lay.kinds, update)


def gather_mixed(pool: Any, lay: Layout, slots: torch.Tensor) -> Any:
    """Row-pack slot and cross leaves only (copies); paged leaves pass
    through whole, for the paged forward to read and write in place through
    the tables."""
    return _map(lambda leaf, kind: leaf if kind == "paged" else leaf[:, slots],
                pool, lay.kinds)


def scatter_mixed(pool: Any, lay: Layout, slots: torch.Tensor, update: Any) -> Any:
    """Inverse of ``gather_mixed``: slot leaves write back by ``slots``;
    paged leaves were updated in place by the forward, cross leaves are
    read-only."""

    def sm(leaf, kind, u):
        if kind == "slot":
            leaf[:, slots] = u.to(leaf.dtype)
        return leaf

    return _map(sm, pool, lay.kinds, update)


def copy_blocks(src_pool: Any, dst_pool: Any, lay: Layout,
                src_bids: List[int], dst_bids: List[int]) -> Any:
    """Copy paged-leaf block rows ``src_bids`` of ``src_pool`` into
    ``dst_bids`` of ``dst_pool`` in place; returns the destination tree.

    The cluster front end's cross-replica prefix transfer
    (``cluster.replica.transfer_prefix``): both pools share one
    :class:`Layout`.  Slot and cross leaves never move: prefix sharing is
    defined only for paged full-attention KV.  The block ids go to the
    device once; then one gather and one ``index_put_`` a leaf (no host
    round trip), under
    ``core.determinism.deterministic_torch`` like every other pool write."""
    from repro_torch.core.determinism import deterministic_torch

    assert len(src_bids) == len(dst_bids)
    pairs = [(d, s) for d, s, kind in zip(_leaves(dst_pool), _leaves(src_pool),
                                          _leaves(lay.kinds)) if kind == "paged"]
    if not src_bids or not pairs:
        return dst_pool
    si = torch.tensor(src_bids, dtype=torch.long, device=pairs[0][1].device)
    di = torch.tensor(dst_bids, dtype=torch.long, device=pairs[0][0].device)
    with deterministic_torch():
        for dst_leaf, src_leaf in pairs:
            dst_leaf[:, di] = src_leaf[:, si].to(device=dst_leaf.device,
                                                 dtype=dst_leaf.dtype)
    return dst_pool


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
