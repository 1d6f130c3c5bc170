"""One engine replica behind the cluster router.

PyTorch port of ``repro.cluster.replica``.  A :class:`Replica` wraps a
``serving.Engine`` with the identity and probes the deterministic router
needs: a stable index, a load figure, the prefix-affinity probe (a
*non-mutating* radix walk: probing must not perturb the LRU state of
replicas the router does not pick), and the cross-replica prefix transfer.

Transfer semantics (``transfer_prefix``): when a request's cached prefix
lives on replica *i* but the router lands it on replica *j* (load guard),
the matched KV blocks are copied device to device into *j*'s pool
(``blockpool.copy_blocks``) and registered with *j*'s radix, arriving
resident but evictable, exactly like locally committed prefix blocks.  The
alternative ``"recompute"`` policy moves nothing: *j* replays the prefill
deterministically, and by the determinism contract the recomputed KV is
bitwise the KV the copy would have moved, so the two policies differ only
in cost (a copy against recompute FLOPs), never in committed streams.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.serving import blockpool
from repro_torch.serving.engine import Engine


class Replica:
    """A routable engine: stable index + the router's probes."""

    def __init__(self, idx: int, engine: Engine):
        self.idx = idx
        self.engine = engine
        # cross-replica transfer telemetry (cluster.* metrics)
        self.transfers_in = 0
        self.transferred_tokens_in = 0

    # -- router probes ---------------------------------------------------

    @property
    def load(self) -> int:
        """Requests this replica is responsible for (running + queued +
        preempted awaiting restore): the router's balance key."""
        e = self.engine
        return len(e.running) + len(e.queue) + len(e.preempted)

    @property
    def occupancy(self) -> float:
        """Running requests over slot capacity (per-replica gauge)."""
        return len(self.engine.running) / max(self.engine.max_batch, 1)

    def prefix_blocks(self, prompt: List[int]) -> int:
        """Whole blocks of ``prompt`` resident in this replica's radix: the
        affinity score.  Non-mutating (``PrefixCache.peek``)."""
        pc = self.engine.prefix_cache
        return pc.peek(prompt) if pc is not None else 0

    def has_work(self) -> bool:
        e = self.engine
        return bool(e.running or e.queue or e.preempted)


def transfer_prefix(src: Replica, dst: Replica, prompt: List[int], now: int) -> int:
    """Copy ``src``'s cached prefix of ``prompt`` into ``dst``'s pool.

    Returns the tokens moved (0 when either side has no prefix cache,
    ``dst`` already holds at least as long a prefix, or ``dst``'s pool is
    dry; a partial leading copy is still a valid radix prefix).  Blocks land
    in ``dst`` at refcount 0, ``cached``: resident but evictable, so the
    next admission increfs them exactly like a local hit.
    """
    spc, dpc = src.engine.prefix_cache, dst.engine.prefix_cache
    if spc is None or dpc is None:
        return 0
    src_bids = spc.match(prompt, now)
    have = dpc.peek(prompt)
    if len(src_bids) <= have:
        return 0

    dst_bids: List[int] = list(dpc.match(prompt, now)[:have])
    fresh: List[int] = []
    for _ in range(have, len(src_bids)):
        bid: Optional[int] = dst.engine._alloc_block()
        if bid is None:
            break
        fresh.append(bid)
        dst_bids.append(bid)
    if not fresh:
        return 0

    # device copy of the paged KV rows, then radix adoption on dst
    dpool = dst.engine.pool
    dpool.data = blockpool.copy_blocks(
        src.engine.pool.data, dpool.data, dpool.layout,
        list(src_bids[have:have + len(fresh)]), fresh,
    )
    bs = dpool.block_size
    dpc.insert(prompt[: len(dst_bids) * bs], dst_bids, now, dpool.alloc_blocks)
    # drop the alloc ref: resident but evictable, like committed prefixes
    for bid in fresh:
        dpool.alloc_blocks.decref(bid)

    moved = len(fresh) * bs
    dst.transfers_in += 1
    dst.transferred_tokens_in += moved
    return moved
