"""Commit-aware radix prefix cache over the KV block pool.

Identical system prompts are recomputed for every request under the dense
cache manager.  The paper's commit point makes a *safe* sharing rule
possible: only **committed** tokens are guaranteed bitwise-stable across
runs — their KV is verify-grade (prefill runs under the fixed verify
schedule; every committed token's cache entry was written by a fixed-shape
verify replay before the token could commit) — so KV for committed
prefixes can be shared read-only, and evicted-then-recomputed, without
ever breaking the determinism contract.  Speculative/verify tails stay
private by construction: sharing is whole-block and never extends past the
committed stream, so every speculative write lands in the owner's private
copy-on-write tail blocks.

The cache is a radix tree with **block-granular edges**: each node is one
KV block, keyed by the exact ``block_size``-token chunk it holds, rooted
at position 0.  Admission walks the tree with the request's prompt and
maps the longest whole-block committed-prefix match into the request's
block table (refcount +1 per block); prefill then chunk-prefills just the
tail.  A partially-matched boundary block is never shared — the tail is
recomputed into a private block instead (copy-on-write by recompute),
which keeps shared blocks strictly read-only.

Insertion points (the "commit-aware" rule):

* prefill completion — prompt blocks: a prompt is committed by the user,
  and prefill runs the fixed deterministic schedule in every engine mode;
* retirement / preemption — the committed *output* extension, but only
  for traffic whose generated KV is deterministic (LLM42 deterministic
  requests: verify-grade by the DVR protocol; BATCH_INVARIANT mode:
  invariant schedule everywhere).  Non-deterministic fast-path output is
  never cached.  The last committed token is always excluded — its KV is
  written by the *next* decode, so it may not exist yet.

Eviction is leaf-first LRU over zero-ref nodes (an interior node's KV is
the prefix context of its children, so the tree frees from the outside
in), with deterministic (last_use, insertion-seq) tie-breaks.  Evicting
never breaks a live request — blocks with a nonzero refcount are skipped —
and an evicted prefix is simply a cache miss later: restore-by-recompute
is bitwise-identical because the stream it replays is committed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.blockpool import BlockAllocator


@dataclasses.dataclass
class _Node:
    key: Tuple[int, ...]  # the block's token chunk (edge label from parent)
    bid: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict
    )
    last_use: int = 0
    seq: int = 0  # insertion order: deterministic LRU tie-break


class PrefixCache:
    """Radix tree of committed-token KV blocks (block-granular edges)."""

    def __init__(self, block_size: int):
        assert block_size >= 1
        self.block_size = block_size
        self.root = _Node(key=(), bid=-1, parent=None)
        self._seq = 0
        # stats (serve-loop / benchmark telemetry)
        self.hits = 0  # admissions that matched >= 1 block
        self.misses = 0  # admissions that matched nothing
        self.hit_tokens = 0  # prompt tokens served from cache
        self.insertions = 0  # blocks registered
        self.evictions = 0  # blocks reclaimed by LRU eviction
        self.size = 0  # blocks currently registered

    # -- lookup ----------------------------------------------------------

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(tokens) // bs
        return [
            tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            for i in range(n_full)
        ]

    def match(self, tokens: Sequence[int], now: int) -> List[int]:
        """Block ids for the longest whole-block prefix of ``tokens``
        present in the cache; bumps LRU clocks along the path.  The caller
        increfs the returned blocks (same host step — no eviction can
        intervene) and calls :meth:`note_lookup` once the admission
        actually goes through, so retried admissions don't inflate the
        hit-rate stats."""
        bids: List[int] = []
        node = self.root
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_use = now
            bids.append(child.bid)
            node = child
        return bids

    def peek(self, tokens: Sequence[int]) -> int:
        """Blocks of the longest cached whole-block prefix of ``tokens``,
        WITHOUT bumping LRU clocks or hit-rate stats — the cluster
        router's affinity probe, which inspects every replica's radix and
        must not perturb the LRU state of replicas it does not pick."""
        n = 0
        node = self.root
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            n += 1
            node = child
        return n

    def note_lookup(self, n_matched_blocks: int) -> None:
        """Record one completed admission lookup in the hit-rate stats."""
        if n_matched_blocks > 0:
            self.hits += 1
            self.hit_tokens += n_matched_blocks * self.block_size
        else:
            self.misses += 1

    # -- insertion -------------------------------------------------------

    def insert(
        self,
        tokens: Sequence[int],
        bids: Sequence[int],
        now: int,
        allocator: BlockAllocator,
    ) -> int:
        """Register the whole-block prefix of ``tokens`` (held in ``bids``,
        table order) with the tree.  Blocks already cached along the path
        are left as-is (the duplicate stays owned by its request and frees
        normally); newly adopted blocks are marked ``cached`` in the
        allocator, so they stay resident-but-evictable when their refcount
        drains.  Returns the number of blocks adopted."""
        node = self.root
        adopted = 0
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(bids):
                break
            child = node.children.get(chunk)
            if child is None:
                bid = int(bids[i])
                if bid in allocator.cached:
                    break  # already registered under a different path: stop
                self._seq += 1
                child = _Node(
                    key=chunk, bid=bid, parent=node, last_use=now,
                    seq=self._seq,
                )
                node.children[chunk] = child
                allocator.cached.add(bid)
                adopted += 1
                self.size += 1
                self.insertions += 1
            child.last_use = now
            node = child
        return adopted

    # -- eviction --------------------------------------------------------

    def evict_lru(self, allocator: BlockAllocator) -> Optional[int]:
        """Reclaim the least-recently-used zero-ref *leaf* block: detach it
        from the tree and drop its ``cached`` mark.  The caller returns the
        block id to the pool (wipe + free list).  Returns None when nothing
        is evictable."""
        best: Optional[_Node] = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self.root or node.children:
                continue  # interior nodes carry their children's context
            if allocator.refs[node.bid] != 0:
                continue
            if best is None or (node.last_use, node.seq) < (
                best.last_use, best.seq
            ):
                best = node
        if best is None:
            return None
        assert best.parent is not None
        del best.parent.children[best.key]
        allocator.cached.discard(best.bid)
        self.size -= 1
        self.evictions += 1
        return best.bid

    # -- telemetry -------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_insertions": self.insertions,
            "prefix_evictions": self.evictions,
            "prefix_size_blocks": self.size,
        }
