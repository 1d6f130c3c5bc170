"""Slot-indexed, double-buffered device state pool (speculation tentpole).

PyTorch counterpart of ``repro.serving.statepool``.  Attention KV rollback
is pointer-free: the verifier's replay overwrites the window's cache
entries positionally and anything past the commit point is shadowed by the
position mask.  Recurrent state (rwkv's shift and wkv state, mamba's conv
and ssm state) has no positions to hide behind: the fast path advances one
O(1) state per slot irreversibly.  The pool double-buffers it per slot:

* the **live** state stays in the engine's cache pool (``blockpool`` slot
  leaves) and is advanced only by the fast path (decode / prefill);
  verification never writes it at launch time;
* the **anchor** buffer holds, per slot, the state the next submitted
  verify window's replay starts from (the state after all speculation that
  precedes the window, minus the window's conditioning token, which the
  replay consumes again).  With no window in flight it is the commit-point
  state, so sync verification reads the same buffer;
* a **ring** of ``depth`` checkpoint buffers holds one snapshot per
  in-flight window: the replay's state at the window's commit index
  (``per_pos[n_match]``).  When the window's verdict splices with a
  rollback, or leaves the request with no surviving speculation, the
  engine restores the live state (and the anchor) from the window's ring
  entry, so depth is bounded by the ring, not by the protocol.

For attention-only archs there is no device state to buffer; the pool is
host-side telemetry only: in-flight verify depth per slot and the
speculative KV extent, which ``launch/serve.py`` reports.

State trees mirror the cache tree (``models.transformer.cache_spec``) with the
recurrent leaf dicts kept and every attention leaf dict replaced by None; an
encoder-decoder config's ``cross`` subtree is not part of them (its leaves are
the JAX pool's ``"skip"`` leaves: no checkpoint, restore or rollback touches
them; the engine rebuilds them on a restore).  Unlike the JAX trees
(``head_layers`` slot axis 0), every leaf here leads with a layer axis, so the
slot axis is axis 1 everywhere (per-position trees: the window axis is axis
2).  Buffers hold ``num_slots + 1`` rows, the last the scratch row verify pad
rows write; duplicate indices of ``index_put_`` are nondeterministic on CUDA,
so no real slot may take two rows of one scatter (``blockpool.check_slots``).
Buffers are updated in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import cache_spec
from repro_torch.serving.blockpool import check_slots

#: leaf names of recurrent (O(1), position-free) cache state
RECURRENT_KEYS = frozenset({"conv", "ssm", "tm_shift", "cm_shift", "wkv"})

_TOPS = ("blocks", "head_layers")


def has_recurrent_state(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# state-tree structure helpers
# ---------------------------------------------------------------------------


def _kind(sub: Any) -> str:
    """Classify a cache / per-position subtree: ``"state"`` (a recurrent
    leaf dict), ``"skip"`` (an attention leaf dict, or a placeholder:
    None), or ``"recurse"`` (structural nesting)."""
    if not isinstance(sub, dict):
        return "skip"
    if set(sub) & RECURRENT_KEYS:
        return "state"
    if "k" in sub or "mask" in sub:  # attention / cross leaves
        return "skip"
    return "recurse"


def _filter(sub: Any) -> Any:
    """Keep recurrent leaves (and only those), attention dicts -> None."""
    kind = _kind(sub)
    if kind == "skip":
        return None
    if kind == "state":
        return {k: v for k, v in sub.items() if k in RECURRENT_KEYS}
    return {k: _filter(v) for k, v in sub.items()}


def _tops(tree: Dict[str, Any], fn: Callable[[Any], Any]) -> Dict[str, Any]:
    return {top: fn(tree[top]) for top in _TOPS if top in tree}


def state_spec(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    """``(shape, dtype)`` state tree for ``batch`` slots (the capacity
    given to ``cache_spec`` only shapes leaves that are dropped)."""
    return _tops(cache_spec(cfg, batch, capacity=8), _filter)


def _rec(fn: Callable[..., Any], subs: Sequence[Any]) -> Any:
    s0 = subs[0]
    kind = _kind(s0)
    if kind == "skip":
        return None
    if kind == "state":
        return {k: fn(*[s[k] for s in subs]) for k in s0}
    return {k: _rec(fn, [s[k] for s in subs]) for k in s0}


def _map_state(fn: Callable[..., Any], *trees: Any) -> Dict[str, Any]:
    """``fn(*leaves)`` at every recurrent leaf of congruent state trees."""
    first = trees[0]
    return {top: _rec(fn, [t[top] for t in trees]) for top in _TOPS if top in first}


def init_state(cfg: ModelConfig, batch: int,
               device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Zero state tree for ``batch`` slots on ``device`` (default ``cuda``)."""
    from repro_torch import resolve_device

    dev = resolve_device(device)

    def make(sub):
        if isinstance(sub, dict):
            return {k: make(v) for k, v in sub.items()}
        if sub is None:
            return None
        shape, dtype = sub
        return torch.zeros(shape, dtype=dtype, device=dev)

    return make(state_spec(cfg, batch))


def _index(leaf: torch.Tensor, slots: Any) -> torch.Tensor:
    if torch.is_tensor(slots):
        return slots
    return torch.as_tensor(list(slots), dtype=torch.long, device=leaf.device)


def gather_rows(state: Dict[str, Any], slots: Any) -> Dict[str, Any]:
    """Batched rows (slot axis -> len(slots)), copies.  ``slots`` is a
    sequence of slots or an index tensor on the state's device."""
    return _map_state(lambda a: a.index_select(1, _index(a, slots)), state)


def scatter_rows(state: Dict[str, Any], slots: Any,
                 rows: Dict[str, Any]) -> Dict[str, Any]:
    """Write batched rows into a slot-indexed tree in place; returns it.
    ``slots`` is a sequence of slots, checked here, or an index tensor that
    an engine program's host prep built and checked
    (``serving.kv_cache.slot_index``)."""

    def put(a, u):
        if not torch.is_tensor(slots):
            check_slots(slots, a.shape[1] - 1)
        a[:, _index(a, slots)] = u.to(a.dtype)
        return a

    _map_state(put, state, rows)
    return state


def rows_from_cache(cache: Dict[str, Any],
                    slots: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """The recurrent leaves of a (pool- or batch-shaped) cache tree as a
    state tree (the leaves themselves); gathered at ``slots`` (copies)
    when given."""
    tree = _tops(cache, _filter)
    return tree if slots is None else gather_rows(tree, slots)


def merge_rows(cache: Dict[str, Any], rows: Dict[str, Any]) -> Dict[str, Any]:
    """A new cache tree whose recurrent leaves are ``rows`` (batch-shaped,
    cast to the cache's dtypes); attention leaves pass through as they
    are."""

    def merge(c: Any, r: Any) -> Any:
        if r is None:
            return c
        if isinstance(r, dict):
            return {k: (merge(c[k], r[k]) if k in r else c[k]) for k in c}
        return r.to(c.dtype)

    out = dict(cache)
    for top in _TOPS:
        if top in rows and top in cache:
            out[top] = merge(cache[top], rows[top])
    return out


def select_index(per_pos: Any, idx: torch.Tensor) -> Dict[str, Any]:
    """Each row's per-position replay state at ``idx`` (G,): ``per_pos`` is
    ``forward(collect_states=True)``'s, recurrent leaves (L, G, W, ...),
    ``per_pos[.., b, j]`` the state after consuming window input j;
    returns (L, G, ...) leaves (attention placeholders stay None)."""
    b = torch.arange(idx.shape[0], device=idx.device)
    j = idx.long()
    return _map_state(lambda a: a[:, b, j], per_pos)


def scatter_into_cache(cache: Dict[str, Any], slots: Sequence[int],
                       rows: Dict[str, Any]) -> Dict[str, Any]:
    """Write state-tree rows into the full cache pool's recurrent leaves at
    ``slots``, in place (the live-state restore of a rollback splice)."""
    scatter_rows(rows_from_cache(cache), slots, rows)
    return cache


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


class StatePool:
    """Double-buffered per-slot state checkpoints + depth/extent accounting.

    ``active`` (recurrent archs) means device buffers exist, on ``device``
    (default ``cuda``);
    for attention-only archs every device method is a no-op and only the
    host accounting (in-flight depth, speculative KV extent) is live.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, depth: int = 1, *,
                 device: Optional[torch.device] = None):
        assert depth >= 1, "the ring needs at least one checkpoint buffer"
        self.cfg = cfg
        self.depth = depth
        self.num_slots = num_slots
        self.active = has_recurrent_state(cfg)
        # +1 scratch row so grouped-verification padding rows have a target
        if self.active:
            self.anchor: Optional[Dict[str, Any]] = init_state(cfg, num_slots + 1, device)
            self.ring: List[Dict[str, Any]] = [
                init_state(cfg, num_slots + 1, device) for _ in range(depth)]
        else:
            self.anchor = None
            self.ring = []
        self._inflight: Dict[int, int] = {}
        self.peak_depth = 0
        self.peak_extent = 0
        self.num_preempts = 0  # slots whose buffers went stale to eviction

    # -- host accounting ------------------------------------------------

    def note_submit(self, slot: int, extent: int) -> int:
        """Record one submitted window; returns the slot's new depth."""
        d = self._inflight.get(slot, 0) + 1
        self._inflight[slot] = d
        self.peak_depth = max(self.peak_depth, d)
        self.peak_extent = max(self.peak_extent, extent)
        return d

    def note_splice(self, slot: int, flushed: int = 0) -> None:
        """One verdict spliced (plus ``flushed`` cascade-discarded ones)."""
        d = self._inflight.get(slot, 0) - 1 - flushed
        if d > 0:
            self._inflight[slot] = d
        else:
            self._inflight.pop(slot, None)

    def note_release(self, slot: int) -> None:
        self._inflight.pop(slot, None)

    def note_preempt(self, slot: int) -> None:
        """Preemption: the slot's in-flight accounting drops (its verdicts
        were flushed at eviction).  The slot survives, but its anchor and
        ring go stale once the engine wipes the slot's live state for the
        restore replay: nothing is copied out, because the replay rebuilds
        the anchor exactly (``set_commit_point`` at the replay's end is the
        state after ``committed[:-1]``, through the same fixed schedule)."""
        self._inflight.pop(slot, None)
        self.num_preempts += 1

    def depth_of(self, slot: int) -> int:
        return self._inflight.get(slot, 0)

    # -- device buffers --------------------------------------------------

    def set_commit_point(self, pool_data: Dict[str, Any], slot: int) -> None:
        """Anchor <- the slot's live state (prefill end: the state after the
        prompt is the first replay anchor)."""
        if not self.active:
            return
        scatter_rows(self.anchor, [slot], rows_from_cache(pool_data, [slot]))

    def checkpoint(self, ring_idxs: Sequence[int], slots: Sequence[int],
                   rows: Any) -> None:
        """Store each row's commit-index state in its window's ring buffer
        (rows batched as the verify pass returns them; grouped per ring
        index so co-launched windows of different requests coexist)."""
        if not self.active or rows is None:
            return
        for d in sorted(set(ring_idxs)):
            sel = [i for i, x in enumerate(ring_idxs) if x == d]
            sub = _map_state(lambda a: a.index_select(1, _index(a, sel)), rows)
            scatter_rows(self.ring[d], [slots[i] for i in sel], sub)

    def reanchor(self, slot: int, ring_idx: int) -> None:
        """Replay anchor <- the window's checkpointed commit state, once the
        in-flight FIFO drains: the next window launches anchored on
        ``committed[-1]``, one token later than the chained start state the
        last launch left in the anchor."""
        if not self.active:
            return
        scatter_rows(self.anchor, [slot], gather_rows(self.ring[ring_idx], [slot]))

    def restore(self, pool_data: Dict[str, Any], slot: int,
                ring_idx: int) -> Dict[str, Any]:
        """Rollback (or drained-speculation) restore: the live state and
        the anchor both return to the window's checkpointed commit state.
        Returns the pool tree, updated in place."""
        if not self.active:
            return pool_data
        rows = gather_rows(self.ring[ring_idx], [slot])
        scatter_rows(self.anchor, [slot], rows)
        return scatter_into_cache(pool_data, [slot], rows)
