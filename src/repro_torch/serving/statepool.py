"""Per-slot state pool, attention-arch subset: depth/extent accounting.

PyTorch counterpart of ``repro.serving.statepool``.  For recurrent archs
(mamba/rwkv, ssm/hybrid families) the JAX pool double-buffers device state
so speculation can run ``spec_depth`` windows deep; those families are not
ported yet.  For attention archs rollback is pointer-free (the verifier's
replay overwrites the window's KV in place, anything past the commit point
is shadowed by the position mask), so the pool is host-side telemetry only:
in-flight verify depth per slot and the speculative KV extent, which
``launch/serve.py`` reports.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.base import ModelConfig


def has_recurrent_state(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


class StatePool:
    """In-flight window depth + speculative extent accounting per slot."""

    def __init__(self, cfg: ModelConfig, num_slots: int, depth: int = 1):
        assert depth >= 1, "the ring needs at least one checkpoint buffer"
        if has_recurrent_state(cfg):
            raise NotImplementedError(
                f"{cfg.name}: recurrent state pools are not ported yet")
        self.cfg = cfg
        self.depth = depth
        self.num_slots = num_slots
        self.active = False  # no device buffers for attention archs
        self._inflight: Dict[int, int] = {}
        self.peak_depth = 0
        self.peak_extent = 0
        self.num_preempts = 0

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
        were flushed at eviction)."""
        self._inflight.pop(slot, None)
        self.num_preempts += 1

    def depth_of(self, slot: int) -> int:
        return self._inflight.get(slot, 0)
