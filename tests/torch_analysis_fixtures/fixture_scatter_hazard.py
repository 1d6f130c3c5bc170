"""SEEDED VIOLATION (do not fix): an overlapping float scatter-add.

A KV-style writeback that adds f32 rows at data-dependent slots with no
uniqueness guarantee: duplicate slots combine in the device's order, not
the fixed f32 schedule.  ``analysis_trace()`` records it for the checker's
fixture mode (and the hazard pass in tests).  The checker must flag
  * hazards/scatter-add-overlap
"""

from __future__ import annotations

import torch

from repro_torch.analysis.trace_utils import record

BATCH = 13
CAPACITY = 64
DIM = 8


def overlapping_writeback(cache, updates, slots):
    """cache: (CAP, D) f32; updates: (B, D) f32; slots: (B,) int64."""
    # VIOLATION: slots come from the data and may collide
    cache.index_put_((slots,), updates, accumulate=True)
    return cache


def analysis_trace():
    g = torch.Generator().manual_seed(0)
    cache = torch.zeros((CAPACITY, DIM))
    updates = torch.randn((BATCH, DIM), generator=g)
    slots = torch.randint(0, CAPACITY, (BATCH,), generator=g)
    log, _ = record(overlapping_writeback, cache, updates, slots)
    return log, BATCH
