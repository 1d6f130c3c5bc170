"""SEEDED VIOLATION (do not fix): a library sum over the batch axis.

A batch statistic folded into every row: ``torch.sum`` over the axis of
the co-scheduled rows, whose combine tree (and on the card, whose thread
split) grows with the traffic.  ``analysis_trace()`` records it for the
checker's fixture mode.  The checker must flag
  * hazards/batch-extent-reduction
"""

from __future__ import annotations

import torch

from repro_torch.analysis.trace_utils import record

BATCH = 13
DIM = 16


def center_by_batch(x):
    """x: (B, D) f32 -> x minus the batch mean of each feature."""
    # VIOLATION: a float reduction whose extent is the batch
    mean = torch.sum(x, dim=0) / x.shape[0]
    return x - mean


def analysis_trace():
    x = torch.randn((BATCH, DIM), generator=torch.Generator().manual_seed(0))
    log, _ = record(center_by_batch, x)
    return log, BATCH
