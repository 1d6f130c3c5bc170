"""Schedule-aware dispatch onto the four kernels.

* ``matmul(x, w, schedule)``: the pinned commit schedule (``tp_shards``
  chunks, balanced f32 tree, ``splits == 1``) goes to the batch-invariant
  GEMM; an un-split schedule without TP chunks too (one chunk); every other
  ``tp_shards == 1`` schedule goes to the split-K GEMM with
  ``_split_sizes`` chunks, uneven where ``splits`` does not divide K, as
  ``repro.core.determinism.matmul`` computes on the model path.  (The JAX
  package's Pallas dispatch drops to one split instead; the model path on
  the TPU never takes it.)  Un-pinned TP schedules wait for ``distributed/``.
* ``paged_attention(..., schedule)``: ``kv_splits == 1`` selects the commit
  kernel; a split count that divides the table reach selects the fast
  kernel; one that does not falls back to the commit kernel, as
  ``repro.kernels.ops.paged_attention`` does on the TPU.

Each kernel wrapper runs its plain version on a CPU tensor and the Hopper
kernel on a CUDA tensor, so this module never falls back by itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.determinism import Schedule
from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
from repro_torch.kernels.gemm_splitk import gemm_splitk
from repro_torch.kernels.paged_attention import (
    paged_attention as _paged_attention,
    paged_attention_fast as _paged_attention_fast,
)


def matmul(x: torch.Tensor, w: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """Schedule-aware GEMM.  x (..., K), w (K, N) -> (..., N) in x.dtype."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    if schedule.tp_shards > 1 and schedule.tp_shards <= K:
        if not schedule.tp_pinned or schedule.splits > 1:
            raise NotImplementedError(
                "split or un-pinned tensor-parallel schedules wait for the "
                "distributed/ port")
        out = gemm_batch_invariant(x2, w, chunks=schedule.tp_shards)
    elif schedule.splits <= 1 or schedule.splits > K:
        out = gemm_batch_invariant(x2, w, chunks=1)
    else:
        out = gemm_splitk(x2, w, splits=schedule.splits,
                          combine_dtype=schedule.combine_dtype)
    return out.reshape(*lead, w.shape[1])


def paged_attention(
    q: torch.Tensor,         # (B, H, D)
    k_pool: torch.Tensor,    # (NB, bs, KV, D)
    v_pool: torch.Tensor,    # (NB, bs, KV, D)
    pos_pool: torch.Tensor,  # (NB, bs)
    tables: torch.Tensor,    # (B, nblk)
    q_pos: torch.Tensor,     # (B,)
    schedule: Schedule,
    *,
    null_bid: Optional[int] = None,
) -> torch.Tensor:
    """Paged decode attention through the block table -> (B, H, D) f32."""
    nblk = tables.shape[1]
    splits = schedule.kv_splits if nblk % max(schedule.kv_splits, 1) == 0 else 1
    args = (q.contiguous(), k_pool, v_pool, pos_pool,
            tables.to(torch.int32).contiguous(),
            q_pos.to(torch.int32).contiguous())
    if splits <= 1:
        return _paged_attention(*args, null_bid=null_bid)
    return _paged_attention_fast(
        *args, kv_splits=splits, combine_dtype=schedule.combine_dtype,
        null_bid=null_bid)
