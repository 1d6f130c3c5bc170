"""Schedule-aware dispatch onto the kernels.

* ``matmul(x, w, schedule)``: the pinned commit schedule (``tp_shards``
  chunks, balanced f32 tree, ``splits == 1``) goes to the batch-invariant
  GEMM; an un-split schedule without TP chunks too (one chunk).  Every
  other schedule goes to the split-K GEMM, which folds two levels of
  ``_split_sizes`` chunks (TP chunks, then the splits inside each), uneven
  where a count does not divide its width, as
  ``repro.core.determinism.matmul`` computes on the model path: un-pinned
  TP schedules (the fast path at ``Engine(tp=N)``) at any ``splits``,
  pinned ones with ``splits > 1`` (no engine path makes them), and
  ``tp_shards == 1`` split schedules.  (The JAX package's Pallas dispatch
  drops to one split instead; the model path on the TPU never takes it.)
  When an operand requires grad, the launch runs inside ``GemmGrad``, whose
  backward computes the two products of JAX's autodiff of
  ``core.determinism.matmul``, each one f32 pass: ``gemm_grad`` (bf16) or
  the commit GEMM with one chunk (f32).
* ``paged_attention(..., schedule)``: ``kv_splits == 1`` selects the commit
  kernel; a split count that divides the table reach selects the fast
  kernel; one that does not falls back to the commit kernel, as
  ``repro.kernels.ops.paged_attention`` does on the TPU.
* ``decode_attention(q, k, v, lengths, schedule)``: dense-cache decode
  attention with ``schedule.kv_splits`` chunks, one chunk when the split
  count does not divide the cache length (``repro.kernels.ops``).
* ``rmsnorm(x, scale, residual, eps=...)``: the fused norm kernel over the
  rows of x's leading axes.

Each kernel wrapper runs its plain version on a CPU tensor and the Hopper
kernel on a CUDA tensor, so this module never falls back by itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.determinism import Schedule
from repro_torch.kernels.decode_attention import decode_attention as _decode_attention
from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
from repro_torch.kernels.gemm_grad import gemm_grad
from repro_torch.kernels.gemm_splitk import gemm_splitk
from repro_torch.kernels.paged_attention import (
    paged_attention as _paged_attention,
    paged_attention_fast as _paged_attention_fast,
)
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm


def matmul(x: torch.Tensor, w: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """Schedule-aware GEMM.  x (..., K), w (K, N) -> (..., N) in x.dtype,
    differentiable through ``GemmGrad`` when an operand requires grad."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        out = GemmGrad.apply(x2, w, schedule)
    else:
        out = _schedule_gemm(x2, w, schedule)
    return out.reshape(*lead, w.shape[1])


def _schedule_gemm(x2: torch.Tensor, w: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """The launch ``matmul`` dispatches to: x2 (M, K) @ w (K, N)."""
    K = x2.shape[-1]
    tp = schedule.tp_shards if 1 < schedule.tp_shards <= K else 1
    if tp > 1 and schedule.tp_pinned and schedule.splits <= 1:
        return gemm_batch_invariant(x2, w, chunks=tp)
    if tp == 1 and (schedule.splits <= 1 or schedule.splits > K):
        return gemm_batch_invariant(x2, w, chunks=1)
    return gemm_splitk(x2, w, splits=schedule.splits,
                       combine_dtype=schedule.combine_dtype, tp_shards=tp,
                       tp_pinned=schedule.tp_pinned)


def grad_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) in one f32 pass, rounded to a.dtype.  bf16
    operands go to ``gemm_grad``, which reads transposed views in place;
    f32 operands (the MoE experts' contractions, f32 configs) to the commit
    GEMM with one chunk, whose CUDA-core tile reads row-major copies."""
    if a.dtype == torch.bfloat16:
        return gemm_grad(a, b)
    return gemm_batch_invariant(a.contiguous(), b.contiguous(), chunks=1)


class GemmGrad(torch.autograd.Function):
    """``_schedule_gemm`` with the gradient of JAX's autodiff of
    ``core.determinism.matmul``.  There the output is rounded from f32 to
    x's dtype, so the cotangent dY reaches every chunk partial as is; a
    chunk's products are ``dY @ w_c^T`` and ``x_c^T @ dY``, each one f32
    pass rounded to x's and w's dtype, and the chunks' slices abut.  So
    whatever the forward's chunks or splits, ``dX = dY @ W^T`` and ``dW =
    X^T @ dY`` are each one f32-accumulated pass: ``grad_product``, the
    commit GEMM's function, never a library GEMM.  Its rows are independent
    of M, so dX's rows do not follow the token count.  The transposed
    operands are handed over as views (``w.t()``, ``x2.t()``), which
    ``gemm_grad`` reads in place."""

    @staticmethod
    def forward(ctx, x2, w, schedule):
        ctx.save_for_backward(x2, w)
        return _schedule_gemm(x2, w, schedule)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dy = dy.to(x2.dtype).contiguous()
        dx = grad_product(dy, w.t()) if ctx.needs_input_grad[0] else None
        dw = (grad_product(x2.t(), dy).to(w.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None


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


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k: torch.Tensor,        # (B, S, KV, D)
    v: torch.Tensor,        # (B, S, KV, D)
    lengths: torch.Tensor,  # (B,)
    schedule: Schedule,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense-cache decode attention -> (B, H, D) in q.dtype; q is scaled by
    ``scale`` in f32 (default D^-0.5)."""
    S = k.shape[1]
    splits = schedule.kv_splits if S % max(schedule.kv_splits, 1) == 0 else 1
    return _decode_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        lengths.to(torch.int32).contiguous(), kv_splits=max(splits, 1),
        combine_dtype=schedule.combine_dtype, scale=scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            residual: Optional[torch.Tensor] = None, *,
            eps: float = 1e-5) -> torch.Tensor:
    """Fused (residual +) RMSNorm over the last axis, any leading shape.
    The kernel's blocks follow D alone, so rows need no padding."""
    lead, D = x.shape[:-1], x.shape[-1]
    res = residual.reshape(-1, D).contiguous() if residual is not None else None
    out = _rmsnorm(x.reshape(-1, D).contiguous(), scale.contiguous(), res, eps=eps)
    return out.reshape(*lead, D)
