"""Reduction schedules: the root cause of (non-)determinism (paper §2.2).

PyTorch counterpart of ``repro.core.determinism``.  A ``Schedule`` names the
reduction tree of every GEMM and attention softmax in the model; the fast
path derives it from the dynamic batch size (``ReductionPolicy``), the
verifier pins it (``VERIFY_SCHEDULE``).  The values and names are the JAX
package's; the arithmetic lives in ``repro_torch.kernels``:

* ``matmul`` dispatches to ``kernels.ops.matmul``, which sends the commit
  path to the batch-invariant GEMM and the fast path to the split-K GEMM
  (hand-written Hopper kernels on the card, their plain versions on the
  CPU).  ``torch.matmul`` is never the model's GEMM: cuBLAS picks its tiles
  and split-K from M, the batch-dependent reduction this system exists to
  control.
* ``segment_reduce_sum`` (the norms' feature reduction) and ``tree_combine``
  are plain tensor code, as in the reference; the one-pass reduction is a
  fixed tree of elementwise adds, so each row's sum is independent of the
  row count on the card too.

A schedule with ``tp_shards > 1`` cuts K into that many chunks above its
split schedule: pinned (the commit path), the chunk partials combine by the
balanced f32 tree; un-pinned (the fast path at ``Engine(tp=N)``), in chunk
order through ``combine_dtype``, as a width-N ring all-reduce would.  The
pinned tree is realizable bitwise across ranks: on a ``model`` axis of
width d, a power of two dividing ``tp_shards``, each rank sums its local
subtree and a recursive-doubling butterfly completes the top log2(d)
levels in the same association (``distributed.sharding.tp_matmul``, over
``torch.distributed``), so the product equals this module's ``matmul``.
"""

from __future__ import annotations

import contextlib
import enum
import os
from typing import Iterator, List, NamedTuple

import torch


class Mode(enum.Enum):
    NONDET = "nondet"
    BATCH_INVARIANT = "batch_invariant"
    LLM42 = "llm42"


class Schedule(NamedTuple):
    """A concrete reduction schedule (fields as in ``repro.core.determinism``).

    ``splits``        K-split count for GEMM reductions.
    ``kv_splits``     sequence-split count for decode attention.
    ``combine_dtype`` dtype in which split partials are combined.
    ``moe_no_drop``   disable MoE capacity dropping (verifier schedule).
    ``tp_shards``     contiguous K chunks of the tensor-parallel reduction.
    ``tp_pinned``     True pins the chunk partials to the canonical f32
                      balanced-tree combine (the commit path).
    """

    splits: int = 1
    kv_splits: int = 1
    combine_dtype: str = "float32"
    moe_no_drop: bool = False
    tp_shards: int = 1
    tp_pinned: bool = False


#: The canonical mesh-reduction decomposition of the commit path.
CANONICAL_TP_SHARDS = 4

#: The verifier's schedule: no batch-dependent splits, f32 combine, and the
#: canonical pinned TP tree (4 f32 chunk partials, ``((p0+p1)+(p2+p3))``).
VERIFY_SCHEDULE = Schedule(
    splits=1, kv_splits=1, combine_dtype="float32", moe_no_drop=True,
    tp_shards=CANONICAL_TP_SHARDS, tp_pinned=True,
)

CANONICAL_MESH_SCHEDULE = VERIFY_SCHEDULE

#: The universal schedule used by BATCH_INVARIANT mode for *all* traffic.
INVARIANT_SCHEDULE = VERIFY_SCHEDULE


class ReductionPolicy(NamedTuple):
    """Maps batch size -> Schedule, like a GPU kernel autotuner."""

    thresholds: tuple = ((4, 8), (16, 4), (64, 2))  # (batch_upper_bound, splits)
    default_splits: int = 1
    combine_dtype: str = "float32"

    def schedule_for(self, batch_size: int) -> Schedule:
        for bound, splits in self.thresholds:
            if batch_size < bound:
                return Schedule(
                    splits=splits, kv_splits=splits, combine_dtype=self.combine_dtype
                )
        return Schedule(
            splits=self.default_splits,
            kv_splits=self.default_splits,
            combine_dtype=self.combine_dtype,
        )


#: Default fast-path policy (bf16 combine, as in the reference).
FAST_PATH_POLICY = ReductionPolicy(combine_dtype="bfloat16")

#: Drift from reordering alone (f32 combine).
REORDER_ONLY_POLICY = ReductionPolicy(combine_dtype="float32")


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the schedule's dtype names)."""
    return getattr(torch, name)


def _split_sizes(k: int, splits: int) -> List[int]:
    """Partition K into ``splits`` contiguous chunks, remainder spread over
    the leading chunks (a pure function of (k, splits))."""
    base, rem = divmod(k, splits)
    return [base + (1 if i < rem else 0) for i in range(splits)]


def tree_combine(parts: list) -> torch.Tensor:
    """Balanced binary tree sum: ``((p0+p1)+(p2+p3))`` for four partials."""
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def matmul(x: torch.Tensor, w: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """``x @ w`` under ``schedule`` (contraction over x's last dim and w's
    first); output dtype follows x.  See ``kernels.ops.matmul``."""
    from repro_torch.kernels import ops

    return ops.matmul(x, w, schedule)


def fixed_order(schedule: Schedule) -> bool:
    """True when a recurrent layer's per-step reductions run as fixed trees
    (``_pairwise_sum``): the schedules without splits, which also run the
    commit GEMM (``kernels.ops``).  A split schedule (the fast path) may
    keep library reductions, whose order can follow the batch."""
    return schedule.splits <= 1


def _pairwise_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum over ``axis`` by a fixed halving tree of elementwise adds: element
    i meets element i + n//2 at each level (an odd tail joins the next level
    as is).  Every output element's bits depend on its own row alone, on
    any device and at any row count."""
    while x.shape[axis] > 1:
        n = x.shape[axis]
        h = n // 2
        head = x.narrow(axis, 0, h) + x.narrow(axis, h, h)
        x = torch.cat([head, x.narrow(axis, 2 * h, 1)], dim=axis) if n % 2 else head
    return x.squeeze(axis)


def segment_reduce_sum(x: torch.Tensor, axis: int, schedule: Schedule) -> torch.Tensor:
    """Sum-reduction with a schedule-dependent tree (for norms).

    splits==1 reduces in f32 in one pass, through ``_pairwise_sum``: a
    library reduction (``torch.sum`` on CUDA) picks its thread split from
    the row count, which would make the commit path's norms batch-variant.
    Otherwise the axis is chunked and partials combine sequentially in
    combine_dtype (the fast path may vary with the batch).
    """
    n = x.shape[axis]
    if schedule.splits <= 1 or schedule.splits > n:
        return _pairwise_sum(x.float(), axis)
    cd = torch_dtype(schedule.combine_dtype)
    acc = None
    for xc in torch.split(x, _split_sizes(n, schedule.splits), dim=axis):
        partial = xc.float().sum(dim=axis).to(cd)
        acc = partial if acc is None else acc + partial
    return acc.float()


@contextlib.contextmanager
def deterministic_torch() -> Iterator[None]:
    """Run the enclosed device work with PyTorch's deterministic algorithms
    on and TF32 off, restoring the caller's settings afterwards.

    The paged forward writes pad rows to the scratch block through
    duplicate indices (``models.layers.attention_paged``); on CUDA,
    ``index_put_`` with duplicates is deterministic only in this mode.  The
    W>1 gathered attention is plain ``einsum`` and must not run in TF32.
    cuBLAS refuses deterministic mode without a workspace config, so one is
    set when the caller has not chosen one.
    """
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det, warn_only=warn)
        torch.backends.cuda.matmul.allow_tf32 = tf32
