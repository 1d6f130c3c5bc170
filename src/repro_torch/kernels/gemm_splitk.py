"""Fast-path split-K GEMM wrapper: ``csrc/gemm_splitk.cu``.

Replaces ``repro/kernels/gemm_splitk.py::gemm_splitk`` and the
tensor-parallel fold of ``repro.core.determinism.matmul``.  A CPU tensor
runs the plain version (``ref.gemm_splitk``); a CUDA tensor launches the
kernel or raises; a meta tensor runs the card path's checks and returns a
meta output (``meta_product``).  ``gemm_splitk.launches`` counts kernel
launches, those of ``gemm_splitk_partials`` (the same library's partials
entry: the TP chunk values before the cross-chunk fold, which
``distributed.sharding.tp_matmul`` combines across ranks) included.
"""

# det: fastpath
from __future__ import annotations

import torch

from repro_torch.kernels import build, recording, ref
from repro_torch.kernels.gemm_batch_invariant import check_operands, meta_product

#: the widest TP fold the kernel takes (``MAX_TP`` in ``csrc/gemm_splitk.cu``)
MAX_TP = 16


def _check_schedule(name: str, K: int, splits: int, tp_shards: int,
                    combine_dtype: str) -> None:
    if combine_dtype not in build.DTYPE_CODES:
        raise ValueError(f"{name}: combine_dtype {combine_dtype!r}")
    if splits < 1 or not 1 <= tp_shards <= min(K, MAX_TP):
        raise ValueError(f"{name}: splits={splits}, tp_shards={tp_shards} "
                         f"(1..{min(K, MAX_TP)})")


def gemm_splitk(x: torch.Tensor, w: torch.Tensor, *, splits: int,
                combine_dtype: str = "float32", tp_shards: int = 1,
                tp_pinned: bool = False) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x.dtype.  K is cut into
    ``tp_shards`` chunks (``_split_sizes``), each reduced under the split
    schedule: ``splits`` sub-chunks folded in split order through
    ``combine_dtype`` (one f32 pass where the chunk is narrower than
    ``splits``).  The chunks fold in order through ``combine_dtype``, or by
    the balanced f32 tree when ``tp_pinned``.  ``tp_shards=1`` is the plain
    split-K GEMM."""
    if recording.active is not None:
        return recording.active.kernel(
            gemm_splitk, (x, w), splits=splits, combine_dtype=combine_dtype,
            tp_shards=tp_shards, tp_pinned=tp_pinned)
    if x.device.type == "cpu":
        return ref.gemm_splitk(x, w, splits, combine_dtype,
                               tp_shards=tp_shards, tp_pinned=tp_pinned)
    check_operands("gemm_splitk", x, w)
    if x.device.type not in ("cuda", "meta") or w.device != x.device:
        raise ValueError(f"gemm_splitk: x on {x.device}, w on {w.device}")
    M, K = x.shape
    N = w.shape[1]
    _check_schedule("gemm_splitk", K, splits, tp_shards, combine_dtype)
    if x.device.type == "meta":
        return meta_product(x, w)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    # tp_shards * splits f32 partials: 131 MB at an LM head of N = 128256,
    # M = 8, tp 4 x splits 8; the caching allocator hands the same block
    # back on the next call of the shape, so no call pays a cudaMalloc
    part = torch.empty((tp_shards * splits, M, N), dtype=torch.float32,
                       device=x.device)
    lib = build.load("gemm_splitk")
    rc = lib.repro_gemm_splitk(
        x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(),
        M, N, K, tp_shards, splits, int(tp_pinned),
        build.DTYPE_CODES[combine_dtype], build.DTYPE_CODES[str(x.dtype)[6:]],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, rc, "gemm_splitk")
    gemm_splitk.launches += 1
    return out


gemm_splitk.launches = 0


def gemm_splitk_partials(x: torch.Tensor, w: torch.Tensor, *, splits: int,
                         combine_dtype: str = "float32",
                         tp_shards: int = 1) -> torch.Tensor:
    """The TP chunk values of ``gemm_splitk(x, w, splits=, combine_dtype=,
    tp_shards=)`` before its cross-chunk fold: (tp_shards, M, N) f32, chunk
    t the t-th ``_split_sizes`` slice of K reduced under the split schedule
    (``ref.gemm_splitk_partials``).  On the card one launch of the
    library's partials entry, counted in ``gemm_splitk.launches``, on the
    operands' own dtype (f32 operands would take the f32 tile, other bits
    than the bf16 logical GEMM's).  ``x`` may be a column slice: the card
    path copies it, the plain version reads it in place, as the logical
    GEMM reads its chunks."""
    if recording.active is not None:
        return recording.active.kernel(
            gemm_splitk_partials, (x, w), splits=splits,
            combine_dtype=combine_dtype, tp_shards=tp_shards)
    if x.device.type == "cpu":
        return torch.stack(ref.gemm_splitk_partials(
            x, w, splits, combine_dtype, tp_shards=tp_shards))
    x = x.contiguous()
    check_operands("gemm_splitk_partials", x, w)
    if x.device.type not in ("cuda", "meta") or w.device != x.device:
        raise ValueError(f"gemm_splitk_partials: x on {x.device}, w on {w.device}")
    M, K = x.shape
    N = w.shape[1]
    _check_schedule("gemm_splitk_partials", K, splits, tp_shards, combine_dtype)
    if x.device.type == "meta":
        return meta_product(x, w).to(torch.float32).expand(tp_shards, M, N)
    vals = torch.empty((tp_shards, M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return vals
    part = torch.empty((tp_shards * splits, M, N), dtype=torch.float32,
                       device=x.device)
    lib = build.load("gemm_splitk")
    rc = lib.repro_gemm_splitk_partials(
        x.data_ptr(), w.data_ptr(), part.data_ptr(), vals.data_ptr(),
        M, N, K, tp_shards, splits, build.DTYPE_CODES[combine_dtype],
        build.DTYPE_CODES[str(x.dtype)[6:]],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, rc, "gemm_splitk_partials")
    gemm_splitk.launches += 1
    return vals
