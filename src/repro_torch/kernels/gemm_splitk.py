"""Fast-path split-K GEMM wrapper: ``csrc/gemm_splitk.cu``.

Replaces ``repro/kernels/gemm_splitk.py::gemm_splitk`` and the
tensor-parallel fold of ``repro.core.determinism.matmul``.  A CPU tensor
runs the plain version (``ref.gemm_splitk``); a CUDA tensor launches the
kernel or raises; a meta tensor runs the card path's checks and returns a
meta output (``meta_product``).  ``gemm_splitk.launches`` counts kernel launches.
"""

# det: fastpath
from __future__ import annotations

import torch

from repro_torch.kernels import build, recording, ref
from repro_torch.kernels.gemm_batch_invariant import check_operands, meta_product

#: the widest TP fold the kernel takes (``MAX_TP`` in ``csrc/gemm_splitk.cu``)
MAX_TP = 16


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
    if combine_dtype not in build.DTYPE_CODES:
        raise ValueError(f"gemm_splitk: combine_dtype {combine_dtype!r}")
    M, K = x.shape
    N = w.shape[1]
    if splits < 1 or not 1 <= tp_shards <= min(K, MAX_TP):
        raise ValueError(f"gemm_splitk: splits={splits}, tp_shards={tp_shards} "
                         f"(1..{min(K, MAX_TP)})")
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
