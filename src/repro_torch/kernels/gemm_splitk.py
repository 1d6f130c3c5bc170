"""Fast-path split-K GEMM wrapper: ``csrc/gemm_splitk.cu``.

Replaces ``repro/kernels/gemm_splitk.py::gemm_splitk``.  A CPU tensor runs
the plain version (``ref.gemm_splitk``); a CUDA tensor launches the kernel
or raises.  ``gemm_splitk.launches`` counts kernel launches.
"""

# det: fastpath
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.gemm_batch_invariant import check_operands


def gemm_splitk(x: torch.Tensor, w: torch.Tensor, *, splits: int,
                combine_dtype: str = "float32") -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x.dtype, K cut into ``splits``
    chunks (``_split_sizes``) folded in split order through
    ``combine_dtype``."""
    if x.device.type == "cpu":
        return ref.gemm_splitk(x, w, splits, combine_dtype)
    check_operands("gemm_splitk", x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gemm_splitk: x on {x.device}, w on {w.device}")
    if combine_dtype not in build.DTYPE_CODES:
        raise ValueError(f"gemm_splitk: combine_dtype {combine_dtype!r}")
    M, K = x.shape
    N = w.shape[1]
    if not 1 <= splits <= K:
        raise ValueError(f"gemm_splitk: splits={splits} (1..K={K})")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    lib = build.load("gemm_splitk")
    rc = lib.repro_gemm_splitk(
        x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(),
        M, N, K, splits, build.DTYPE_CODES[combine_dtype],
        build.DTYPE_CODES[str(x.dtype)[6:]],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, rc, "gemm_splitk")
    gemm_splitk.launches += 1
    return out


gemm_splitk.launches = 0
