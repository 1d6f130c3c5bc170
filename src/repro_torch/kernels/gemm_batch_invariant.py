"""Commit-path GEMM wrapper: ``csrc/gemm_batch_invariant.cu``.

Replaces ``repro/kernels/gemm_batch_invariant.py::gemm_batch_invariant``.
A CPU tensor runs the plain version (``ref.gemm_batch_invariant``); a CUDA
tensor launches the kernel or raises.  ``gemm_batch_invariant.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: canonical chunk trees the kernel's combine pass supports
MAX_CHUNKS = 8
_DTYPES = (torch.bfloat16, torch.float32)


def gemm_batch_invariant(x: torch.Tensor, w: torch.Tensor, *,
                         chunks: int = 1) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x.dtype: ``chunks`` contiguous K
    chunks, each one f32 pass, combined by the balanced f32 tree."""
    if x.device.type == "cpu":
        return ref.gemm_batch_invariant(x, w, chunks=chunks)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gemm_batch_invariant: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gemm_batch_invariant: dtypes {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_batch_invariant: shapes {x.shape} @ {w.shape}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm_batch_invariant: operands must be contiguous")
    M, K = x.shape
    N = w.shape[1]
    vec = 16 // w.element_size()
    if N % vec or not 1 <= chunks <= min(MAX_CHUNKS, K):
        raise ValueError(f"gemm_batch_invariant: N={N} (multiple of {vec}), "
                         f"chunks={chunks} (1..{MAX_CHUNKS}, <= K={K})")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    part = torch.empty((chunks, M, N), dtype=torch.float32, device=x.device)
    lib = build.load("gemm_batch_invariant")
    rc = lib.repro_gemm_batch_invariant(
        x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(),
        M, N, K, chunks, build.DTYPE_CODES[str(x.dtype)[6:]],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, rc, "gemm_batch_invariant")
    gemm_batch_invariant.launches += 1
    return out


gemm_batch_invariant.launches = 0
