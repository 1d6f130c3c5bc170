"""The training GEMMs' backward products: ``csrc/gemm_grad.cu``.

``gemm_grad(a, b)`` is ``a @ b`` in one f32 pass, rounded once to bf16: the
commit GEMM's function at one chunk (``ref.gemm_grad``), with a
compute-bound tile for training's token counts.  It replaces no TPU kernel
(the reference differentiates ``repro/core/determinism.py::matmul``
through XLA); ``ops.GemmGrad`` calls it for bf16 operands.

The operands are read in place: each may be row-major or column-major (a
transposed view, as autograd hands over ``w.t()`` and ``x.t()``), with a
leading stride and a base that TMA takes (16-byte aligned).  An operand
that is neither, or whose stride or base is unaligned, is copied into
16-byte-aligned rows first (``aligned_rows``): a (rows, cols) view with a
cols dimension that is no multiple of 8, which no bf16 config of the port
stores.  The contraction needs no padding: TMA fills past its edge with
zeros.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises; a meta tensor (``launch.dryrun``) runs the card path's operand
checks and returns a meta output.  ``gemm_grad.launches`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, recording, ref
from repro_torch.kernels.gemm_batch_invariant import meta_product

#: TMA's alignment of a row stride and a base, in bf16 elements and bytes
ALIGN, ALIGN_BYTES = 8, 16


def operand_layout(t: torch.Tensor) -> Tuple[int, int]:
    """``(column_major, ld)`` of a 2-D view the kernel reads in place:
    (0, row stride) for contiguous rows, (1, column stride) for contiguous
    columns; ``(-1, 0)`` when it takes neither (a stride or base not
    16-byte aligned, or no unit stride)."""
    rows, cols = t.shape
    s0, s1 = t.stride()
    if t.data_ptr() % ALIGN_BYTES == 0:
        if s1 == 1 and s0 % ALIGN == 0 and s0 >= cols:
            return 0, s0
        if s0 == 1 and s1 % ALIGN == 0 and s1 >= rows:
            return 1, s1
    return -1, 0


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """A row-major copy of ``t`` whose row stride is a multiple of 8 (the
    columns past ``t``'s are never read)."""
    rows, cols = t.shape
    buf = torch.empty((rows, -(-cols // ALIGN) * ALIGN), dtype=t.dtype, device=t.device)
    out = buf[:, :cols]
    out.copy_(t)
    return out


def _in_place(t: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """``t`` (or its aligned copy) and its ``operand_layout``."""
    major, ld = operand_layout(t)
    if major < 0:
        t = aligned_rows(t)
        major, ld = operand_layout(t)
    return t, major, ld


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.bfloat16 or b.dtype != a.dtype:
        raise TypeError(f"gemm_grad: dtypes {a.dtype}, {b.dtype} (bf16 only)")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_grad: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type not in ("cuda", "meta") or b.device != a.device:
        raise ValueError(f"gemm_grad: a on {a.device}, b on {b.device}")


def gemm_grad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) bf16: one f32 pass, rounded once.
    Either operand may be a transposed view."""
    if recording.active is not None:
        return recording.active.kernel(gemm_grad, (a, b))
    if a.device.type == "cpu":
        return ref.gemm_grad(a, b)
    _check(a, b)
    if a.device.type == "meta":
        return meta_product(a, b)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    a, a_cols, lda = _in_place(a)  # column-major a: M-major
    b, b_cols, ldb = _in_place(b)  # column-major b: K-major
    lib = build.load("gemm_grad")
    rc = lib.repro_gemm_grad(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, a_cols, lda,
        1 - b_cols, ldb, torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(lib, rc, "gemm_grad")
    gemm_grad.launches += 1
    return out


recording.counted(gemm_grad)
