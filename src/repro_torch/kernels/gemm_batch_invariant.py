"""Commit-path GEMM wrapper: ``csrc/gemm_batch_invariant.cu``.

Replaces ``repro/kernels/gemm_batch_invariant.py::gemm_batch_invariant``.
A CPU tensor runs the plain version (``ref.gemm_batch_invariant``); a CUDA
tensor launches the kernel or raises; a meta tensor (``launch.dryrun``)
runs the card path's operand checks and returns a meta output of the
kernel's shape (``meta_product``), computing nothing.
``gemm_batch_invariant.launches`` counts kernel launches.
``gemm_batch_invariant_partials`` is the same launch read before its tree:
the f32 chunk partials, which ``distributed.sharding.tp_matmul`` combines
across ranks.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, recording, ref

#: canonical chunk trees the kernel's combine pass supports
MAX_CHUNKS = 8
_DTYPES = (torch.bfloat16, torch.float32)


def check_operands(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on GEMM operands the partial tiles do not take (both GEMMs).
    bf16 goes through TMA, which needs 16-byte row strides and bases (K and
    N multiples of 8); f32 loads w in 16-byte vectors (N a multiple of 4, a
    16-byte-aligned base)."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: dtypes {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    K, N = w.shape
    vec = 16 // w.element_size()
    if x.dtype == torch.bfloat16 and (K % vec or x.data_ptr() % 16):
        raise ValueError(f"{name}: bf16 needs K={K} a multiple of {vec} and "
                         "a 16-byte-aligned x")
    if N % vec:
        raise ValueError(f"{name}: N={N} must be a multiple of {vec}")
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: w must be 16-byte aligned")


def meta_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The meta branch's output: ``x @ w`` on meta tensors, which allocates
    and computes nothing but has the kernel's shape and dtype and shows
    its 2*M*N*K FLOPs to ``torch.utils.flop_counter.FlopCounterMode``."""
    return torch.mm(x, w)


def _check_launch(name: str, x: torch.Tensor, w: torch.Tensor, chunks: int) -> None:
    """The card path's checks (also run on meta tensors)."""
    check_operands(name, x, w)
    if x.device.type not in ("cuda", "meta") or w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if not 1 <= chunks <= min(MAX_CHUNKS, x.shape[1]):
        raise ValueError(f"{name}: chunks={chunks} (1..{MAX_CHUNKS}, <= K={x.shape[1]})")


def _launch(x: torch.Tensor, w: torch.Tensor, chunks: int, part: torch.Tensor,
            out: torch.Tensor) -> None:
    M, K = x.shape
    lib = build.load("gemm_batch_invariant")
    rc = lib.repro_gemm_batch_invariant(
        x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(),
        M, w.shape[1], K, chunks, build.DTYPE_CODES[str(x.dtype)[6:]],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, rc, "gemm_batch_invariant")
    gemm_batch_invariant.launches += 1


def gemm_batch_invariant(x: torch.Tensor, w: torch.Tensor, *,
                         chunks: int = 1) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x.dtype: ``chunks`` contiguous K
    chunks, each one f32 pass, combined by the balanced f32 tree."""
    if recording.active is not None:
        return recording.active.kernel(gemm_batch_invariant, (x, w), chunks=chunks)
    if x.device.type == "cpu":
        return ref.gemm_batch_invariant(x, w, chunks=chunks)
    _check_launch("gemm_batch_invariant", x, w, chunks)
    if x.device.type == "meta":
        return meta_product(x, w)
    M, N = x.shape[0], w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    part = torch.empty((chunks, M, N), dtype=torch.float32, device=x.device)
    _launch(x, w, chunks, part, out)
    return out


gemm_batch_invariant.launches = 0


def gemm_batch_invariant_partials(x: torch.Tensor, w: torch.Tensor, *,
                                  chunks: int = 1) -> torch.Tensor:
    """The f32 chunk partials of ``gemm_batch_invariant(x, w, chunks=)``
    before its tree: (chunks, M, N), chunk c ``x[:, kc] @ w[kc]`` in one f32
    pass over the c-th ``_split_sizes`` slice of K (``ref.gemm_partials``).
    On the card this is the commit GEMM's own launch, counted as one, with
    its ``part`` workspace returned (its combine pass runs too, into an
    output nobody reads).  ``x`` may be a column slice: the card path copies
    it, the plain version reads it in place, as the logical GEMM reads its
    chunks."""
    if recording.active is not None:
        return recording.active.kernel(gemm_batch_invariant_partials, (x, w),
                                       chunks=chunks)
    if x.device.type == "cpu":
        return torch.stack(ref.gemm_partials(x, w, chunks=chunks))
    x = x.contiguous()
    _check_launch("gemm_batch_invariant_partials", x, w, chunks)
    M, N = x.shape[0], w.shape[1]
    if x.device.type == "meta":
        return meta_product(x, w).to(torch.float32).expand(chunks, M, N)
    part = torch.empty((chunks, M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return part
    _launch(x, w, chunks, part, torch.empty((M, N), dtype=x.dtype, device=x.device))
    return part
