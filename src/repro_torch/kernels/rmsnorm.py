"""Fused (residual +) RMSNorm wrapper: ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm``.  Its contract is
``ref.rmsnorm`` (one f32 pass per row, ``scale`` applied in f32 before the
round), not the model's ``models.layers.rms_norm``, so, as in the JAX
package, it is reached through ``kernels.ops.rmsnorm`` and not from the
model.  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises; a meta tensor runs the card path's checks and returns an
empty meta output (FLOP counters count only contractions).  The kernel
reads ``scale`` in its own dtype (bf16 or f32), so a call is one launch.
``rmsnorm.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, recording, ref

_DTYPES = (torch.bfloat16, torch.float32)
#: the widest row the kernel holds: a cluster of 8 CTAs of 4 warps, 8
#: 16-byte vectors a lane (csrc RN_MAX_CLUSTER, RN_WARPS, RN_MAX_VPT)
MAX_D = {torch.bfloat16: 65536, torch.float32: 32768}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            residual: Optional[torch.Tensor] = None, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x (M, D), scale (D,), residual (M, D) or None -> (M, D) in x.dtype."""
    if recording.active is not None:
        return recording.active.kernel(rmsnorm, (x, scale, residual), eps=eps)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps, residual)
    tensors = (x, scale) + ((residual,) if residual is not None else ())
    if x.device.type not in ("cuda", "meta") or any(t.device != x.device for t in tensors):
        raise ValueError("rmsnorm: every tensor must be on one CUDA or meta device")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES or (
            residual is not None and residual.dtype != x.dtype):
        raise TypeError(f"rmsnorm: dtypes x {x.dtype}, scale {scale.dtype}, "
                        f"residual {None if residual is None else residual.dtype}")
    if x.dim() != 2 or scale.shape != (x.shape[1],) or (
            residual is not None and residual.shape != x.shape):
        raise ValueError(f"rmsnorm: shapes x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, residual "
                         f"{None if residual is None else tuple(residual.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rmsnorm: every tensor must be contiguous")
    M, D = x.shape
    if D > MAX_D[x.dtype]:
        raise ValueError(f"rmsnorm: D={D} > {MAX_D[x.dtype]} for {x.dtype}")
    out = torch.empty_like(x)
    if M == 0 or x.device.type == "meta":
        return out
    lib = build.load("rmsnorm")
    rc = lib.repro_rmsnorm(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        scale.data_ptr(), out.data_ptr(), M, D, eps,
        build.DTYPE_CODES[str(x.dtype)[6:]], build.DTYPE_CODES[str(scale.dtype)[6:]],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


recording.counted(rmsnorm)
