"""Dense-cache decode attention wrapper: ``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention.py::decode_attention``: one query
token per row over a dense ``(B, S, KV, D)`` cache, keys masked unless
``s < lengths[b]``, ``kv_splits`` chunks merged in split order through
``combine_dtype``, q scaled by ``scale`` in f32 (default ``D**-0.5``, the
TPU kernel's).  A CPU tensor runs the plain version
(``ref.decode_attention``); a CUDA tensor launches the kernel or raises; a
meta tensor runs the card path's checks and returns a meta output
(``meta_attention``).  ``decode_attention.launches`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, recording, ref

_DTYPES = (torch.bfloat16, torch.float32)
#: query heads per KV head, a warp each (csrc GMAX)
MAX_GROUP = 8


def meta_attention(q: torch.Tensor, S: int, KV: int) -> torch.Tensor:
    """The attention wrappers' meta output: (B, H, D) f32 through the two
    contractions of one query a row over S keys, on meta tensors (nothing
    allocated or computed; ``FlopCounterMode`` sees 4*B*H*S*D FLOPs)."""
    B, H, D = q.shape
    qg = q.to(torch.float32).reshape(B, KV, H // KV, D)
    keys = torch.empty((B, S, KV, D), dtype=torch.float32, device=q.device)
    s = torch.einsum("bkgd,bskd->bkgs", qg, keys)
    return torch.einsum("bkgs,bskd->bkgd", s, keys).reshape(B, H, D)


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k: torch.Tensor,        # (B, S, KV, D)
    v: torch.Tensor,        # (B, S, KV, D)
    lengths: torch.Tensor,  # (B,) int32 valid cache positions
    *,
    kv_splits: int = 1,
    combine_dtype: str = "float32",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-decode attention -> (B, H, D) in q.dtype."""
    if recording.active is not None:
        return recording.active.kernel(
            decode_attention, (q, k, v, lengths), kv_splits=kv_splits,
            combine_dtype=combine_dtype, scale=scale)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, lengths, kv_splits, combine_dtype, scale)
    tensors = (q, k, v, lengths)
    if q.device.type not in ("cuda", "meta") or any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: every tensor must be on one CUDA or meta device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q/k/v dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("decode_attention: lengths must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: every tensor must be contiguous")
    B, H, D = q.shape
    if (k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or lengths.shape != (B,)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    S, KV = k.shape[1], k.shape[2]
    if H % KV or H // KV > MAX_GROUP or D % 16 or not 16 <= D <= 256:
        raise ValueError(f"decode_attention: H={H}, KV={KV} (group <= {MAX_GROUP}), "
                         f"D={D} (multiple of 16, 16..256)")
    if not 1 <= kv_splits <= S:
        raise ValueError(f"decode_attention: kv_splits={kv_splits} (1..S={S})")
    if combine_dtype not in build.DTYPE_CODES:
        raise ValueError(f"decode_attention: combine_dtype {combine_dtype!r}")
    if q.device.type == "meta":
        return meta_attention(q, S, KV).to(q.dtype)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = build.load("decode_attention")
    rc = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, KV, S, D, kv_splits,
        D ** -0.5 if scale is None else scale,
        build.DTYPE_CODES[combine_dtype], build.DTYPE_CODES[str(q.dtype)[6:]],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, rc, "decode_attention")
    decode_attention.launches += 1
    return out


recording.counted(decode_attention)
