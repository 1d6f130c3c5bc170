"""Paged decode attention wrappers: ``csrc/paged_attention.cu``.

Replaces ``repro/kernels/paged_attention.py``: ``paged_attention`` (commit
path, one softmax per row over the table reach) and ``paged_attention_fast``
(``# det: fastpath``, kv-split flash-decode with the TPU kernel's rounding
points).  A CPU tensor runs the plain version (``ref``); a CUDA tensor
launches the kernel or raises; a meta tensor runs the card path's checks
and returns a meta output (``decode_attention.meta_attention``).  Each
function's ``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, recording, ref
from repro_torch.kernels.decode_attention import meta_attention

_DTYPES = (torch.bfloat16, torch.float32)


def _check(q, k_pool, v_pool, pos_pool, tables, q_pos, null_bid, name):
    """Validate a CUDA (or meta) launch; returns (B, H, KV, D, bs, nblk,
    dtype code)."""
    tensors = (q, k_pool, v_pool, pos_pool, tables, q_pos)
    if q.device.type not in ("cuda", "meta") or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA or meta device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if any(t.dtype != torch.int32 for t in (pos_pool, tables, q_pos)):
        raise TypeError(f"{name}: pos_pool, tables and q_pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    B, H, D = q.shape
    NB, bs, KV, D2 = k_pool.shape
    if (v_pool.shape != k_pool.shape or pos_pool.shape != (NB, bs) or D2 != D
            or tables.dim() != 2 or tables.shape[0] != B or q_pos.shape != (B,)
            or H % KV or H // KV > 32 or D % 16 or not 16 <= D <= 256):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, pos {tuple(pos_pool.shape)}, "
                         f"tables {tuple(tables.shape)}, q_pos {tuple(q_pos.shape)}")
    if null_bid is not None and null_bid != NB - 2:
        # the kernels skip -1 entries, which read the pool's own null block
        raise ValueError(f"{name}: null_bid must be the pool's null block {NB - 2}")
    return B, H, KV, D, bs, tables.shape[1], build.DTYPE_CODES[str(q.dtype)[6:]]


def paged_attention(
    q: torch.Tensor,         # (B, H, D)
    k_pool: torch.Tensor,    # (NB, bs, KV, D)
    v_pool: torch.Tensor,    # (NB, bs, KV, D)
    pos_pool: torch.Tensor,  # (NB, bs) int32, -1 = empty
    tables: torch.Tensor,    # (B, nblk) int32, -1 = unallocated
    q_pos: torch.Tensor,     # (B,) int32
    *,
    null_bid: Optional[int] = None,
) -> torch.Tensor:
    """Commit-path paged attention -> (B, H, D) f32."""
    if recording.active is not None:
        return recording.active.kernel(
            paged_attention, (q, k_pool, v_pool, pos_pool, tables, q_pos),
            null_bid=null_bid)
    if q.device.type == "cpu":
        return ref.paged_attention(
            q, k_pool, v_pool, pos_pool, tables, q_pos, null_bid=null_bid)
    B, H, KV, D, bs, nblk, dt = _check(
        q, k_pool, v_pool, pos_pool, tables, q_pos, null_bid, "paged_attention")
    if q.device.type == "meta":
        return meta_attention(q, nblk * bs, KV)
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    lib = build.load("paged_attention")
    rc = lib.repro_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pos_pool.data_ptr(),
        tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        B, H, KV, D, bs, nblk, D ** -0.5, dt,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, rc, "paged_attention")
    paged_attention.launches += 1
    return out


# det: fastpath
def paged_attention_fast(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pos_pool: torch.Tensor,
    tables: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    kv_splits: int,
    combine_dtype: str = "float32",
    null_bid: Optional[int] = None,
) -> torch.Tensor:
    """Fast-path kv-split paged attention -> (B, H, D) f32."""
    if recording.active is not None:
        return recording.active.kernel(
            paged_attention_fast, (q, k_pool, v_pool, pos_pool, tables, q_pos),
            kv_splits=kv_splits, combine_dtype=combine_dtype, null_bid=null_bid)
    if q.device.type == "cpu":
        return ref.paged_attention_fast(
            q, k_pool, v_pool, pos_pool, tables, q_pos, kv_splits=kv_splits,
            combine_dtype=combine_dtype, null_bid=null_bid)
    B, H, KV, D, bs, nblk, dt = _check(
        q, k_pool, v_pool, pos_pool, tables, q_pos, null_bid,
        "paged_attention_fast")
    if kv_splits < 1 or nblk % kv_splits:
        raise ValueError(f"kv_splits={kv_splits} must divide table reach {nblk}")
    if combine_dtype not in build.DTYPE_CODES:
        raise ValueError(f"paged_attention_fast: combine_dtype {combine_dtype!r}")
    if q.device.type == "meta":
        return meta_attention(q, nblk * bs, KV)
    G = H // KV
    dev = q.device
    m_part = torch.empty((B, KV, kv_splits, G), dtype=torch.float32, device=dev)
    d_part = torch.empty_like(m_part)
    o_part = torch.empty((B, KV, kv_splits, G, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    lib = build.load("paged_attention")
    rc = lib.repro_paged_attention_fast(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pos_pool.data_ptr(),
        tables.data_ptr(), q_pos.data_ptr(), m_part.data_ptr(),
        d_part.data_ptr(), o_part.data_ptr(), out.data_ptr(),
        B, H, KV, D, bs, nblk, kv_splits, D ** -0.5,
        build.DTYPE_CODES[combine_dtype], dt,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "paged_attention_fast")
    paged_attention_fast.launches += 1
    return out


paged_attention.launches = 0
paged_attention_fast.launches = 0
