"""Plain PyTorch versions of the port's six Hopper kernels.

One function per kernel, with the JAX kernel's arguments and layouts.  The
wrappers (``gemm_batch_invariant.py``, ``gemm_splitk.py``,
``paged_attention.py``, ``decode_attention.py``, ``rmsnorm.py``) call these
for tensors on the CPU; ``chip_smoke.py``
holds each CUDA kernel against them on the card.  They are the numerical
contract, written for clarity: matmuls in f32 (TF32 must be off on the
card), the reduction trees spelled out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.determinism import _split_sizes, torch_dtype, tree_combine

F32 = torch.float32


def gemm_batch_invariant(x: torch.Tensor, w: torch.Tensor, *,
                         chunks: int = 1) -> torch.Tensor:
    """Commit GEMM.  x (M, K), w (K, N) -> (M, N) in x.dtype.

    K is cut into ``chunks`` contiguous chunks (``_split_sizes``), each
    reduced in one f32 pass, and the chunk partials are combined by the
    balanced f32 tree (``tree_combine``).  ``chunks=1`` is
    ``repro.kernels.gemm_batch_invariant``; ``chunks=4`` the commit path
    under ``VERIFY_SCHEDULE``."""
    parts = [
        xc.to(F32) @ wc.to(F32)
        for xc, wc in zip(
            torch.split(x, _split_sizes(x.shape[-1], chunks), dim=-1),
            torch.split(w, _split_sizes(x.shape[-1], chunks), dim=0),
        )
    ]
    return tree_combine(parts).to(x.dtype)


def gemm_splitk(x: torch.Tensor, w: torch.Tensor, splits: int,
                combine_dtype: str = "float32") -> torch.Tensor:
    """Fast split-K GEMM.  x (M, K), w (K, N) -> (M, N) in x.dtype.

    Per-chunk f32 partials over ``_split_sizes(K, splits)``; with
    ``splits > 1`` each partial is rounded to ``combine_dtype`` and folded in
    split order, the running sum rounded after each fold."""
    if splits <= 1:
        return (x.to(F32) @ w.to(F32)).to(x.dtype)
    cd = torch_dtype(combine_dtype)
    sizes = _split_sizes(x.shape[-1], splits)
    acc = None
    for xc, wc in zip(torch.split(x, sizes, dim=-1), torch.split(w, sizes, dim=0)):
        partial = (xc.to(F32) @ wc.to(F32)).to(cd)
        acc = partial if acc is None else acc + partial
    return acc.to(x.dtype)


def _view(
    k_pool: torch.Tensor, v_pool: torch.Tensor, pos_pool: torch.Tensor,
    tables: torch.Tensor, null_bid: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather each row's (nblk*bs) view through its table; ``-1`` entries
    read the null block (positions -1, always masked)."""
    B, nblk = tables.shape
    _, bs, KV, D = k_pool.shape
    nb = (k_pool.shape[0] - 2) if null_bid is None else null_bid
    tab = torch.where(tables < 0, nb, tables).long()
    kf = k_pool[tab].reshape(B, nblk * bs, KV, D).to(F32)
    vf = v_pool[tab].reshape(B, nblk * bs, KV, D).to(F32)
    pos = pos_pool[tab].reshape(B, nblk * bs)
    return kf, vf, pos


def _scaled_q(q: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, H, D) -> (B, KV, G, D) f32, scaled by D^-0.5 in f32 (the kernel
    route's rounding point)."""
    B, H, D = q.shape
    return q.to(F32).reshape(B, KV, H // KV, D) * (D ** -0.5)


def _scores(qg: torch.Tensor, kc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc)
    return s.masked_fill(~valid[:, None, None, :], float("-inf"))


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
    """Commit-path paged attention: one f32 softmax per row over the table
    reach, keys masked unless ``0 <= pos <= q_pos``.  Returns (B, H, D) f32."""
    B, H, D = q.shape
    KV = k_pool.shape[2]
    kf, vf, pos = _view(k_pool, v_pool, pos_pool, tables, null_bid)
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    s = _scores(_scaled_q(q, KV), kf, valid)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", e, vf) / denom.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, D)


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
    """Fast-path paged attention: ``kv_splits`` equal runs of table blocks.

    The TPU kernel's rounding points: per split the max ``m_c`` first, then
    ``e = exp(s - m_c)`` rounded to ``combine_dtype`` before it is summed
    (``d_c``, f32 sum of the rounded values) and multiplied into V; splits
    merge in f32 in split order.  Returns (B, H, D) f32."""
    B, H, D = q.shape
    KV = k_pool.shape[2]
    bs = k_pool.shape[1]
    nblk = tables.shape[1]
    if nblk % kv_splits:
        raise ValueError(f"kv_splits={kv_splits} must divide table reach {nblk}")
    cd = torch_dtype(combine_dtype)
    kf, vf, pos = _view(k_pool, v_pool, pos_pool, tables, null_bid)
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    qg = _scaled_q(q, KV)
    per = nblk // kv_splits * bs
    m = d = acc = None
    for sp in range(kv_splits):
        sl = slice(sp * per, (sp + 1) * per)
        s = _scores(qg, kf[:, sl], valid[:, sl])
        m_c = s.amax(dim=-1).clamp_min(-1e30)
        e = torch.exp(s - m_c[..., None]).to(cd).to(F32)
        d_c = e.sum(dim=-1)
        o_c = torch.einsum("bkgs,bskd->bkgd", e, vf[:, sl])
        if m is None:
            m, d, acc = m_c, d_c, o_c
        else:
            m_new = torch.maximum(m, m_c)
            a_prev, a_c = torch.exp(m - m_new), torch.exp(m_c - m_new)
            d = d * a_prev + d_c * a_c
            acc = acc * a_prev[..., None] + o_c * a_c[..., None]
            m = m_new
    return (acc / d.clamp_min(1e-30)[..., None]).reshape(B, H, D)


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k: torch.Tensor,        # (B, S, KV, D)
    v: torch.Tensor,        # (B, S, KV, D)
    lengths: torch.Tensor,  # (B,) valid cache positions
    kv_splits: int,
    combine_dtype: str = "float32",
) -> torch.Tensor:
    """Flash-decode over a dense cache: keys ``s < lengths[b]`` in
    ``kv_splits`` chunks (``_split_sizes``).  Per chunk an f32 (m, d, o)
    triple; ``d`` and ``o`` are rounded through ``combine_dtype`` at the
    first chunk and after every merge, in split order.  Returns (B, H, D) in
    q.dtype.

    The rounding points are the Pallas kernel's
    (``repro/kernels/decode_attention.py::_kernel``): q scaled by D^-0.5 in
    f32 and ``e`` kept in f32.  ``repro.kernels.ref.decode_attention``
    scales q in q.dtype instead; the two agree bitwise where D^-0.5 is a
    power of two (D = 64)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    cd = torch_dtype(combine_dtype)
    kf, vf = k.to(F32), v.to(F32)
    qg = _scaled_q(q, KV)
    valid = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    m = d = o = None
    start = 0
    for size in _split_sizes(S, kv_splits):
        sl = slice(start, start + size)
        s = _scores(qg, kf[:, sl], valid[:, sl])
        m_c = s.amax(dim=-1).clamp_min(-1e30)
        e = torch.exp(s - m_c[..., None])
        d_c = e.sum(dim=-1)
        o_c = torch.einsum("bkgs,bskd->bkgd", e, vf[:, sl])
        if m is None:
            m, d, o = m_c, d_c.to(cd).to(F32), o_c.to(cd).to(F32)
        else:
            m_new = torch.maximum(m, m_c)
            a1, a2 = torch.exp(m - m_new), torch.exp(m_c - m_new)
            d = (a1 * d + a2 * d_c).to(cd).to(F32)
            o = (a1[..., None] * o + a2[..., None] * o_c).to(cd).to(F32)
            m = m_new
        start += size
    return (o / d.clamp_min(1e-30)[..., None]).reshape(B, H, D).to(q.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused (residual-add +) RMSNorm over the last axis: the residual added
    in f32 and rounded to x.dtype, ``mean(x^2)`` in f32, ``x * rsqrt(var +
    eps) * scale`` in f32, rounded to x.dtype."""
    if residual is not None:
        x = (x.to(F32) + residual.to(F32)).to(x.dtype)
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)
