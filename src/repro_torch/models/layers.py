"""Shared layers, dense subset: RMSNorm, RoPE, GQA attention over the paged
pool or over gathered per-row views, SwiGLU.

PyTorch counterpart of ``repro.models.layers``.  Every matrix multiply goes
through ``core.determinism.matmul`` with an explicit ``Schedule``, so the
schedule, not the code, decides the reduction tree of the whole forward
pass.  On the card that means every projection runs in one of the two
hand-written GEMMs.

Two memory lanes.  ``attention_paged`` reads and writes K/V through
per-row block tables; its single-token passes (W == 1) go to the paged
kernels (``kernels.ops.paged_attention``) on every device.
``attention_cached`` works on dense per-row views ``(B, C, KV, HD)`` that
the engine gathers from the pool and scatters back (``paged_attention=
False``); its single-token passes go to the dense-cache decode kernel
(``kernels.ops.decode_attention``) on every device, masked by ``lengths =
start_pos + 1``.  Both kernels scale the unscaled roped q in f32.
Multi-token passes (verify windows, prefill) run the same plain tensor code
(``einsum``, TF32 off) in both lanes, as the JAX package leaves them to
XLA, so the commit path is bitwise the same in both.  Unlike the JAX code,
which returns new caches, the leaves are updated in place.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.determinism import (
    Schedule, _split_sizes, matmul, segment_reduce_sum, torch_dtype,
)
from repro_torch.kernels import ops

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             schedule: Schedule) -> torch.Tensor:
    """RMSNorm with a schedule-dependent feature reduction (paper Fig. 4b)."""
    ss = segment_reduce_sum(x * x, axis=-1, schedule=schedule)
    inv = torch.rsqrt(ss / x.shape[-1] + eps)
    return (x.to(F32) * inv[..., None]).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply rotary embedding.  x: (..., T, H, D); positions: (..., T)."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=F32, device=x.device))
    freqs = torch.exp(-torch.arange(0, half, dtype=F32, device=x.device)
                      * (log_theta / half))
    ang = positions[..., None].to(F32) * freqs  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half: 2 * half].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                     x[..., 2 * half:].to(F32)], dim=-1)
    return out.to(x.dtype)


def _qkv(p: Dict, cfg, x: torch.Tensor, schedule: Schedule):
    """Project to q, k, v heads.  x: (B, T, D)."""
    B, T, _ = x.shape
    q = matmul(x, p["wq"], schedule).reshape(B, T, cfg.num_heads, cfg.hd)
    k = matmul(x, p["wk"], schedule).reshape(B, T, cfg.num_kv_heads, cfg.hd)
    v = matmul(x, p["wv"], schedule).reshape(B, T, cfg.num_kv_heads, cfg.hd)
    return q, k, v


def _softmax_attend(
    q: torch.Tensor,     # (B, T, H, D) pre-scaled
    k: torch.Tensor,     # (B, S, KV, D)
    v: torch.Tensor,     # (B, S, KV, D)
    mask: torch.Tensor,  # (B, T, S) bool or broadcastable
    schedule: Schedule,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """GQA attention with a schedule-dependent KV-split softmax combine.

    kv_splits == 1: one f32 softmax over the key axis.  kv_splits == S: the
    key axis is chunked (``_split_sizes``), each chunk's (max, exp-sum,
    weighted value) triple is computed in f32, and the triples combine
    sequentially in combine_dtype."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, D).to(F32)
    kf, vf = k.to(F32), v.to(F32)
    mask = mask.expand(B, T, S)

    def scores(kc, mc):
        s = torch.einsum("btkgd,bskd->btkgs", qg, kc)
        if logit_softcap > 0.0:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        return s.masked_fill(~mc[:, :, None, None, :], float("-inf"))

    splits = schedule.kv_splits
    if splits <= 1 or splits > S:
        s = scores(kf, mask)
        m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
        e = torch.exp(s - m)
        out = torch.einsum("btkgs,bskd->btkgd", e, vf)
        out = out / e.sum(dim=-1).clamp_min(1e-30)[..., None]
        return out.reshape(B, T, H, D)

    cd = torch_dtype(schedule.combine_dtype)
    m_acc = d_acc = o_acc = None
    start = 0
    for size in _split_sizes(S, splits):
        sl = slice(start, start + size)
        s = scores(kf[:, sl], mask[:, :, sl])
        m_c = s.amax(dim=-1).clamp_min(-1e30)
        e = torch.exp(s - m_c[..., None])
        d_c = e.sum(dim=-1)
        o_c = torch.einsum("btkgs,bskd->btkgd", e, vf[:, sl])
        if m_acc is None:
            m_acc, d_acc, o_acc = m_c, d_c.to(cd), o_c.to(cd)
        else:
            m_new = torch.maximum(m_acc, m_c)
            a1, a2 = torch.exp(m_acc - m_new), torch.exp(m_c - m_new)
            d_acc = (a1 * d_acc.to(F32) + a2 * d_c).to(cd)
            o_acc = (a1[..., None] * o_acc.to(F32) + a2[..., None] * o_c).to(cd)
            m_acc = m_new
        start += size
    out = o_acc.to(F32) / d_acc.to(F32).clamp_min(1e-30)[..., None]
    return out.reshape(B, T, H, D)


#: above this many query rows the JAX package attends q-chunked
#: (``_chunked_attend``); that path waits for a later slice
CHUNK_THRESHOLD = 2048


def attention_cached(
    p: Dict,
    cfg,
    x: torch.Tensor,          # (B, W, D)
    cache: Dict,              # {"k","v": (B, C, KV, HD), "pos": (B, C)}
    start_pos: torch.Tensor,  # (B,) absolute position of x[:, 0]
    schedule: Schedule,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict]:
    """Incremental attention over dense per-row views, full attention.

    Writes the W new tokens at slots ``abs_pos % C`` in place, then attends.
    W == 1 (decode) goes to ``ops.decode_attention`` with the unscaled
    roped q and ``lengths = start_pos + 1``: that mask equals the ``pos``
    mask because slot s holds position s (no wrap: ``forward`` asserts that
    every pass ends inside the view) and every position up to the query
    has been written.  W > 1 scales q in the activation dtype and runs
    ``_softmax_attend`` under the ``pos`` mask, exactly as the paged lane
    does.  Sliding rings (``window > 0``) and the q-chunked path wait."""
    B, W, _ = x.shape
    C = cache["k"].shape[1]
    if window > 0:
        raise NotImplementedError("sliding-window rings wait for a later slice")
    if W > CHUNK_THRESHOLD:
        raise NotImplementedError(
            f"a {W}-token pass needs the q-chunked attention, not ported yet")
    q, k_new, v_new = _qkv(p, cfg, x, schedule)
    abs_pos = start_pos[:, None].to(torch.int32) + torch.arange(
        W, dtype=torch.int32, device=x.device)[None, :]
    q = rope(q, abs_pos, cfg.rope_theta)
    k_new = rope(k_new, abs_pos, cfg.rope_theta)

    slots = (abs_pos % C).long()
    b_idx = torch.arange(B, device=x.device)[:, None]
    cache["k"][b_idx, slots] = k_new.to(cache["k"].dtype)
    cache["v"][b_idx, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][b_idx, slots] = abs_pos

    if W == 1 and cfg.logit_softcap == 0:
        # single-token decode: the dense-cache kernel, which scales q by
        # hd^-0.5 in f32 itself and masks by length
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                   abs_pos[:, 0] + 1, schedule)
    else:
        q = q * (cfg.hd ** -0.5)
        kp = cache["pos"][:, None, :]
        qp = abs_pos[:, :, None]
        mask = (kp >= 0) & (kp <= qp)
        out = _softmax_attend(q, cache["k"], cache["v"], mask, schedule,
                              cfg.logit_softcap)
    out = matmul(out.reshape(B, W, -1).to(x.dtype), p["wo"], schedule)
    return out, cache


class PagedView(NamedTuple):
    """Static geometry of a paged KV pool, threaded into the forward pass."""

    block_size: int
    null_bid: int  # reads through -1 table entries land here (pos == -1)
    scratch_bid: int  # writes past the table land here (never read)


def attention_paged(
    p: Dict,
    cfg,
    x: torch.Tensor,       # (B, W, D)
    cache: Dict,           # {"k","v": (NB+2, bs, KV, HD), "pos": (NB+2, bs)}
    tables: torch.Tensor,  # (B, nblk) int32 block ids, -1 = unallocated
    start_pos: torch.Tensor,  # (B,) absolute position of x[:, 0]
    schedule: Schedule,
    paged: PagedView,
) -> Tuple[torch.Tensor, Dict]:
    """Incremental attention reading/writing K/V through the block table.

    Writes for the W new tokens go to ``tables[b, abs_pos // block_size]``
    in place; positions past the table (pad rows, pad window tails) land in
    the scratch block, several rows on the same scratch slot (duplicate
    indices: run under ``core.determinism.deterministic_torch`` on the
    card).  Returns ``(out, cache)``, ``cache`` being the updated leaves."""
    B, W, _ = x.shape
    bs = paged.block_size
    nblk = tables.shape[1]
    q, k_new, v_new = _qkv(p, cfg, x, schedule)
    abs_pos = start_pos[:, None].to(torch.int32) + torch.arange(
        W, dtype=torch.int32, device=x.device)[None, :]
    q = rope(q, abs_pos, cfg.rope_theta)
    k_new = rope(k_new, abs_pos, cfg.rope_theta)

    blk = torch.div(abs_pos, bs, rounding_mode="floor")
    off = (abs_pos - blk * bs).long()
    bid = torch.gather(tables.long(), 1, blk.clamp(0, nblk - 1).long())
    bid = torch.where((bid < 0) | (blk >= nblk), paged.scratch_bid, bid)
    cache["k"][bid, off] = k_new.to(cache["k"].dtype)
    cache["v"][bid, off] = v_new.to(cache["v"].dtype)
    cache["pos"][bid, off] = abs_pos

    if W == 1 and cfg.logit_softcap == 0:
        # single-token decode: the table-walking kernels (commit single pass
        # vs the split fast variant, picked by the schedule) read K/V in
        # place; they scale the unscaled roped q by hd^-0.5 themselves
        out = ops.paged_attention(
            q[:, 0], cache["k"], cache["v"], cache["pos"], tables,
            abs_pos[:, 0], schedule, null_bid=paged.null_bid,
        )
    else:
        q = q * (cfg.hd ** -0.5)
        flat = torch.where(tables < 0, paged.null_bid, tables).long()
        k_view = cache["k"][flat].reshape(B, nblk * bs, -1, cfg.hd)
        v_view = cache["v"][flat].reshape(B, nblk * bs, -1, cfg.hd)
        kp = cache["pos"][flat].reshape(B, 1, nblk * bs)
        qp = abs_pos[:, :, None]
        mask = (kp >= 0) & (kp <= qp)
        out = _softmax_attend(q, k_view, v_view, mask, schedule, cfg.logit_softcap)
    out = matmul(out.reshape(B, W, -1).to(x.dtype), p["wo"], schedule)
    return out, cache


def swiglu_ffn(p: Dict, x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    gate = matmul(x, p["wi_gate"], schedule)
    up = matmul(x, p["wi_up"], schedule)
    h = F.silu(gate.to(F32)).to(x.dtype) * up
    return matmul(h, p["wo"], schedule)
