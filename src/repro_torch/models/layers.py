"""Shared layers: RMSNorm, RoPE, GQA attention over the paged pool, over
gathered per-row views or over sliding-window rings, SwiGLU and MoE.

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
XLA, so the commit path is bitwise the same in both; passes longer than
``CHUNK_THRESHOLD`` rows attend q-chunked (``_chunked_attend``).
Training attends over the whole sequence (``attention_train``: plain tensor
code, as in the reference).
Sliding-window rings (``attention_cached`` with ``window > 0``) mask by
the stored positions; their single-token passes run plain tensor code too,
under one kv split by fixed halving trees (``_ring_decode_attend``).
``cross_attention`` (encoder-decoder decoders) attends over the encoder's keys
and values, which ``encode_cross_kv`` projects once per request: its
single-token passes go to ``ops.decode_attention`` too, its multi-token passes
to ``_softmax_attend`` under the encoder mask.  ``moe_ffn`` routes in the
schedule's GEMM and runs every expert in the commit GEMM.  Unlike the JAX code,
which returns new caches, the leaves are updated in place.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.determinism import (
    Schedule, _pairwise_sum, _split_sizes, matmul, segment_reduce_sum, torch_dtype,
)
from repro_torch.kernels import ops

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             schedule: Schedule) -> torch.Tensor:
    """RMSNorm with a schedule-dependent feature reduction (paper Fig. 4b)."""
    ss = segment_reduce_sum(x * x, axis=-1, schedule=schedule)
    inv = torch.rsqrt(ss / x.shape[-1] + eps)
    return (x.to(F32) * inv[..., None]).to(x.dtype) * scale


@functools.lru_cache(maxsize=None)
def q_scale(hd: int, dtype: torch.dtype) -> float:
    """The attention scale hd^-0.5 rounded to q's dtype.  The reference's
    ``q * (cfg.hd**-0.5)`` meets a weakly typed Python scalar, which JAX
    casts to q's dtype first; PyTorch would multiply by its f32 value
    instead, and at a bf16 q the products then round apart wherever
    hd^-0.5 is no power of two (hd 96, 112, 128)."""
    return torch.tensor(hd ** -0.5, dtype=dtype).item()


@functools.lru_cache(maxsize=None)
def _rope_rate(theta: float, half: int) -> float:
    """``log(theta) / half`` in f32 (the reference's ``jnp.log(theta) /
    half``), as a Python float: a constant of the forward, never a tensor
    copied to the device in every pass (which no captured program may do)."""
    return float(torch.log(torch.tensor(theta, dtype=F32)) / half)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply rotary embedding.  x: (..., T, H, D); positions: (..., T)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=F32, device=x.device)
                      * _rope_rate(theta, half))
    ang = positions[..., None].to(F32) * freqs  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half: 2 * half].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                     x[..., 2 * half:].to(F32)], dim=-1)
    return out.to(x.dtype)


def _qkv(p: Dict, cfg, x: torch.Tensor, schedule: Schedule):
    """Project to q, k, v heads (plus ``bq``, ``bk``, ``bv`` in x's dtype
    when ``cfg.use_bias``).  x: (B, T, D)."""
    B, T, _ = x.shape
    q = matmul(x, p["wq"], schedule)
    k = matmul(x, p["wk"], schedule)
    v = matmul(x, p["wv"], schedule)
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.num_heads, cfg.hd)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.hd)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.hd)
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


#: above this many query rows, attention runs q-chunked (``_chunked_attend``)
#: so the (B, T, S) score tensor is never materialized
CHUNK_THRESHOLD = 2048
Q_CHUNK = 512


def _chunked_attend(
    q: torch.Tensor,      # (B, T, H, D) f32, pre-scaled + roped
    k: torch.Tensor,      # (B, S, KV, D)
    v: torch.Tensor,      # (B, S, KV, D)
    q_pos: torch.Tensor,  # (B, T) absolute positions
    k_pos: torch.Tensor,  # (B, S) absolute positions (-1 = invalid)
    schedule: Schedule,
    logit_softcap: float,
    window: int,
) -> torch.Tensor:
    """Query-chunked attention: q is padded to a multiple of ``Q_CHUNK``
    (pad positions ``-(10**9)``, which no key precedes) and each chunk runs
    ``_softmax_attend`` in order under the ``pos`` mask (and the window term
    when ``window > 0``); per-chunk scores are (B, Q_CHUNK, S).  The JAX
    ``lax.map`` is a Python loop: every chunk has one shape, so the commit
    path does not follow the prompt's length."""
    B, T, H, D = q.shape
    pad = (-T) % Q_CHUNK
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-(10 ** 9))
    kp = k_pos[:, None, :]
    outs = []
    for c in range(q.shape[1] // Q_CHUNK):
        sl = slice(c * Q_CHUNK, (c + 1) * Q_CHUNK)
        qp = q_pos[:, sl, None]
        mask = (kp >= 0) & (kp <= qp)
        if window > 0:
            mask = mask & (kp > qp - window)
        outs.append(_softmax_attend(q[:, sl], k, v, mask, schedule, logit_softcap))
    return torch.cat(outs, dim=1)[:, :T]


def _ring_decode_attend(
    q: torch.Tensor,     # (B, 1, H, D) pre-scaled
    k: torch.Tensor,     # (B, S, KV, D)
    v: torch.Tensor,     # (B, S, KV, D)
    mask: torch.Tensor,  # (B, 1, S) bool
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """``_softmax_attend``'s one-split softmax for a single query row, with
    every sum a fixed halving tree of elementwise adds (``_pairwise_sum``
    over D for the scores, over S for the denominator and the weighted
    values).  On CUDA an ``einsum`` is a batched cuBLAS GEMM whose kernel
    follows the batch, so its rows change bits with B; these do not, which
    the commit path's W == 1 ring passes (BATCH_INVARIANT decode at every
    B) need."""
    B, _, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, D).to(F32)
    s = _pairwise_sum(qg * k.to(F32)[:, :, :, None, :], axis=-1)  # (B, S, KV, G)
    if logit_softcap > 0.0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    s = s.masked_fill(~mask.expand(B, 1, S)[:, 0, :, None, None], float("-inf"))
    m = s.amax(dim=1, keepdim=True).clamp_min(-1e30)  # a max is exact in any order
    e = torch.exp(s - m)
    den = _pairwise_sum(e, axis=1)  # (B, KV, G)
    o = _pairwise_sum(e[..., None] * v.to(F32)[:, :, :, None, :], axis=1)
    out = o / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, D)


def attention_cached(
    p: Dict,
    cfg,
    x: torch.Tensor,          # (B, W, D)
    cache: Dict,              # {"k","v": (B, C, KV, HD), "pos": (B, C)}
    start_pos: torch.Tensor,  # (B,) absolute position of x[:, 0]
    schedule: Schedule,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict]:
    """Incremental attention over dense per-row views: full-attention views
    (``window == 0``) or sliding-window rings (``window > 0``).

    Writes the W new tokens at slots ``abs_pos % C`` in place, then attends.
    The ring contract: a pass must not overwrite keys still inside any
    query's window, so ``W + window - 1 <= C`` (asserted; the engine chunks
    longer prefills).  Masks use the stored absolute ``pos`` (plus
    ``kp > qp - window`` on a ring), so wraparound needs no special case.

    Full-attention W == 1 (decode) goes to ``ops.decode_attention`` with the
    unscaled roped q and ``lengths = start_pos + 1``: that mask equals the
    ``pos`` mask because slot s holds position s (no wrap: ``forward``
    asserts that every pass ends inside the view).  A ring breaks that, so
    its W == 1 pass runs the ``pos`` mask in plain tensor code: under one
    kv split ``_ring_decode_attend``, whose rows do not follow B, else
    ``_softmax_attend``.  W > 1 scales q in the activation dtype and runs
    ``_softmax_attend`` under the ``pos`` mask, exactly as the paged lane
    does, q-chunked (``_chunked_attend``) above ``CHUNK_THRESHOLD`` rows."""
    B, W, _ = x.shape
    C = cache["k"].shape[1]
    need = W + (window - 1 if window > 0 else 0)
    assert need <= C, (
        f"pass of {W} tokens (+window {window}) exceeds cache capacity {C}; "
        f"chunk it")
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

    if W == 1 and window == 0 and cfg.logit_softcap == 0:
        # single-token decode: the dense-cache kernel, which scales q by
        # hd^-0.5 in f32 itself and masks by length
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                   abs_pos[:, 0] + 1, schedule)
    else:
        q = q * q_scale(cfg.hd, q.dtype)
        if W > CHUNK_THRESHOLD:
            out = _chunked_attend(q.to(F32), cache["k"], cache["v"], abs_pos,
                                  cache["pos"], schedule, cfg.logit_softcap, window)
        else:
            kp = cache["pos"][:, None, :]
            qp = abs_pos[:, :, None]
            mask = (kp >= 0) & (kp <= qp)
            if window > 0:
                mask = mask & (kp > qp - window)
            splits = schedule.kv_splits
            if W == 1 and (splits <= 1 or splits > C):
                out = _ring_decode_attend(q, cache["k"], cache["v"], mask,
                                          cfg.logit_softcap)
            else:
                out = _softmax_attend(q, cache["k"], cache["v"], mask, schedule,
                                      cfg.logit_softcap)
    out = matmul(out.reshape(B, W, -1).to(x.dtype), p["wo"], schedule)
    return out, cache


def attention_train(p: Dict, cfg, x: torch.Tensor, schedule: Schedule,
                    window: int = 0) -> torch.Tensor:
    """Full-sequence causal attention (training, no cache).  x: (B, S, D).

    Plain tensor code, as in the reference (``repro.models.layers.
    attention_train``), whose XLA attention runs no kernel: rope at
    positions 0..S-1, q scaled in the activation dtype, one
    ``_softmax_attend`` under the causal mask (and the window term when
    ``window > 0``), q-chunked (``_chunked_attend``) above
    ``CHUNK_THRESHOLD`` rows, then ``wo``."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, schedule)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    q = q * q_scale(cfg.hd, q.dtype)
    if S > CHUNK_THRESHOLD:
        out = _chunked_attend(q.to(F32), k, v, pos, pos, schedule,
                              cfg.logit_softcap, window)
    else:
        qp, kp = pos[0, :, None], pos[0, None, :]
        mask = kp <= qp
        if window > 0:
            mask = mask & (kp > qp - window)
        out = _softmax_attend(q, k, v, mask[None], schedule, cfg.logit_softcap)
    return matmul(out.reshape(B, S, -1).to(x.dtype), p["wo"], schedule)


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
        q = q * q_scale(cfg.hd, q.dtype)
        flat = torch.where(tables < 0, paged.null_bid, tables).long()
        k_view = cache["k"][flat].reshape(B, nblk * bs, -1, cfg.hd)
        v_view = cache["v"][flat].reshape(B, nblk * bs, -1, cfg.hd)
        kp = cache["pos"][flat].reshape(B, 1, nblk * bs)
        qp = abs_pos[:, :, None]
        mask = (kp >= 0) & (kp <= qp)
        out = _softmax_attend(q, k_view, v_view, mask, schedule, cfg.logit_softcap)
    out = matmul(out.reshape(B, W, -1).to(x.dtype), p["wo"], schedule)
    return out, cache


def cross_attention(
    p: Dict,
    cfg,
    x: torch.Tensor,         # (B, W, D) decoder states
    enc_k: torch.Tensor,     # (B, Se, KV, HD) the encoder's keys
    enc_v: torch.Tensor,     # (B, Se, KV, HD)
    enc_mask: torch.Tensor,  # (B, Se) bool
    schedule: Schedule,
) -> torch.Tensor:
    """Decoder-to-encoder attention (no positions, no rope).

    q is scaled by hd^-0.5 in the activation dtype (``q_scale``), as in the
    reference.
    W == 1 (decode, BATCH_INVARIANT's at every B) goes to
    ``ops.decode_attention`` with that q, ``scale=1.0`` and ``lengths =
    enc_mask.sum(-1)``: under the commit schedule one kv split, whose rows
    do not follow B on the card, where ``_softmax_attend``'s ``einsum`` rows
    do.  The length mask equals ``enc_mask`` because an encoder mask is a
    prefix of valid frames (``models.transformer.build_cross_cache`` marks
    all of them).  W > 1 (verify windows, prefill chunks) runs
    ``_softmax_attend`` under ``enc_mask``, as the reference does."""
    B, W, _ = x.shape
    q = matmul(x, p["wq"], schedule).reshape(B, W, cfg.num_heads, cfg.hd)
    q = q * q_scale(cfg.hd, q.dtype)
    if W == 1:
        out = ops.decode_attention(q[:, 0], enc_k, enc_v, enc_mask.sum(-1), schedule,
                                   scale=1.0)
    else:
        out = _softmax_attend(q.to(F32), enc_k, enc_v, enc_mask[:, None, :], schedule)
    return matmul(out.reshape(B, W, -1).to(x.dtype), p["wo"], schedule)


def encode_cross_kv(p: Dict, cfg, enc_out: torch.Tensor, schedule: Schedule):
    """Cross-attention K/V of one decoder layer from the encoder output
    (once per request): ``(B, Se, KV, HD)`` each."""
    B, Se, _ = enc_out.shape
    k = matmul(enc_out, p["wk"], schedule).reshape(B, Se, cfg.num_kv_heads, cfg.hd)
    v = matmul(enc_out, p["wv"], schedule).reshape(B, Se, cfg.num_kv_heads, cfg.hd)
    return k, v


def swiglu_ffn(p: Dict, x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    gate = matmul(x, p["wi_gate"], schedule)
    up = matmul(x, p["wi_up"], schedule)
    h = F.silu(gate.to(F32)).to(x.dtype) * up
    return matmul(h, p["wo"], schedule)


#: the expert contractions' schedule: one f32 pass over K, the commit GEMM
#: with one chunk under every pass schedule (the reference's expert einsums
#: do not follow the schedule either)
EXPERT_SCHEDULE = Schedule()


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, the lower
    index first among equal values (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: Dict, cfg, x: torch.Tensor, schedule: Schedule,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor, Dict]:
    """Top-k MoE with sort-based dispatch and static expert capacity, the
    reference's integer arithmetic step for step.

    The router runs in the schedule's GEMM, so its argmax can flip under
    another reduction tree (where the paper expects O1 token flips).
    Capacity C is T under ``moe_no_drop`` (the commit schedule), else
    ``ceil(T*K*capacity_factor/E)`` rounded up to a multiple of 8 above 8;
    routed slots past C go to the overflow bucket ``E*C`` and read zeros
    back.  Every expert runs on its C-row bucket, f32 in and out, through
    the commit GEMM with one chunk (``EXPERT_SCHEDULE``), one expert's
    matrices cast to f32 at a time: 3E launches a layer a pass, whatever
    the routing.  The top-k outputs sum left to right.  Returns ``(y,
    aux)``, aux holding ``router_load``, ``aux_loss`` and
    ``dropped_frac``."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    dev = x.device

    logits = matmul(xt, p["router"], schedule).to(F32)  # (T, E)
    gates, idx = _top_k(logits, K)
    gates = torch.softmax(gates, dim=-1)

    if schedule.moe_no_drop:
        C = T  # every token routed to one expert still fits: never drop
    else:
        C = max(int(T * K * capacity_factor / E + 0.999), 1)
        if C > 8:
            C = (C + 7) // 8 * 8

    flat_e = idx.reshape(-1)  # (T*K,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # bucket starts as exact counts #{assignments < e}: a fixed-structure
    # reduction, as in the reference (not a binary search over T*K)
    experts = torch.arange(E, device=dev)
    starts = (sorted_e[None, :] < experts[:, None]).to(torch.int64).sum(dim=1)
    pos_in_e = torch.arange(T * K, device=dev) - starts[sorted_e]
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e, E * C)  # overflow bucket

    xin = xt[order // K]  # the token each routed slot came from
    buckets = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=dev)
    buckets[dest] = torch.where(keep[:, None], xin, torch.zeros_like(xin))
    buckets = buckets[: E * C].reshape(E, C, d)

    yb = torch.empty((E * C + 1, d), dtype=xt.dtype, device=dev)
    yb[E * C] = 0  # dropped slots read this row
    for e in range(E):
        be = buckets[e].to(F32)
        gate_h = matmul(be, p["wi_gate"][e].to(F32), EXPERT_SCHEDULE)
        up_h = matmul(be, p["wi_up"][e].to(F32), EXPERT_SCHEDULE)
        h = F.silu(gate_h) * up_h
        yb[e * C:(e + 1) * C] = matmul(h, p["wo"][e].to(F32), EXPERT_SCHEDULE).to(xt.dtype)

    y_routed = yb[dest]  # (T*K, d)
    inv = torch.sort(order, stable=True).indices
    y_per_k = y_routed[inv].reshape(T, K, d)
    acc = y_per_k[:, 0].to(F32) * gates[:, 0, None]
    for j in range(1, K):
        acc = acc + y_per_k[:, j].to(F32) * gates[:, j, None]
    y = acc.to(xt.dtype)

    counts = (flat_e[None, :] == experts[:, None]).to(torch.int64).sum(dim=1)
    load = counts.to(F32) / (T * K)
    importance = torch.softmax(logits, dim=-1).mean(dim=0)
    aux = {
        "router_load": load,
        "aux_loss": E * (load * importance).sum(),
        "dropped_frac": 1.0 - keep.to(F32).mean(),
    }
    return y.reshape(orig_shape), aux
