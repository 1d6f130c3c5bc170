"""Incremental forward pass for the attention, rwkv, hybrid and
encoder-decoder families (prefill / decode / verify), and the encoder.

PyTorch counterpart of ``repro.models.transformer``: ``cache_spec``,
``_apply_layer`` (attention with its dense or MoE FFN, an encoder-decoder
layer's cross-attention between them, or rwkv's time and channel mixing),
``_embed``, ``_unembed``, ``forward`` with ``collect_states`` and
``inputs_embeds`` (prefix embeddings), ``forward_train`` (the full causal
pass that training differentiates), ``encode`` and ``build_cross_cache``.  Full-attention layers run over the paged pool
(``tables`` and ``paged`` given) or over dense per-row cache views
(neither given; the gathered lane); sliding-window layers keep dense
per-slot rings of ``min(capacity, window + RING_SLACK)`` slots and are
never paged; rwkv layers keep their O(1) state per row.  The ``first_k_dense``
head layers run first, one by one, then the JAX ``lax.scan`` over the
stacked layer block is a Python loop over the stacked leaves; cache leaves
are updated in place.  Every entry point takes an explicit reduction
``Schedule``: the schedule, not the code, decides between fast-path and
verifier-grade numerics.  A hybrid config's (jamba) layers come in blocks
of ``models.base.stack_period`` layers, each block position stacked under
its own ``blocks/{p}`` key in the params, the cache and the per-position
trees; attention layers are paged or gathered as above, mamba layers keep
``conv`` and ``ssm`` state per row (``models.mamba``); ``forward_train``
walks the block positions in layer order, a mamba layer from the zero
state.

Cache and per-position trees lead with a layer axis everywhere: the JAX
tree's ``head_layers/{i}`` leaves, unstacked there (slot axis 0), and the
cross cache's ``mask`` (``(batch, Se)`` there) carry a layer axis of one
here, so every leaf's row axis is axis 1, which
``serving.blockpool.Layout`` and ``serving.statepool`` rely on.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.determinism import Schedule, VERIFY_SCHEDULE, matmul
from repro_torch.models import mamba, rwkv6
from repro_torch.models.base import ModelConfig, check_ported, padded_vocab, stack_period
from repro_torch.models.layers import (
    PagedView, _qkv, _softmax_attend, attention_cached, attention_paged,
    attention_train, cross_attention, encode_cross_kv, moe_ffn, q_scale, rms_norm,
    rope, swiglu_ffn,
)

F32 = torch.float32

#: ring slots beyond the window, so a pass of up to RING_SLACK + 1 tokens
#: (a verify window, a prefill chunk) never overwrites keys still inside a
#: query's window: the ring contract is capacity >= window + pass - 1
RING_SLACK = 128


def _layer_cache_shape(cfg: ModelConfig, kind: str, n: int, batch: int,
                       capacity: int) -> Dict[str, Any]:
    """``(shape, dtype)`` leaves of ``n`` stacked layers of ``kind``."""
    dtype = getattr(torch, cfg.dtype)
    if kind == "rwkv":
        h = cfg.d_model // cfg.rwkv_head_dim
        return {
            "tm_shift": ((n, batch, cfg.d_model), dtype),
            "cm_shift": ((n, batch, cfg.d_model), dtype),
            "wkv": ((n, batch, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim), F32),
        }
    if kind == "mamba":
        return {
            "conv": ((n, batch, cfg.d_conv - 1, cfg.d_inner), dtype),
            "ssm": ((n, batch, cfg.d_inner, cfg.d_state), F32),
        }
    cap = (min(capacity, cfg.window + RING_SLACK) if cfg.attn_kind == "sliding"
           else capacity)
    kv = (n, batch, cap, cfg.num_kv_heads, cfg.hd)
    return {"k": (kv, dtype), "v": (kv, dtype), "pos": ((n, batch, cap), torch.int32)}


def cache_spec(cfg: ModelConfig, batch: int, capacity: int) -> Dict[str, Any]:
    """``(shape, dtype)`` tree of the dense cache, the JAX tree's keys.
    Attention layers: ``{k,v}`` (layers, batch, cap, KV, HD) and ``pos``
    (layers, batch, cap) int32, cap = ``capacity`` for full attention and
    ``min(capacity, window + RING_SLACK)`` for a sliding window's ring.
    rwkv layers: ``tm_shift`` and ``cm_shift`` (layers, batch, d_model),
    ``wkv`` (layers, batch, H, hd, hd) f32.  mamba layers: ``conv``
    (layers, batch, d_conv - 1, d_inner) and ``ssm`` (layers, batch,
    d_inner, d_state) f32.  ``blocks/{p}`` stacks the layers at block
    position p; ``head_layers/{i}`` holds head layer i with a layer axis of
    one.  An encoder-decoder config adds ``cross``: the decoder layers'
    cross-attention ``{k,v}`` (layers, batch, Se, KV, HD) and the encoder
    ``mask`` (1, batch, Se) bool, Se = ``encoder_seq_len``."""
    check_ported(cfg)
    fkd = cfg.first_k_dense
    spec: Dict[str, Any] = {}
    if fkd:
        spec["head_layers"] = {
            str(i): _layer_cache_shape(cfg, cfg.layer_kind(i), 1, batch, capacity)
            for i in range(fkd)}
    period = stack_period(cfg)
    spec["blocks"] = {str(p): _layer_cache_shape(
        cfg, cfg.layer_kind(fkd + p), (cfg.num_layers - fkd) // period, batch,
        capacity) for p in range(period)}
    if cfg.family == "encdec":
        se, dtype = cfg.encoder_seq_len, getattr(torch, cfg.dtype)
        kv = (cfg.num_layers, batch, se, cfg.num_kv_heads, cfg.hd)
        spec["cross"] = {"k": (kv, dtype), "v": (kv, dtype),
                         "mask": ((1, batch, se), torch.bool)}
    return spec


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack_states(per_layer: List[Optional[Dict[str, torch.Tensor]]]) -> Any:
    """Per-layer per-position states stacked along a leading layer axis;
    None (an attention layer's placeholder) when the layers hold none."""
    if per_layer[0] is None:
        return None
    return {k: torch.stack([pp[k] for pp in per_layer]) for k in per_layer[0]}


def _apply_layer(
    cfg: ModelConfig, i: int, lp: Dict, x: torch.Tensor, lc: Dict,
    tables: Optional[torch.Tensor], start_pos: torch.Tensor,
    schedule: Schedule, paged: Optional[PagedView], collect_states: bool = False,
    cross_kv: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Decoder layer ``i``; returns ``(x, per_pos)``.  ``lc`` is updated in
    place: through the block tables when ``paged`` is given (full attention
    only: rings are never paged), else as dense views or rings; an rwkv
    layer's state rows take the state after the pass's last position.
    ``cross_kv`` (an encoder-decoder layer: ``{k, v}`` (B, Se, KV, HD) and
    ``mask`` (B, Se)) adds cross-attention after self-attention, under
    ``norm1``; the FFN's norm moves to ``norm2``.
    ``per_pos`` (rwkv or mamba with ``collect_states``) holds the state
    after each position, ``{tm_shift, cm_shift: (B, W, D), wkv: (B, W, H,
    hd, hd)}`` or ``{conv: (B, W, d_conv - 1, d_inner), ssm: (B, W,
    d_inner, d_state)}``; None for an attention layer."""
    if cfg.layer_kind(i) == "rwkv":
        h_tm = rms_norm(x, lp["norm0"], cfg.norm_eps, schedule)
        tm_out, tm_shift, wkv, pp_wkv = rwkv6.time_mix(
            lp["rwkv"], cfg, h_tm, lc["tm_shift"], lc["wkv"], schedule, collect_states)
        x = x + tm_out
        h_cm = rms_norm(x, lp["norm1"], cfg.norm_eps, schedule)
        cm_out, cm_shift = rwkv6.channel_mix(lp["rwkv"], cfg, h_cm, lc["cm_shift"],
                                             schedule)
        x = x + cm_out
        lc["tm_shift"].copy_(tm_shift)
        lc["cm_shift"].copy_(cm_shift)
        lc["wkv"].copy_(wkv)
        per_pos = ({"tm_shift": h_tm, "cm_shift": h_cm, "wkv": pp_wkv}
                   if collect_states else None)
        return x, per_pos

    window = cfg.window if cfg.attn_kind == "sliding" else 0
    h = rms_norm(x, lp["norm0"], cfg.norm_eps, schedule)
    per_pos = None
    if cfg.layer_kind(i) == "mamba":
        out, st, per_pos = mamba.mamba_layer(lp["mamba"], cfg, h, lc, schedule,
                                             collect_states)
        lc["conv"].copy_(st["conv"])
        lc["ssm"].copy_(st["ssm"])
    elif paged is not None and window == 0:
        out, _ = attention_paged(lp["attn"], cfg, h, lc, tables, start_pos,
                                 schedule, paged)
    else:
        out, _ = attention_cached(lp["attn"], cfg, h, lc, start_pos, schedule,
                                  window)
    x = x + out
    norm_idx = 1
    if cross_kv is not None:
        h = rms_norm(x, lp["norm1"], cfg.norm_eps, schedule)
        x = x + cross_attention(lp["cross_attn"], cfg, h, cross_kv["k"], cross_kv["v"],
                                cross_kv["mask"], schedule)
        norm_idx = 2
    h = rms_norm(x, lp[f"norm{norm_idx}"], cfg.norm_eps, schedule)
    if "moe" in lp:
        out, _aux = moe_ffn(lp["moe"], cfg, h, schedule)
    else:
        out = swiglu_ffn(lp["ffn"], h, schedule)
    return x + out, per_pos


def _embed(params, cfg, tokens, inputs_embeds):
    if inputs_embeds is not None:
        return inputs_embeds
    return params["embed"][tokens.long()]


def _unembed(params, cfg, x, schedule):
    # tied configs read the copy of embed.T made with the params, never a
    # per-pass transpose; a padded unembedding's zero columns are cut off
    # here, before anything samples, argmaxes or ranks the logits
    # (models.base.finish_unembedding)
    logits = matmul(x, params["unembed"], schedule)
    if logits.shape[-1] != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


def forward(
    params: Dict,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,  # (B, W) int
    *,
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, W, D) overrides tokens
    cache: Dict,
    start_pos: torch.Tensor,  # (B,) absolute position of tokens[:, 0]
    schedule: Schedule = VERIFY_SCHEDULE,
    collect_states: bool = False,
    tables: Optional[torch.Tensor] = None,  # (B, nblk) block tables
    paged: Optional[PagedView] = None,
) -> Tuple[torch.Tensor, Dict, Any]:
    """Incremental forward.

    With ``tables`` and ``paged``, a full-attention ``cache`` holds
    pool-shaped leaves (a leading layer axis, no batch axis) and attention
    reads and writes them in place through ``tables``.  With neither,
    ``cache`` holds dense per-row views ``(layers, B, C, ...)``, updated in
    place; a full-attention pass must end inside the view (no wrap), which the
    W == 1 length mask relies on: the caller checks that on the host, where
    the start positions are Python ints (``serving.kv_cache.check_view``),
    since a captured program cannot read a device value.  A sliding
    config's ``cache`` holds per-row rings in either case, which wrap by
    design, and an rwkv config's per-row state.  An encoder-decoder
    config's ``cache`` also holds ``cross`` (``cache_spec``;
    ``build_cross_cache`` makes it), read, never written.
    ``inputs_embeds`` (B, W, D) replaces the token embeddings (prefix
    embeddings, prefill chunks).  Returns ``(logits (B, W, V) f32, cache,
    per_pos)``, the JAX signature's ``(logits, new_cache, per_pos)``: with
    ``collect_states``, ``per_pos`` mirrors the cache tree, each rwkv or
    mamba leaf with a window axis after the row axis (the state after each
    position: ``blocks/{p}`` (L, B, W, ...), ``head_layers/{i}`` (1, B, W,
    ...)) and None in place of an attention layer's leaves; else None."""
    if (paged is None) != (tables is None):
        raise ValueError("pass both tables and paged (paged pool) or neither "
                         "(gathered views)")
    x = _embed(params, cfg, tokens, inputs_embeds)
    fkd = cfg.first_k_dense
    period = stack_period(cfg)
    heads = cache.get("head_layers", {})
    per_head = {}
    for i in range(fkd):
        x, pp = _apply_layer(cfg, i, params["head_layers"][str(i)], x,
                             _index(heads[str(i)], 0), tables, start_pos, schedule,
                             paged, collect_states)
        per_head[str(i)] = _stack_states([pp])
    cross = cache.get("cross") if cfg.family == "encdec" else None  # period 1
    pps: Dict[str, list] = {str(p): [] for p in range(period)}
    for b in range((cfg.num_layers - fkd) // period):
        cross_kv = (None if cross is None else
                    {"k": cross["k"][b], "v": cross["v"][b], "mask": cross["mask"][0]})
        for p in range(period):
            key = str(p)
            x, pp = _apply_layer(cfg, fkd + b * period + p,
                                 _index(params["blocks"][key], b), x,
                                 _index(cache["blocks"][key], b), tables, start_pos,
                                 schedule, paged, collect_states, cross_kv)
            pps[key].append(pp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, schedule)
    logits = _unembed(params, cfg, x, schedule).to(F32)
    per_pos = None
    if collect_states:
        per_pos = {"blocks": {k: _stack_states(v) for k, v in pps.items()}}
        if fkd:
            per_pos["head_layers"] = per_head
    return logits, cache, per_pos


_NO_AUX = ("aux_loss", "dropped_frac")


def _train_layer(cfg: ModelConfig, i: int, lp: Dict, x: torch.Tensor,
                 cross_kv: Optional[Dict[str, torch.Tensor]],
                 schedule: Schedule) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoder layer ``i`` over the whole sequence without a cache (the
    reference's ``_apply_layer`` with ``lc=None``); returns ``(x, aux)``,
    aux holding the MoE layer's ``aux_loss`` and ``dropped_frac`` (zeros
    for a dense FFN).  An rwkv or mamba layer starts from the zero state."""
    zero = torch.zeros((), dtype=F32, device=x.device)
    aux = dict.fromkeys(_NO_AUX, zero)
    if cfg.layer_kind(i) == "rwkv":
        st = rwkv6.init_state(cfg, x.shape[0], x.dtype, x.device)
        h = rms_norm(x, lp["norm0"], cfg.norm_eps, schedule)
        x = x + rwkv6.time_mix(lp["rwkv"], cfg, h, st["tm_shift"], st["wkv"],
                               schedule, False)[0]
        h = rms_norm(x, lp["norm1"], cfg.norm_eps, schedule)
        return x + rwkv6.channel_mix(lp["rwkv"], cfg, h, st["cm_shift"], schedule)[0], aux
    window = cfg.window if cfg.attn_kind == "sliding" else 0
    h = rms_norm(x, lp["norm0"], cfg.norm_eps, schedule)
    if cfg.layer_kind(i) == "mamba":
        x = x + mamba.mamba_layer(lp["mamba"], cfg, h, None, schedule)[0]
    else:
        x = x + attention_train(lp["attn"], cfg, h, schedule, window)
    norm_idx = 1
    if cross_kv is not None:
        h = rms_norm(x, lp["norm1"], cfg.norm_eps, schedule)
        x = x + cross_attention(lp["cross_attn"], cfg, h, cross_kv["k"], cross_kv["v"],
                                cross_kv["mask"], schedule)
        norm_idx = 2
    h = rms_norm(x, lp[f"norm{norm_idx}"], cfg.norm_eps, schedule)
    if "moe" in lp:
        out, moe_aux = moe_ffn(lp["moe"], cfg, h, schedule)
        aux = {k: moe_aux[k] for k in _NO_AUX}
    else:
        out = swiglu_ffn(lp["ffn"], h, schedule)
    return x + out, aux


def _train_block(cfg: ModelConfig, first: int, period: int, bp: Dict[str, Dict],
                 x: torch.Tensor, cross_kv: Optional[Dict[str, torch.Tensor]],
                 schedule: Schedule) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One block of ``period`` layers from layer ``first`` (the reference's
    ``block_body``): ``(x, aux)``, aux the layers' terms summed from zero
    in layer order."""
    aux = dict.fromkeys(_NO_AUX, torch.zeros((), dtype=F32, device=x.device))
    for p in range(period):
        x, a = _train_layer(cfg, first + p, bp[str(p)], x, cross_kv, schedule)
        aux = {k: aux[k] + a[k] for k in _NO_AUX}
    return x, aux


def _train_unembed(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   schedule: Schedule) -> torch.Tensor:
    """The unembedding of a training tree: a tied config reads ``embed.T``
    (so its gradient reaches ``embed``), padded to ``padded_vocab`` zero
    columns where the tree's ``unembed`` is not, and the logits are cut
    back to ``vocab_size``."""
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    pad = padded_vocab(cfg) - w.shape[1]
    if pad > 0:
        w = torch.nn.functional.pad(w, (0, pad))
    return matmul(x, w.contiguous(), schedule)[..., : cfg.vocab_size]


def forward_train(
    params: Dict,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor],  # (B, S) int
    *,
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, S, D) overrides tokens
    schedule: Schedule = VERIFY_SCHEDULE,
    enc_embeds: Optional[torch.Tensor] = None,  # (B, Se, D) for encdec
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full causal forward for training: ``(logits (B, S, V) f32, aux)``,
    the reference's ``forward_train``.  The ``first_k_dense`` head layers
    run first, then the blocks: block b runs its ``period`` positions
    ``blocks/0 .. blocks/{period-1}`` in layer order (a hybrid config's
    attention and mamba layers, the latter from the zero state), as the
    reference's ``block_body`` does.  ``aux`` sums every MoE layer's
    ``aux_loss`` and ``dropped_frac``: each block's layers from zero in
    order, then the blocks' sums as one ``torch.sum`` added to the head
    layers', as the reference sums its scan's stacked outputs.  An
    encoder-decoder config runs ``encode`` and every layer's
    ``encode_cross_kv`` first, under an all-true cross mask; its sequence
    must be longer than one token (a single-token cross pass runs the
    forward-only ``decode_attention`` kernel).  ``remat`` recomputes each
    block in the backward pass (``torch.utils.checkpoint``, not
    reentrant), as ``jax.checkpoint`` of the block body does; the forward
    draws no random numbers, so the checkpoint keeps no generator state
    (reading the CUDA generator's state is what a graph capture refuses).  The
    reference's ``unroll`` has no meaning for a Python loop and is dropped.
    ``params`` is the JAX tree (``training.train.train_params``) or a
    serving tree with the derived ``unembed``."""
    x = _embed(params, cfg, tokens, inputs_embeds)
    fkd = cfg.first_k_dense
    cross_kv = None
    if cfg.family == "encdec":
        assert enc_embeds is not None, "an encoder-decoder config needs enc_embeds"
        assert x.shape[1] > 1, "forward_train's cross-attention needs S > 1"
        enc_out = encode(params, cfg, enc_embeds, schedule)
        cross_mask = torch.ones(enc_out.shape[:2], dtype=torch.bool, device=x.device)
    aux_acc = dict.fromkeys(_NO_AUX, torch.zeros((), dtype=F32, device=x.device))
    for i in range(fkd):
        x, aux = _train_layer(cfg, i, params["head_layers"][str(i)], x, None, schedule)
        aux_acc = {k: aux_acc[k] + aux[k] for k in _NO_AUX}
    period = stack_period(cfg)
    auxs = []
    for b in range((cfg.num_layers - fkd) // period):
        bp = {str(p): _index(params["blocks"][str(p)], b) for p in range(period)}
        if cfg.family == "encdec":  # period 1
            k, v = encode_cross_kv(bp["0"]["cross_attn"], cfg, enc_out, schedule)
            cross_kv = {"k": k, "v": v, "mask": cross_mask}
        block = functools.partial(_train_block, cfg, fkd + b * period, period)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                block, bp, x, cross_kv, schedule, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = block(bp, x, cross_kv, schedule)
        auxs.append(aux)
    if auxs:
        aux_acc = {k: aux_acc[k] + torch.stack([a[k] for a in auxs]).sum()
                   for k in _NO_AUX}
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, schedule)
    return _train_unembed(params, cfg, x, schedule).to(F32), aux_acc


def encode(params: Dict, cfg: ModelConfig, enc_embeds: torch.Tensor,
           schedule: Schedule = VERIFY_SCHEDULE) -> torch.Tensor:
    """The bidirectional encoder stack over ``enc_embeds`` (B, Se, D), the
    stubbed frontend's output: rope over the encoder positions, every key
    visible (``_softmax_attend``), a dense SwiGLU FFN, then
    ``enc_final_norm``.  Returns (B, Se, D)."""
    x = enc_embeds
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    mask = torch.ones((B, S, S), dtype=torch.bool, device=x.device)
    enc = params["enc_blocks"]["0"]
    for i in range(cfg.num_encoder_layers):
        lp = _index(enc, i)
        a = rms_norm(x, lp["norm0"], cfg.norm_eps, schedule)
        q, k, v = _qkv(lp["attn"], cfg, a, schedule)
        q = rope(q, pos, cfg.rope_theta)
        q = q * q_scale(cfg.hd, q.dtype)
        k = rope(k, pos, cfg.rope_theta)
        out = _softmax_attend(q.to(F32), k, v, mask, schedule)
        x = x + matmul(out.reshape(B, S, -1).to(x.dtype), lp["attn"]["wo"], schedule)
        a = rms_norm(x, lp["norm1"], cfg.norm_eps, schedule)
        x = x + swiglu_ffn(lp["ffn"], a, schedule)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps, schedule)


# det: commit-path
def build_cross_cache(params: Dict, cfg: ModelConfig, enc_embeds: torch.Tensor,
                      enc_mask: Optional[torch.Tensor] = None,
                      schedule: Schedule = VERIFY_SCHEDULE) -> Dict[str, torch.Tensor]:
    """The encoder pass and every decoder layer's cross K/V (the serving
    admission path): ``{k, v}`` (layers, B, Se, KV, HD) and ``mask`` (1, B,
    Se), the layout of ``cache_spec``'s ``cross`` (the JAX tree's mask has
    no layer axis).  ``enc_mask`` (B, Se) defaults to every frame valid; it
    must mark a prefix of the frames (single-token cross-attention masks by
    length)."""
    enc_out = encode(params, cfg, enc_embeds, schedule)
    blocks = params["blocks"]["0"]["cross_attn"]
    ks, vs = zip(*(encode_cross_kv(_index(blocks, i), cfg, enc_out, schedule)
                   for i in range(cfg.num_layers)))
    if enc_mask is None:
        enc_mask = torch.ones(enc_embeds.shape[:2], dtype=torch.bool,
                              device=enc_embeds.device)
    return {"k": torch.stack(ks), "v": torch.stack(vs), "mask": enc_mask[None]}
