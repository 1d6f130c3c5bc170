"""Incremental forward pass, attention families (prefill / decode / verify).

PyTorch counterpart of ``repro.models.transformer``: ``cache_spec``, the
attention branch of ``_apply_layer`` with its dense or MoE FFN,
``_embed``, ``_unembed`` and ``forward``.  Full-attention layers run over
the paged pool (``tables`` and ``paged`` given) or over dense per-row
cache views (neither given; the gathered lane); sliding-window layers keep
dense per-slot rings of ``min(capacity, window + RING_SLACK)`` slots and
are never paged.  The
JAX ``lax.scan`` over the stacked layer block is a Python loop over the
stacked leaves; cache leaves are updated in place.  Every entry point
takes an explicit reduction ``Schedule``: the schedule, not the code,
decides between fast-path and verifier-grade numerics.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.determinism import Schedule, VERIFY_SCHEDULE, matmul
from repro_torch.models.base import ModelConfig, check_ported
from repro_torch.models.layers import (
    PagedView, attention_cached, attention_paged, moe_ffn, rms_norm, swiglu_ffn,
)

F32 = torch.float32

#: ring slots beyond the window, so a pass of up to RING_SLACK + 1 tokens
#: (a verify window, a prefill chunk) never overwrites keys still inside a
#: query's window: the ring contract is capacity >= window + pass - 1
RING_SLACK = 128


def cache_spec(cfg: ModelConfig, batch: int, capacity: int) -> Dict[str, Any]:
    """``(shape, dtype)`` tree of the dense cache, the JAX tree's keys:
    ``blocks/0/{k,v}`` (layers, batch, cap, KV, HD) and ``pos`` (layers,
    batch, cap) int32, cap = ``capacity`` for full attention and
    ``min(capacity, window + RING_SLACK)`` for a sliding window's ring."""
    check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    cap = (min(capacity, cfg.window + RING_SLACK) if cfg.attn_kind == "sliding"
           else capacity)
    kv = (cfg.num_layers, batch, cap, cfg.num_kv_heads, cfg.hd)
    return {"blocks": {"0": {
        "k": (kv, dtype),
        "v": (kv, dtype),
        "pos": ((cfg.num_layers, batch, cap), torch.int32),
    }}}


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_layer(
    cfg: ModelConfig, lp: Dict, x: torch.Tensor, lc: Dict,
    tables: Optional[torch.Tensor], start_pos: torch.Tensor,
    schedule: Schedule, paged: Optional[PagedView],
) -> torch.Tensor:
    """One decoder layer (attention + dense or MoE FFN); ``lc`` updated in
    place: through the block tables when ``paged`` is given (full attention
    only: rings are never paged), else as dense views or rings."""
    window = cfg.window if cfg.attn_kind == "sliding" else 0
    h = rms_norm(x, lp["norm0"], cfg.norm_eps, schedule)
    if paged is not None and window == 0:
        out, _ = attention_paged(lp["attn"], cfg, h, lc, tables, start_pos,
                                 schedule, paged)
    else:
        out, _ = attention_cached(lp["attn"], cfg, h, lc, start_pos, schedule,
                                  window)
    x = x + out
    h = rms_norm(x, lp["norm1"], cfg.norm_eps, schedule)
    if "moe" in lp:
        out, _aux = moe_ffn(lp["moe"], cfg, h, schedule)
    else:
        out = swiglu_ffn(lp["ffn"], h, schedule)
    return x + out


def _embed(params, cfg, tokens, inputs_embeds):
    if inputs_embeds is not None:
        return inputs_embeds
    return params["embed"][tokens.long()]


def _unembed(params, cfg, x, schedule):
    # tied configs read the copy of embed.T made with the params
    # (models.base.tie_unembedding), never a per-pass transpose
    return matmul(x, params["unembed"], schedule)


def forward(
    params: Dict,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,  # (B, W) int
    *,
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, W, D) overrides tokens
    cache: Dict,
    start_pos: torch.Tensor,  # (B,) absolute position of tokens[:, 0]
    schedule: Schedule = VERIFY_SCHEDULE,
    tables: Optional[torch.Tensor] = None,  # (B, nblk) block tables
    paged: Optional[PagedView] = None,
) -> Tuple[torch.Tensor, Dict, None]:
    """Incremental forward.

    With ``tables`` and ``paged``, a full-attention ``cache`` holds
    pool-shaped leaves (``blocks/0/{k,v,pos}`` with a leading layer axis,
    no batch axis) and attention reads and writes them in place through
    ``tables``.  With neither, ``cache`` holds dense per-row views
    ``(layers, B, C, ...)``, updated in place; a full-attention pass must
    end inside the view (no wrap), which the W == 1 length mask relies on.
    A sliding config's ``cache`` holds per-row rings in either case, which
    wrap by design.  Returns ``(logits (B, W, V)
    f32, cache, None)``, the JAX signature's ``(logits, new_cache,
    per_pos)``; this slice has no recurrent state, so ``per_pos`` is None."""
    if (paged is None) != (tables is None):
        raise ValueError("pass both tables and paged (paged pool) or neither "
                         "(gathered views)")
    x = _embed(params, cfg, tokens, inputs_embeds)
    blocks, pool = params["blocks"]["0"], cache["blocks"]["0"]
    if paged is None and cfg.attn_kind != "sliding":
        C = pool["k"].shape[2]
        assert int(start_pos.max()) + x.shape[1] <= C, (
            f"a pass ending past the view capacity {C} would wrap")
    for i in range(cfg.num_layers):
        x = _apply_layer(cfg, _index(blocks, i), x, _index(pool, i), tables,
                         start_pos, schedule, paged)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, schedule)
    logits = _unembed(params, cfg, x, schedule).to(F32)
    return logits, cache, None
