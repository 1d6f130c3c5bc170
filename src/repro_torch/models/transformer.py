"""Incremental forward pass, dense subset (prefill / decode / verify).

PyTorch counterpart of ``repro.models.transformer``: ``cache_spec``, the
attention + dense-FFN branch of ``_apply_layer``, ``_embed``, ``_unembed``
and ``forward``, over the paged pool (``tables`` and ``paged`` given) or
over dense per-row cache views (neither given; the gathered lane).  The
JAX ``lax.scan`` over the stacked layer block is a Python loop over the
stacked leaves; cache leaves are updated in place.  Every entry point
takes an explicit reduction ``Schedule``: the schedule, not the code,
decides between fast-path and verifier-grade numerics.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.determinism import Schedule, VERIFY_SCHEDULE, matmul
from repro_torch.models.base import ModelConfig, dense_supported
from repro_torch.models.layers import (
    PagedView, attention_cached, attention_paged, rms_norm, swiglu_ffn,
)

F32 = torch.float32


def cache_spec(cfg: ModelConfig, batch: int, capacity: int) -> Dict[str, Any]:
    """``(shape, dtype)`` tree of the dense cache, the JAX tree's keys:
    ``blocks/0/{k,v}`` (layers, batch, capacity, KV, HD) and ``pos``
    (layers, batch, capacity) int32."""
    dense_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    kv = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.hd)
    return {"blocks": {"0": {
        "k": (kv, dtype),
        "v": (kv, dtype),
        "pos": ((cfg.num_layers, batch, capacity), torch.int32),
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
    """One decoder layer (attention + dense FFN); ``lc`` updated in place:
    through the block tables when ``paged`` is given, else as dense views."""
    h = rms_norm(x, lp["norm0"], cfg.norm_eps, schedule)
    if paged is not None:
        out, _ = attention_paged(lp["attn"], cfg, h, lc, tables, start_pos,
                                 schedule, paged)
    else:
        out, _ = attention_cached(lp["attn"], cfg, h, lc, start_pos, schedule)
    x = x + out
    h = rms_norm(x, lp["norm1"], cfg.norm_eps, schedule)
    return x + swiglu_ffn(lp["ffn"], h, schedule)


def _embed(params, cfg, tokens, inputs_embeds):
    if inputs_embeds is not None:
        return inputs_embeds
    return params["embed"][tokens.long()]


def _unembed(params, cfg, x, schedule):
    if cfg.tie_embeddings:
        return matmul(x, params["embed"].t().contiguous(), schedule)
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

    With ``tables`` and ``paged``, ``cache`` holds pool-shaped leaves
    (``blocks/0/{k,v,pos}`` with a leading layer axis, no batch axis) and
    attention reads and writes them in place through ``tables``.  With
    neither, ``cache`` holds dense per-row views ``(layers, B, C, ...)``,
    updated in place; every pass must end inside the view (no ring wrap),
    which the W == 1 length mask relies on.  Returns ``(logits (B, W, V)
    f32, cache, None)``, the JAX signature's ``(logits, new_cache,
    per_pos)``; this slice has no recurrent state, so ``per_pos`` is None."""
    if (paged is None) != (tables is None):
        raise ValueError("pass both tables and paged (paged pool) or neither "
                         "(gathered views)")
    x = _embed(params, cfg, tokens, inputs_embeds)
    blocks, pool = params["blocks"]["0"], cache["blocks"]["0"]
    if paged is None:
        C = pool["k"].shape[2]
        assert int(start_pos.max()) + x.shape[1] <= C, (
            f"a pass ending past the view capacity {C} would wrap")
    for i in range(cfg.num_layers):
        x = _apply_layer(cfg, _index(blocks, i), x, _index(pool, i), tables,
                         start_pos, schedule, paged)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, schedule)
    logits = _unembed(params, cfg, x, schedule).to(F32)
    return logits, cache, None
