"""RWKV-6 "Finch" layer: token-shift time mixing with data-dependent decay,
plus squared-ReLU channel mixing (arXiv:2404.05892).

PyTorch counterpart of ``repro.models.rwkv6``, with the reference's
simplifications: static token-shift interpolation weights (mu) for r/k/v/g,
the data-dependent decay w through its LoRA, and a per-head RMS
normalization of the wkv output in place of GroupNorm.

State layout (per layer, per request):
    tm_shift: (B, D)            last input to time mixing
    cm_shift: (B, D)            last input to channel mixing
    wkv:      (B, H, hd, hd)    recurrent outer-product state (f32)

Every projection goes through ``core.determinism.matmul`` (on the card the
hand-written GEMM pair).  The recurrence is a Python loop over the pass's
positions, the JAX ``lax.scan``.  Its two per-step reductions, the
``"bhk,bhkv->bhv"`` contraction and the per-head mean of the output
norm, are library reductions in the reference; on CUDA an ``einsum`` is a
batched cuBLAS GEMM whose kernel follows the batch, and BATCH_INVARIANT
decode runs this step at every B.  So a schedule without splits (the
commit schedule, which also selects the commit GEMM) sums both by fixed
halving trees (``core.determinism._pairwise_sum``), whose rows do not
follow B; a split schedule (the fast path) keeps the library reductions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.determinism import Schedule, _pairwise_sum, fixed_order, matmul
from repro_torch.kernels import recording

F32 = torch.float32


def init_state(cfg, batch: int, dtype: torch.dtype,
               device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Zero state of ``batch`` rows on ``device`` (default ``cuda``)."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    h = cfg.d_model // cfg.rwkv_head_dim
    return {
        "tm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev),
        "cm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev),
        "wkv": torch.zeros((batch, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                           dtype=F32, device=dev),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, W, D); prev: (B, D) -> shifted (B, W, D) (x at t-1)."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def time_mix(
    p: Dict,
    cfg,
    x: torch.Tensor,  # (B, W, D), already normed
    prev_shift: torch.Tensor,  # (B, D)
    wkv0: torch.Tensor,  # (B, H, hd, hd) f32
    schedule: Schedule,
    collect_states: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(out, new_shift, new_wkv, per_pos_wkv or None)``;
    ``per_pos_wkv`` (B, W, H, hd, hd) holds the state after each position.
    Neither input state is written."""
    B, W, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd

    xs = _token_shift(x, prev_shift)

    def mix(mu):
        return x + (xs - x) * mu

    r = matmul(mix(p["mu_r"]), p["wr"], schedule).reshape(B, W, H, hd)
    k = matmul(mix(p["mu_k"]), p["wk"], schedule).reshape(B, W, H, hd)
    v = matmul(mix(p["mu_v"]), p["wv"], schedule).reshape(B, W, H, hd)
    g = matmul(mix(p["mu_g"]), p["wg"], schedule)

    # data-dependent decay (the Finch contribution): w = exp(-exp(dd))
    dd = p["w_decay"].to(F32) + matmul(
        torch.tanh(matmul(mix(p["mu_w"]), p["w_lora_a"], schedule)),
        p["w_lora_b"], schedule,
    ).to(F32)
    w = torch.exp(-torch.exp(dd)).reshape(B, W, H, hd)  # in (0, 1), per channel

    u = p["u_bonus"].to(F32)[None, :, :, None]  # (1, H, hd, 1)
    fixed = fixed_order(schedule)
    r, k, v, w = (a.to(F32) for a in (r, k, v, w))
    s = wkv0  # (B, H, hd, hd) indexed [k_dim, v_dim]
    outs, states = [], []
    for t in recording.steps(W):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd, hd)
        a = s + u * kv
        if fixed:
            out = _pairwise_sum(r[:, t, :, :, None] * a, axis=-2)
        else:
            out = torch.einsum("bhk,bhkv->bhv", r[:, t], a)
        s = w[:, t, :, :, None] * s + kv
        outs.append(out)
        if collect_states:
            states.append(s)
    tm = torch.stack(outs, dim=1)  # (B, W, H, hd)
    sq = tm * tm
    ms = _pairwise_sum(sq, axis=-1) / hd if fixed else sq.mean(dim=-1)
    rms = torch.rsqrt(ms + 1e-6)[..., None]
    tm = (tm * rms).reshape(B, W, D) * p["ln_x_scale"]
    tm = tm * F.silu(g.to(F32))
    out = matmul(tm.to(x.dtype), p["wo"], schedule)

    per_pos = torch.stack(states, dim=1) if collect_states else None
    return out, x[:, -1], s, per_pos


def channel_mix(
    p: Dict,
    cfg,
    x: torch.Tensor,  # (B, W, D), already normed
    prev_shift: torch.Tensor,  # (B, D)
    schedule: Schedule,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out, new_shift)``."""
    xs = _token_shift(x, prev_shift)

    def mix(mu):
        return x + (xs - x) * mu

    k = matmul(mix(p["cm_mu_k"]), p["cm_wk"], schedule)
    k = torch.square(F.relu(k.to(F32))).to(x.dtype)
    out = torch.sigmoid(
        matmul(mix(p["cm_mu_r"]), p["cm_wr"], schedule).to(F32)
    ).to(x.dtype) * matmul(k, p["cm_wv"], schedule)
    return out, x[:, -1]
