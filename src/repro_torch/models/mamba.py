"""Mamba-1 selective state-space layer (for the Jamba hybrid).

PyTorch counterpart of ``repro.models.mamba``.

State layout (per layer, per request):
    conv: (B, d_conv - 1, d_inner)  trailing inputs for the causal conv
    ssm:  (B, d_inner, d_state)     the recurrent SSM state (f32)

A recurrent state cannot be truncated for DVR rollback; the state pool
(``serving.statepool``) checkpoints it at commit points instead, and
``mamba_layer(..., collect_states=True)`` emits the state after every
position so the verifier can pick the one at any commit index.

The three projections go through ``core.determinism.matmul`` (on the card
the hand-written GEMM pair).  The scan is a Python loop over the pass's
positions, the JAX ``lax.scan``.  Its two reductions, the causal conv's
sum over ``d_conv`` taps and the scan step's sum over ``d_state``, are
``einsum`` in the reference; on CUDA an ``einsum`` may run as a batched
cuBLAS GEMM whose kernel follows the batch.  So the commit schedule
(``fixed_order``) sums both by fixed halving trees
(``core.determinism._pairwise_sum``), whose rows do not follow B, and a
split schedule (the fast path) keeps the library reductions, as
``models.rwkv6.time_mix`` does.

Training (``models.transformer.forward_train``) runs ``mamba_layer`` from
the zero state and differentiates it by autograd through the position
loop, so the backward keeps the forward's fixed sums: a halving tree's
backward only broadcasts, and every projection's gradient runs in the
commit GEMM (``kernels.ops.GemmGrad``).  Autograd adds library reductions
of its own, the sums of broadcast products (``sum_to_size``) whose order on
the card can follow the tensor's shape: the gradients of ``conv_w``,
``conv_b``, ``dt_proj_b``, ``A_log`` and ``D`` (sums over the batch and
the positions), of ``Bm`` and ``Cm`` (sums over ``d_inner``) and of ``dt``
(a sum over ``d_state``).  They are kept: a training step at one shape
repeats bit for bit, which is what training asks; no training row is
compared across batch sizes.
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
    """Zero state of ``batch`` rows on ``device`` (default ``cuda``):
    ``conv`` in ``dtype``, ``ssm`` in f32."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=F32, device=dev),
    }


def mamba_layer(
    p: Dict,
    cfg,
    x: torch.Tensor,  # (B, W, D)
    state: Optional[Dict[str, torch.Tensor]],
    schedule: Schedule,
    collect_states: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """Returns ``(y, new_state, per_pos)``: ``y`` (B, W, D) in x's dtype,
    the state after the pass's last position, and with ``collect_states``
    the state after each position, ``{conv: (B, W, d_conv - 1, d_inner),
    ssm: (B, W, d_inner, d_state)}`` (else None).  ``state`` None starts
    from zeros."""
    B, W, D = x.shape
    di, ds, dc = cfg.d_inner, cfg.d_state, cfg.d_conv
    dt_rank = max(D // 16, 1)
    fixed = fixed_order(schedule)

    xz = matmul(x, p["in_proj"], schedule)  # (B, W, 2*di)
    xi, z = xz[..., :di], xz[..., di:]

    # causal depthwise conv over time (width dc)
    prev = (state["conv"].to(xi.dtype) if state is not None
            else torch.zeros((B, dc - 1, di), dtype=xi.dtype, device=x.device))
    ctx = torch.cat([prev, xi], dim=1)  # (B, dc - 1 + W, di)
    windows = torch.stack([ctx[:, i: i + W] for i in range(dc)], dim=-1).to(F32)
    conv_w = p["conv_w"].to(F32)  # (dc, di)
    if fixed:
        xc = _pairwise_sum(windows * conv_w.t(), axis=-1)
    else:
        xc = torch.einsum("bwic,ci->bwi", windows, conv_w)
    xc = F.silu(xc + p["conv_b"].to(F32)).to(x.dtype)
    new_conv = ctx[:, ctx.shape[1] - (dc - 1):]

    proj = matmul(xc, p["x_proj"], schedule)  # (B, W, dt_rank + 2*ds)
    dt_in = proj[..., :dt_rank]
    Bm = proj[..., dt_rank: dt_rank + ds].to(F32)  # (B, W, ds)
    Cm = proj[..., dt_rank + ds:].to(F32)
    dt = F.softplus(matmul(dt_in, p["dt_proj_w"], schedule).to(F32)
                    + p["dt_proj_b"].to(F32))  # (B, W, di)

    A = -torch.exp(p["A_log"].to(F32))  # (di, ds)
    decay = torch.exp(dt[..., None] * A)  # (B, W, di, ds)
    drive = (dt * xc.to(F32))[..., None] * Bm[:, :, None, :]  # (B, W, di, ds)

    h = state["ssm"].to(F32) if state is not None else torch.zeros(
        (B, di, ds), dtype=F32, device=x.device)
    ys, hs = [], []
    for t in recording.steps(W):
        h = decay[:, t] * h + drive[:, t]  # (B, di, ds)
        c_t = Cm[:, t, None, :]  # (B, 1, ds)
        ys.append(_pairwise_sum(h * c_t, axis=-1) if fixed
                  else torch.einsum("bis,bs->bi", h, Cm[:, t]))
        if collect_states:
            hs.append(h)
    y = torch.stack(ys, dim=1)  # (B, W, di)
    y = y + xc.to(F32) * p["D"].to(F32)
    y = y * F.silu(z.to(F32))
    out = matmul(y.to(x.dtype), p["out_proj"], schedule)

    new_state = {"conv": new_conv.to(xi.dtype), "ssm": h}
    per_pos = None
    if collect_states:
        # conv state after position w = inputs [w - dc + 2 .. w], gathered
        # from ctx in one indexed read
        idx = (torch.arange(W, device=x.device)[:, None] + 1
               + torch.arange(dc - 1, device=x.device)[None, :])
        per_pos = {"conv": ctx[:, idx].to(xi.dtype), "ssm": torch.stack(hs, dim=1)}
    return out, new_state, per_pos
