"""Training step: cross-entropy LM loss (+ MoE aux loss), microbatched
gradient accumulation, optional remat.

PyTorch port of ``repro.training.train``.  ``make_train_step(cfg, opt_cfg,
num_microbatches)`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: gradients from ``torch.autograd.grad`` of
``lm_loss`` (every model GEMM's backward in the commit GEMM:
``kernels.ops.GemmGrad``), then ``optimizer.apply_updates``.  The step
runs under ``core.determinism.deterministic_torch``: the embedding
gather's backward (an accumulating ``index_put_``), the loss's
``take_along_dim`` (a ``scatter_add_``) and ``moe_ffn``'s dispatch use
atomics on CUDA otherwise.  Microbatches are a Python loop (the
reference's ``lax.scan``) whose f32 gradient sums are normalized by the
global token count, so they add up to the full batch's gradient.
``params`` is the JAX package's parameter tree (``train_params``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.determinism import Schedule, VERIFY_SCHEDULE, deterministic_torch
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import forward_train
from repro_torch.training.optimizer import (
    AdamWConfig, OptState, apply_updates, tree_leaves, tree_map,
)

F32 = torch.float32


def train_params(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX tree of a serving tree (``models.base.init_params``,
    ``models.convert.params_from_numpy``): a tied config's derived
    ``unembed`` copy dropped, a padded ``unembed`` cut back to
    ``vocab_size`` columns.  Gradients, optimizer state and checkpoints
    follow this tree, as the reference's do."""
    out = dict(params)
    if cfg.tie_embeddings:
        out.pop("unembed", None)
    elif out["unembed"].shape[1] != cfg.vocab_size:
        out["unembed"] = out["unembed"][:, : cfg.vocab_size].contiguous()
    return out


def lm_loss(
    params: Any,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (b, S)
    targets: torch.Tensor,  # (b, S)
    loss_mask: torch.Tensor,  # (b, S)
    *,
    schedule: Schedule = VERIFY_SCHEDULE,
    enc_embeds: Optional[torch.Tensor] = None,
    remat: bool = True,
    aux_weight: float = 0.01,
    denom: Optional[torch.Tensor] = None,  # global token count (microbatching)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """f32 logsumexp cross-entropy under ``loss_mask``, summed over the
    batch and divided by ``denom`` (default: the mask's sum, at least 1),
    plus ``aux_weight`` times the MoE aux loss.  Returns ``(total,
    metrics)``."""
    logits, aux = forward_train(
        params, cfg, tokens, schedule=schedule,
        enc_embeds=enc_embeds if cfg.family == "encdec" else None, remat=remat)
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, targets[..., None].long(), dim=-1)[..., 0]
    ce = (lse - tgt) * loss_mask
    if denom is None:
        denom = torch.clamp(torch.sum(loss_mask), min=1.0)
    loss = torch.sum(ce) / denom
    total = loss + aux_weight * aux["aux_loss"]
    metrics = {
        "loss": loss,
        "aux_loss": aux["aux_loss"],
        "dropped_frac": aux["dropped_frac"],
        "tokens": denom,
    }
    return total, metrics


def loss_and_grads(
    params: Any,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    *,
    schedule: Schedule = VERIFY_SCHEDULE,
    remat: bool = True,
    denom: Optional[torch.Tensor] = None,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """``(grads, metrics)`` of ``lm_loss`` on ``batch`` (``jax.value_and_grad``
    with ``has_aux``): ``torch.autograd.grad`` over fresh leaves of
    ``params``, each gradient in its parameter's dtype (zeros for a leaf the
    loss does not reach), the metrics detached."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    total, metrics = lm_loss(
        p, cfg, batch["tokens"], batch["targets"], batch["loss_mask"],
        schedule=schedule, enc_embeds=batch.get("enc_embeds"), remat=remat, denom=denom)
    leaves = tree_leaves(p)
    gs = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g for g, t in zip(gs, leaves))
    return tree_map(lambda t: next(it), p), {k: v.detach() for k, v in metrics.items()}


def batch_grads(
    params: Any,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    *,
    num_microbatches: int = 1,
    schedule: Schedule = VERIFY_SCHEDULE,
    remat: bool = True,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """The step's gradients: one ``loss_and_grads`` pass, or, with
    ``num_microbatches`` n > 1, the n leading-axis slices of ``batch`` each
    normalized by the global token count and their gradients summed in f32
    in order; ``metrics`` are the last microbatch's."""
    B = batch["tokens"].shape[0]
    n = num_microbatches
    assert B % n == 0
    if n == 1:
        return loss_and_grads(params, cfg, batch, schedule=schedule, remat=remat)
    denom = torch.clamp(torch.sum(batch["loss_mask"]), min=1.0)
    grads = tree_map(lambda t: torch.zeros(t.shape, dtype=F32, device=t.device), params)
    for i in range(n):
        mb = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
        g, metrics = loss_and_grads(params, cfg, mb, schedule=schedule, remat=remat,
                                    denom=denom)
        grads = tree_map(lambda a, b: a + b.to(F32), grads, g)
    return grads, metrics


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    num_microbatches: int = 1,
    remat: bool = True,
    schedule: Schedule = VERIFY_SCHEDULE,
):
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``batch_grads`` then ``apply_updates``, under
    ``deterministic_torch``.

    batch: ``{"tokens": (B, S), "targets": (B, S), "loss_mask": (B, S)
    [, "enc_embeds": (B, Se, D)]}`` tensors on the params' device; B must
    divide by ``num_microbatches``.  ``metrics`` (0-d tensors) holds the
    last microbatch's loss terms, the global token count, ``grad_norm`` and
    ``lr``."""

    def train_step(params, opt_state: OptState, batch):
        with deterministic_torch():
            grads, metrics = batch_grads(params, cfg, batch,
                                         num_microbatches=num_microbatches,
                                         schedule=schedule, remat=remat)
            new_params, new_opt, opt_metrics = apply_updates(opt_cfg, params, grads,
                                                             opt_state)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step
