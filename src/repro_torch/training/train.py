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

``make_train_program`` is the counterpart of the reference's
``jax.jit(make_train_step(...))``: the same step as one captured program
per batch shape (``serving.programs``), over parameters and optimizer
state it holds at fixed addresses and updates in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.determinism import Schedule, VERIFY_SCHEDULE, deterministic_torch
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import forward_train
from repro_torch.serving import programs
from repro_torch.training.optimizer import (
    AdamWConfig, OptState, apply_updates, tree_copy_, tree_leaves, tree_map,
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
        return _step_and_grads(cfg, opt_cfg, params, opt_state, batch,
                               num_microbatches=num_microbatches, remat=remat,
                               schedule=schedule)[:3]

    return train_step


def _step_and_grads(cfg: ModelConfig, opt_cfg: AdamWConfig, params: Any, opt_state: OptState,
                    batch: Dict[str, torch.Tensor], **kw: Any) -> Tuple[Any, OptState, Dict, Any]:
    """``make_train_step``'s step, its gradients returned too."""
    with deterministic_torch():
        grads, metrics = batch_grads(params, cfg, batch, **kw)
        new_params, new_opt, opt_metrics = apply_updates(opt_cfg, params, grads, opt_state)
    return new_params, new_opt, {**metrics, **opt_metrics}, grads


#: the batch's tensors in the order a training program takes them
BATCH_KEYS = ("tokens", "targets", "loss_mask", "enc_embeds")


def _opt_copy_(dst: OptState, src: OptState) -> None:
    dst.step.copy_(src.step)
    tree_copy_(dst.mu, src.mu)
    tree_copy_(dst.nu, src.nu)


def _train_bodies(cfg: ModelConfig, opt_cfg: AdamWConfig, params: Any, opt_state: OptState,
                  **kw: Any) -> Tuple[Callable, Callable]:
    """A training program's body and its warm-up over the held trees: the
    body runs ``make_train_step``'s step, writes the new parameters,
    moments and step into ``params`` and ``opt_state`` and returns
    ``(metrics, grads)``; the warm-up runs the step and writes nothing."""
    def run(*tensors):
        batch = {k: t for k, t in zip(BATCH_KEYS, tensors) if t is not None}
        return _step_and_grads(cfg, opt_cfg, params, opt_state, batch, **kw)

    def body(*tensors):
        new_params, new_opt, metrics, grads = run(*tensors)
        tree_copy_(params, new_params)
        _opt_copy_(opt_state, new_opt)
        return metrics, grads

    def warm_up(*tensors):
        run(*tensors)

    return body, warm_up


class TrainProgram:
    """The training step as one program per batch shape (see
    ``make_train_program``).  ``params`` and ``opt_state`` are the held
    trees, at fixed addresses on ``device``; ``grads`` the last step's
    gradients (the step's own outputs); ``programs`` the programs by key
    ``("train", B, S, Se or None)``, their graphs in one pool that goes
    back to the card with this object."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig, device: torch.device,
                 **step_kw: Any):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.device = device
        self.step_kw = step_kw
        self.params: Any = None
        self.opt_state: Optional[OptState] = None
        self.grads: Any = None
        self.programs: Dict[Any, programs.Program] = {}
        self.pool = programs.Pool()

    def load(self, params: Any, opt_state: Optional[OptState] = None) -> None:
        """Copy the caller's trees into the held ones (made at the first
        load, in each leaf's dtype; moments in f32); without ``opt_state``
        the moments and the step start from zero.  The caller's trees are
        only read."""
        if self.params is None:
            self.params = tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device=self.device), params)
            f32 = lambda t: torch.empty(t.shape, dtype=F32, device=self.device)  # noqa: E731
            self.opt_state = OptState(
                step=torch.empty((), dtype=torch.int32, device=self.device),
                mu=tree_map(f32, params), nu=tree_map(f32, params))
        tree_copy_(self.params, params)
        if opt_state is None:
            for t in tree_leaves(self.opt_state.mu) + tree_leaves(self.opt_state.nu):
                t.zero_()
            self.opt_state.step.zero_()
        else:
            _opt_copy_(self.opt_state, opt_state)

    def _args(self, batch: Dict[str, torch.Tensor]) -> Tuple[Any, Tuple]:
        enc = batch.get("enc_embeds")
        B, S = batch["tokens"].shape
        key = ("train", B, S, None if enc is None else enc.shape[1])
        return key, tuple(batch.get(k) for k in BATCH_KEYS)

    def program(self, batch: Dict[str, torch.Tensor]) -> programs.Program:
        """The program of ``batch``'s shape, made at its first use."""
        assert self.params is not None, "load() the parameters first"
        key, _ = self._args(batch)
        prog = self.programs.get(key)
        if prog is None:
            body, warm_up = _train_bodies(self.cfg, self.opt_cfg, self.params,
                                          self.opt_state, **self.step_kw)
            prog = programs.Program(key, body, self.device, pool=self.pool,
                                    warm_up=warm_up)
            self.programs[key] = prog
        return prog

    def capture(self, batch: Dict[str, torch.Tensor]) -> None:
        """Warm up and capture the program of ``batch``'s shape without
        taking a step (the card only; its first ``step`` would)."""
        self.program(batch).capture(*self._args(batch)[1])

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One training step on ``batch``: the held trees updated, the
        metrics returned (0-d tensors, as ``make_train_step``'s; on the card
        the graph's own outputs, which the next step overwrites)."""
        metrics, self.grads = self.program(batch)(*self._args(batch)[1])
        return metrics


def make_train_program(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    num_microbatches: int = 1,
    remat: bool = True,
    schedule: Schedule = VERIFY_SCHEDULE,
    device: Optional[Union[str, torch.device]] = None,
) -> TrainProgram:
    """The counterpart of ``jax.jit(make_train_step(cfg, opt_cfg,
    num_microbatches=n))``: a ``TrainProgram`` whose ``step(batch)`` runs
    ``make_train_step``'s step as the program of the batch's shape.  On the
    card the program is a CUDA graph captured at the shape's first step
    (after a warm-up run of the step that writes nothing) and replayed at
    every step, the first included; on the CPU it runs the step on the same
    buffers; under ``programs.eager()`` it runs the step directly.  Each
    way the new parameters, moments and step are written into the held
    trees (``load`` fills them from the caller's, by copying), and every
    rounding is the eager step's.  ``device`` defaults to ``cuda``."""
    return TrainProgram(cfg, opt_cfg, resolve_device(device),
                        num_microbatches=num_microbatches, remat=remat, schedule=schedule)
