"""AdamW on nested dicts of tensors, with global-norm gradient clipping and
a linear-warmup + cosine-decay learning-rate schedule.

PyTorch port of ``repro.training.optimizer``, in the reference's order of
operations: moments in f32, each parameter updated in f32 and rounded to
its own dtype.  Python scalars meet f32 tensors as JAX's weakly typed
scalars do (cast to f32 at the operation), so every step is f32 arithmetic
in the reference's order; the tree's leaves are visited in sorted-key
order, ``jax.tree_util``'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any  # first moment (tree like params, f32)
    nu: Any  # second moment


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves in sorted-key order (``jax.tree_util.tree_leaves``')."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_copy_(dst: Any, src: Any) -> None:
    """Copy each leaf of ``src`` into the leaf of ``dst`` at its path (same
    shapes and dtypes): how a held tree takes a step's results, no value
    rounded."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        assert d.shape == s.shape and d.dtype == s.dtype, (d.shape, s.shape, d.dtype, s.dtype)
        d.copy_(s)


def init_opt_state(params: Any) -> OptState:
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
    )


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(F32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in order, from 0) of each leaf's f32 sum
    of squares."""
    sq = sum(torch.sum(torch.square(g.to(F32))) for g in tree_leaves(tree))
    return torch.sqrt(sq)


def apply_updates(
    cfg: AdamWConfig, params: Any, grads: Any, state: OptState
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = tree_map(lambda g: g.to(F32) * scale, grads)

    step = state.step + 1
    b1, b2 = cfg.betas
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    bc1 = 1 - b1 ** step.to(F32)
    bc2 = 1 - b2 ** step.to(F32)
    lr = lr_at(cfg, step)

    def upd(p, m, v):
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, OptState(step, mu, nu), metrics
