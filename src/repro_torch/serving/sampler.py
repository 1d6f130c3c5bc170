"""Batch-invariant sampling (paper §4.4 "Sampling"), greedy subset.

PyTorch counterpart of ``repro.serving.sampler``.  Greedy sampling
(temperature 0, the default of ``SamplingParams``) is ``argmax`` with the
first-max tiebreak, a pure function of one row's logits, so it is
independent of batch size and of a row's place in the batch.

Seeded Gumbel sampling (temperature > 0) needs JAX's threefry bits
(``jax.random.fold_in`` + ``gumbel``) reproduced in torch, or seeded samples
will not match the reference token for token; until that is ported,
``temperature > 0`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

F32 = torch.float32

def _require_greedy(temperatures: Sequence[float]) -> None:
    if any(t > 0 for t in temperatures):
        raise NotImplementedError(
            "seeded sampling (temperature > 0) needs JAX's threefry bits "
            "reproduced in torch; only greedy sampling is ported")


def sample_token(
    logits: torch.Tensor,  # (V,)
    seed: int,
    position: int,
    temperature: float,
    top_k: int = 0,
) -> torch.Tensor:
    """One token (int32 scalar tensor): greedy argmax, first max wins."""
    _require_greedy([temperature])
    return logits.argmax(dim=-1).to(torch.int32)


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    """Top-1 minus top-2 logit along the last axis; ties give 0.

    The second max masks the argmax *index*, not the max value, so two equal
    maximal logits report margin exactly 0."""
    x = logits.to(F32)
    am = x.argmax(dim=-1)
    top1 = x.amax(dim=-1)
    is_top1 = torch.arange(x.shape[-1], device=x.device) == am[..., None]
    top2 = x.masked_fill(is_top1, float("-inf")).amax(dim=-1)
    return top1 - top2


def sample_batch(
    logits: torch.Tensor,  # (B, V)
    seeds: Sequence[int],
    positions: Sequence[int],
    temperatures: Sequence[float],
    top_ks: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """(B,) int32 tokens, one per row."""
    _require_greedy(temperatures)
    return logits.argmax(dim=-1).to(torch.int32)


def sample_window(
    logits: torch.Tensor,  # (B, W, V)
    seeds: Sequence[int],
    base_positions: Sequence[int],
    temperatures: Sequence[float],
    top_ks: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """(B, W) int32 tokens, each window position sampled on its own."""
    _require_greedy(temperatures)
    return logits.argmax(dim=-1).to(torch.int32)
