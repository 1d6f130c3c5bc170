"""Batch-invariant sampling (paper §4.4 "Sampling").

PyTorch counterpart of ``repro.serving.sampler``.

Greedy (temperature 0, the default of ``SamplingParams``): ``argmax`` with
the first-max tiebreak.

Seeded (temperature > 0): Gumbel-argmax with noise that is a pure function
of ``(seed, output position)``, so a sample depends on its own row's logits
and counter alone, never on the batch.  The noise is JAX's, bit for bit:
``_gumbel_for`` reproduces ``gumbel(fold_in(fold_in(PRNGKey(0), seed),
position), (V,), float32)`` as jax 0.9.0 computes it with its defaults
(``jax_threefry_partitionable = True``, ``jax_default_prng_impl =
threefry2x32``, ``jax_high_dynamic_range_gumbel = False``, i.e. gumbel
``mode="low"``):

* the Threefry-2x32 hash (20 rounds, key schedule with ``0x1BD11BDA``);
* ``fold_in(key, d)`` = ``threefry2x32(key, (0, d mod 2**32))``;
* partitionable ``random_bits`` for a ``(V,)`` draw: counter ``(0, i)`` for
  element ``i``, bits = ``hi ^ lo`` of its hash;
* uniform in ``[tiny, 1)``: ``(bits >> 9) | 0x3F800000`` read as f32, minus
  1, times ``1 - tiny`` plus ``tiny``, floored at ``tiny``;
* ``-log(-log(u))`` in f32.

The 32-bit hash runs in int64 with masking (PyTorch's uint32 arithmetic is
partial), on the logits' own device: the card draws its own noise, with no
host round trip per row.  ``log`` is the device's, so the Gumbel values may
differ from XLA's in the last bits; the bits and uniforms are exact.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

F32 = torch.float32
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(F32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values;
    the four arguments broadcast.  ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def fold_in(key: Tuple[torch.Tensor, torch.Tensor],
            data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in`` on raw threefry keys ``(k1, k2)``: hash the
    counter pair ``(0, data mod 2**32)`` under the key."""
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data & _M32)


def random_bits(key: Tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """Partitionable 32-bit ``random_bits`` of shape ``(..., n)`` for keys of
    shape ``(...,)``: element ``i`` hashes the counter ``(0, i)``."""
    k1, k2 = key[0][..., None], key[1][..., None]
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's f32 uniform in ``[tiny, 1)`` from 32 random bits (int64)."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(F32) - 1.0
    tiny = torch.tensor(_TINY, dtype=F32, device=bits.device)
    span = torch.tensor(1.0, dtype=F32, device=bits.device) - tiny
    return torch.maximum(tiny, floats * span + tiny)


def _gumbel_for(seeds: Sequence[int], positions: Sequence[int], vocab: int,
                device: torch.device) -> torch.Tensor:
    """(N, vocab) f32 Gumbel noise, row ``i`` a pure function of
    ``(seeds[i], positions[i])``."""
    s = torch.tensor([int(x) & _M32 for x in seeds], dtype=torch.int64, device=device)
    p = torch.tensor([int(x) & _M32 for x in positions], dtype=torch.int64, device=device)
    zero = torch.zeros_like(s)
    key = fold_in(fold_in((zero, zero), s), p)  # PRNGKey(0) is (0, 0)
    u = uniform_from_bits(random_bits(key, vocab))
    return -torch.log(-torch.log(u))


def _sample_rows(logits: torch.Tensor, seeds: Sequence[int],
                 positions: Sequence[int], temperatures: Sequence[float],
                 top_ks: Sequence[int]) -> torch.Tensor:
    """(N,) int32 tokens for N rows of (N, V) logits: greedy where the
    temperature is <= 0, seeded Gumbel-argmax over the top-k survivors
    elsewhere (ties at the k-th value keep every equal candidate)."""
    out = logits.argmax(dim=-1).to(torch.int32)
    rows = [i for i, t in enumerate(temperatures) if t > 0]
    if not rows:
        return out
    dev = logits.device
    x = logits[rows].to(F32)
    V = x.shape[-1]
    if any(int(top_ks[i]) > 0 for i in rows):
        ks = torch.tensor([int(top_ks[i]) for i in rows], dtype=torch.int64, device=dev)
        desc = torch.sort(x, dim=-1, descending=True).values
        kth = desc.gather(1, (ks - 1).clamp(0, V - 1)[:, None])
        x = x.masked_fill(~((ks[:, None] <= 0) | (x >= kth)), float("-inf"))
    g = _gumbel_for([seeds[i] for i in rows], [positions[i] for i in rows], V, dev)
    t = torch.tensor([temperatures[i] for i in rows], dtype=F32, device=dev)
    t = torch.clamp_min(t, 1e-6)
    out[rows] = (x / t[:, None] + g).argmax(dim=-1).to(torch.int32)
    return out


def sample_token(
    logits: torch.Tensor,  # (V,)
    seed: int,
    position: int,
    temperature: float,
    top_k: int = 0,
) -> torch.Tensor:
    """One token (int32 scalar tensor), a pure function of (logits, seed,
    position, temperature, top_k)."""
    return _sample_rows(logits[None], [seed], [position], [temperature], [top_k])[0]


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
    if top_ks is None:
        top_ks = [0] * logits.shape[0]
    return _sample_rows(logits, seeds, positions, temperatures, top_ks)


def sample_window(
    logits: torch.Tensor,  # (B, W, V)
    seeds: Sequence[int],
    base_positions: Sequence[int],
    temperatures: Sequence[float],
    top_ks: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """(B, W) int32 tokens; window position j of row b samples with the
    counter ``base_positions[b] + j``."""
    B, W, V = logits.shape
    if top_ks is None:
        top_ks = [0] * B

    def rep(xs: Sequence) -> List:
        return [x for x in xs for _ in range(W)]

    pos = [int(b) + j for b in base_positions for j in range(W)]
    return _sample_rows(logits.reshape(B * W, V), rep(seeds), pos,
                        rep(temperatures), rep(top_ks)).reshape(B, W)
