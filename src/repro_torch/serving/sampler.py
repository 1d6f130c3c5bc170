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

``sample_window`` also takes its seeds, positions and temperatures as
tensors, as the reference's does: then no value is read on the host (the
dry run calls it on meta tensors), every row's seeded sample is computed
and the greedy rows select their argmax, the same tokens as the host path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

F32 = torch.float32
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(F32).tiny
#: ``1 - tiny`` in f32 (which is 1.0), a host constant
_SPAN = float(torch.tensor(1.0, dtype=F32) - torch.tensor(_TINY, dtype=F32))


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
    return torch.clamp_min(floats * _SPAN + _TINY, _TINY)


def _gumbel_for(seeds: Sequence[int], positions: Sequence[int], vocab: int,
                device: torch.device) -> torch.Tensor:
    """(N, vocab) f32 Gumbel noise, row ``i`` a pure function of
    ``(seeds[i], positions[i])``."""
    s = torch.tensor([int(x) & _M32 for x in seeds], dtype=torch.int64, device=device)
    p = torch.tensor([int(x) & _M32 for x in positions], dtype=torch.int64, device=device)
    return _gumbel(s, p, vocab)


def _gumbel(s: torch.Tensor, p: torch.Tensor, vocab: int) -> torch.Tensor:
    """``_gumbel_for`` on int64 tensors of seeds and positions mod 2**32."""
    zero = torch.zeros_like(s)
    key = fold_in(fold_in((zero, zero), s), p)  # PRNGKey(0) is (0, 0)
    u = uniform_from_bits(random_bits(key, vocab))
    return -torch.log(-torch.log(u))


def _seeded(logits: torch.Tensor, seeds: torch.Tensor, positions: torch.Tensor,
            temperatures: torch.Tensor, top_ks: torch.Tensor, *,
            top_k: bool = True) -> torch.Tensor:
    """(N,) int32 seeded Gumbel-argmax of (N, V) logits, row ``i`` over its
    top-``top_ks[i]`` survivors (ties at the k-th value keep every equal
    candidate; k <= 0 keeps all).  The arguments are (N,) tensors; with
    ``top_k=False`` no row is masked and the sort is skipped."""
    x = logits.to(F32)
    V = x.shape[-1]
    if top_k:
        ks = top_ks.to(torch.int64)
        desc = torch.sort(x, dim=-1, descending=True).values
        kth = desc.gather(1, (ks - 1).clamp(0, V - 1)[:, None])
        x = x.masked_fill(~((ks[:, None] <= 0) | (x >= kth)), float("-inf"))
    g = _gumbel(seeds.to(torch.int64) & _M32, positions.to(torch.int64) & _M32, V)
    t = torch.clamp_min(temperatures.to(F32), 1e-6)
    return (x / t[:, None] + g).argmax(dim=-1).to(torch.int32)


def _sample_rows(logits: torch.Tensor, seeds: Sequence[int],
                 positions: Sequence[int], temperatures: Sequence[float],
                 top_ks: Sequence[int]) -> torch.Tensor:
    """(N,) int32 tokens for N rows of (N, V) logits: greedy where the
    temperature is <= 0, ``_seeded`` elsewhere.  The rows to sample are
    picked on the host, so an all-greedy batch draws no noise."""
    out = logits.argmax(dim=-1).to(torch.int32)
    rows = [i for i, t in enumerate(temperatures) if t > 0]
    if not rows:
        return out
    dev = logits.device

    def col(xs: Sequence, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor([xs[i] for i in rows], dtype=dtype, device=dev)

    ks = [int(k) for k in top_ks]
    out[rows] = _seeded(
        logits[rows], col([int(x) & _M32 for x in seeds], torch.int64),
        col([int(x) & _M32 for x in positions], torch.int64),
        col(temperatures, F32), col(ks, torch.int64),
        top_k=any(ks[i] > 0 for i in rows))
    return out


def _sample_rows_tensor(logits: torch.Tensor, seeds: torch.Tensor,
                        positions: torch.Tensor, temperatures: torch.Tensor,
                        top_ks: torch.Tensor) -> torch.Tensor:
    """``_sample_rows`` with (N,) tensor arguments and no host read: every
    row's ``_seeded`` sample, the greedy rows (t <= 0) then taking their
    argmax."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    sampled = _seeded(logits, seeds, positions, temperatures, top_ks)
    return torch.where(temperatures > 0, sampled, greedy)


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
    """(B,) int32 tokens, one per row.  ``seeds``, ``positions`` and
    ``temperatures`` are host sequences, or (B,) tensors (``top_ks`` then a
    tensor or None), which no value leaves for the host: the form an
    engine program takes."""
    if torch.is_tensor(seeds):
        ks = (torch.zeros(logits.shape[0], dtype=torch.int64, device=logits.device)
              if top_ks is None else top_ks)
        return _sample_rows_tensor(logits, seeds, positions, temperatures, ks)
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
    counter ``base_positions[b] + j``.  ``seeds``, ``base_positions`` and
    ``temperatures`` are host sequences, or (B,) tensors (``top_ks`` then a
    tensor or None), which no value leaves for the host."""
    B, W, V = logits.shape
    if torch.is_tensor(seeds):
        ks = (torch.zeros(B, dtype=torch.int64, device=logits.device)
              if top_ks is None else top_ks)
        pos = base_positions[:, None].to(torch.int64) + torch.arange(
            W, dtype=torch.int64, device=logits.device)[None, :]
        return _sample_rows_tensor(
            logits.reshape(B * W, V), seeds.repeat_interleave(W), pos.reshape(-1),
            temperatures.repeat_interleave(W), ks.repeat_interleave(W)).reshape(B, W)
    if top_ks is None:
        top_ks = [0] * B

    def rep(xs: Sequence) -> List:
        return [x for x in xs for _ in range(W)]

    pos = [int(b) + j for b in base_positions for j in range(W)]
    return _sample_rows(logits.reshape(B * W, V), rep(seeds), pos,
                        rep(temperatures), rep(top_ks)).reshape(B, W)
