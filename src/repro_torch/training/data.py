"""Data pipelines (numpy only), the PyTorch port of ``repro.training.data``.

Training: an infinite synthetic token stream (deterministic per seed, bit
for bit the reference's batches) with document structure (BOS-delimited
segments of varying length) so attention masks and loss masking are
exercised realistically.

Serving: ShareGPT- and ArXiv-like workload generators matching the paper's
Table 3 length statistics (lognormal fits to the reported mean/median/std)
and Poisson arrivals, used by ``launch/serve.py`` and the online runner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# training stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainBatch:
    tokens: np.ndarray  # (B, S) int32 inputs
    targets: np.ndarray  # (B, S) int32 next-token labels
    loss_mask: np.ndarray  # (B, S) f32


class SyntheticTextStream:
    """Deterministic document stream: Zipf-ish unigram draws per document
    with a document-specific bigram bias, BOS=0 delimited."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, mean_doc_len: int = 512):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self.mean_doc = mean_doc_len
        # Zipf-like unigram distribution
        ranks = np.arange(1, vocab_size + 1)
        p = 1.0 / ranks
        self.unigram = p / p.sum()

    def _document(self) -> np.ndarray:
        n = max(8, int(self.rng.exponential(self.mean_doc)))
        # markov structure: with p=0.7 continue a deterministic chain,
        # else draw fresh from the Zipf unigram (learnable in ~100 steps)
        draws = self.rng.choice(self.vocab, size=n, p=self.unigram)
        cont = self.rng.random(n) < 0.7
        toks = np.empty(n, np.int64)
        toks[0] = 0  # BOS
        for i in range(1, n):
            toks[i] = (toks[i - 1] * 7 + 13) % self.vocab if cont[i] else draws[i]
        return toks.astype(np.int32)

    def __iter__(self) -> Iterator[TrainBatch]:
        buf = np.zeros(0, np.int32)
        while True:
            need = self.batch * (self.seq + 1)
            while buf.size < need:
                buf = np.concatenate([buf, self._document()])
            chunk, buf = buf[:need], buf[need:]
            chunk = chunk.reshape(self.batch, self.seq + 1)
            yield TrainBatch(
                tokens=chunk[:, :-1].copy(),
                targets=chunk[:, 1:].copy(),
                loss_mask=(chunk[:, 1:] != 0).astype(np.float32),
            )


# ---------------------------------------------------------------------------
# serving workloads (paper Table 3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    in_mean: float
    in_median: float
    in_std: float
    out_mean: float
    out_median: float
    out_std: float


SHAREGPT = WorkloadSpec("sharegpt", 304, 136, 491, 192, 118, 212)
ARXIV = WorkloadSpec("arxiv", 7017, 6435, 3479, 198, 191, 74)


def _lognormal_params(mean: float, median: float) -> Tuple[float, float]:
    """mean = exp(mu + s^2/2), median = exp(mu)."""
    mu = math.log(max(median, 1.0))
    s2 = max(2.0 * (math.log(max(mean, 1.0)) - mu), 1e-4)
    return mu, math.sqrt(s2)


def sample_workload(
    spec: WorkloadSpec, n: int, seed: int = 0,
    max_in: int = 32768, max_out: int = 2048,
) -> List[Tuple[int, int]]:
    """Returns [(input_len, output_len)] drawn from lognormal fits."""
    rng = np.random.default_rng(seed)
    mu_i, s_i = _lognormal_params(spec.in_mean, spec.in_median)
    mu_o, s_o = _lognormal_params(spec.out_mean, spec.out_median)
    ins = np.clip(rng.lognormal(mu_i, s_i, n), 4, max_in).astype(int)
    outs = np.clip(rng.lognormal(mu_o, s_o, n), 4, max_out).astype(int)
    return list(zip(ins.tolist(), outs.tolist()))


def fixed_workload(n: int, in_len: int, out_len: int) -> List[Tuple[int, int]]:
    """The paper's synthetic in=X/out=Y configurations."""
    return [(in_len, out_len)] * n


def poisson_arrivals(n: int, qps: float, seed: int = 0) -> List[float]:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, n)
    return np.cumsum(gaps).tolist()
