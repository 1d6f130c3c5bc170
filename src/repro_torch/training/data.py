"""Serving workloads: ShareGPT- and ArXiv-like request lengths.

The serving half of ``repro.training.data`` (numpy only): generators
matching the paper's Table 3 length statistics (lognormal fits to the
reported mean/median/std) and Poisson arrivals, used by ``launch/serve.py``
and the online runner.  The training stream (``SyntheticTextStream``,
``TrainBatch``) waits for the port's training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


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
