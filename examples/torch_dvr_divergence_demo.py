"""The paper's O1 phenomenon end to end, on the PyTorch port:

1. fast-path decoding DIVERGES across batch compositions (floating-point
   reduction-order drift amplified autoregressively), and
2. DVR repairs it: the deterministic request's committed output is
   bitwise identical across all traffic mixes.

Runs on the GPU (the port's hand-written kernels) unless ``--device cpu``
is given (their plain versions).  The weights are random, from ``--seed``
(default 1).  Whether NONDET's 48 tokens part ways depends on them: on the
CPU, seeds 1-5 diverge, while at seed 0 the fast path's drift flips no
argmax within 48 tokens.  LLM42 must be identical at every seed.

Run:  PYTHONPATH=src python examples/torch_dvr_divergence_demo.py [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.determinism import Mode, ReductionPolicy
from repro_torch.core.spans import consistent_spans
from repro_torch.models.base import init_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--seed", type=int, default=1, help="seed of the random weights")
args = ap.parse_args()
device = resolve_device(args.device)

cfg = get_smoke_config("llama3-8b")
params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                         combine_dtype="bfloat16")
PROMPT = list(range(1, 11))


def run(n_neighbours, deterministic):
    eng = Engine(cfg, params, mode=Mode.LLM42 if deterministic else Mode.NONDET,
                 policy=policy, window=6, group=2, max_batch=8, capacity=256)
    eng.submit(Request(rid=0, prompt=PROMPT, sampling=SamplingParams(
        max_new_tokens=48, is_deterministic=deterministic, seed=7)))
    for i in range(n_neighbours):
        eng.submit(Request(rid=1 + i, prompt=[3 * i + k for k in range(6)],
                           sampling=SamplingParams(max_new_tokens=48)))
    out = {r.rid: r for r in eng.run()}
    return out[0]


print("=== fast path only (NONDET): same request, different co-traffic ===")
alone = run(0, False).committed
for n in (3, 6):
    other = run(n, False).committed
    s = consistent_spans(alone, other)
    print(f"  vs {n} neighbours: first consistent span {s.first_span}/{s.total}, "
          f"second span {s.second_span}  (diverged: {alone != other})")

print("=== with DVR (LLM42): determinism enforced by verification ===")
a = run(0, True)
for n in (3, 6):
    b = run(n, True)
    print(f"  vs {n} neighbours: identical={a.committed == b.committed} "
          f"rollbacks={b.num_rollbacks} recomputed={b.num_recomputed_tokens}")
