"""Quickstart on the PyTorch port: selective determinism in 30 lines.

Runs on the GPU (the port's hand-written kernels) unless ``--device cpu``
is given (their plain versions).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.determinism import Mode
from repro_torch.models.base import init_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

cfg = get_smoke_config("llama3-8b")  # reduced Llama-3.1-8B
params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)

engine = Engine(cfg, params, mode=Mode.LLM42, window=8, group=2,
                max_batch=8, capacity=256)

# one request NEEDS determinism (audit/eval); the rest are free-running
for i in range(4):
    engine.submit(Request(
        rid=i,
        prompt=[7 * i + j for j in range(8)],
        sampling=SamplingParams(
            max_new_tokens=24,
            is_deterministic=(i == 0),  # the paper's per-request API flag
            seed=42,
        ),
    ))

for r in sorted(engine.run(), key=lambda r: r.rid):
    tag = "DET  " if r.sampling.is_deterministic else "fast "
    print(f"[{tag}] req {r.rid}: {r.committed}")
    if r.sampling.is_deterministic:
        print(f"         rollbacks={r.num_rollbacks} "
              f"recomputed={r.num_recomputed_tokens} "
              f"(identical on every rerun, any co-traffic)")
