"""End-to-end serving driver for the PyTorch port (single engine).

Runs the LLM-42 engine on a synthetic workload with a mix of deterministic
and non-deterministic requests and reports committed tokens, rollbacks and
recomputed tokens, and the run's time: on the card, device time from CUDA
events around the whole run; on the CPU, host wall time.  Without
``--smoke`` it serves the full config (on a GPU: Llama-3-8B width, random
weights from ``--seed``).

  python -m repro_torch.launch.serve --smoke --device cpu
  python -m repro_torch.launch.serve --requests 8               # on a GPU

``--replicas`` and ``--tp`` (cluster and tensor-parallel serving), the
ShareGPT workload and the costed clock wait for later slices.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch import resolve_device
from repro_torch.core.determinism import FAST_PATH_POLICY, Mode
from repro_torch.models.base import init_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import (
    AdaptivePolicy,
    OverlapPolicy,
    PauseDecodePolicy,
)

SCHEDULERS = {
    "default": None,
    "overlap": OverlapPolicy,
    "pause": PauseDecodePolicy,
    "adaptive": AdaptivePolicy,
}


def build_requests(cfg, n, det_ratio, max_out, seed=0, in_len=32):
    """``n`` synthetic requests: ``in_len`` random prompt tokens, ``max_out``
    new tokens, deterministic with probability ``det_ratio`` (the JAX
    driver's builder, synthetic workload)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab_size, in_len).tolist()
        det = rng.random() < det_ratio
        reqs.append(Request(
            rid=i, prompt=prompt,
            sampling=SamplingParams(
                max_new_tokens=max_out, is_deterministic=det, seed=1000 + i,
            ),
        ))
    return reqs


def serve(engine: Engine, reqs) -> dict:
    """Submit ``reqs``, run the engine to completion, and return counts
    plus the run's time (``device_s`` from CUDA events on the card,
    ``host_s`` always)."""
    for r in reqs:
        engine.submit(r)
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    done = engine.run()
    if cuda:
        end.record()
        end.synchronize()
    host_s = time.perf_counter() - t0
    return {
        "finished": len(done),
        "committed": sum(r.num_output for r in done),
        "rollbacks": sum(r.num_rollbacks for r in done),
        "recomputed": sum(r.num_recomputed_tokens for r in done),
        "iterations": engine._now,
        "host_s": host_s,
        "device_s": start.elapsed_time(end) / 1e3 if cuda else None,
        "done": done,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions of the kernels)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--det-ratio", type=float, default=0.5)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--mode", default="llm42",
                    choices=["llm42", "nondet", "batch_invariant"])
    ap.add_argument("--scheduler", default="default", choices=sorted(SCHEDULERS))
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--spec-depth", type=int, default=1)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="tokens per prefill chunk (0 = exclusive prefill)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)
    cfg = (config_registry.get_smoke_config(args.arch) if args.smoke
           else config_registry.get_config(args.arch))
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"device={device} mode={args.mode} n={args.requests} "
          f"det_ratio={args.det_ratio}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    sched_cls = SCHEDULERS[args.scheduler]
    engine = Engine(
        cfg, params, mode=Mode(args.mode), policy=FAST_PATH_POLICY,
        window=args.window, group=args.group, max_batch=args.max_batch,
        capacity=min(cfg.max_seq_len, 512),
        scheduler=sched_cls() if sched_cls else None,
        spec_depth=args.spec_depth, prefill_chunk=args.prefill_chunk,
        block_size=args.block_size,
    )
    reqs = build_requests(cfg, args.requests, args.det_ratio, args.max_new, args.seed)
    res = serve(engine, reqs)
    out = res["committed"]
    print(f"finished {res['finished']} requests, {out} tokens committed in "
          f"{res['iterations']} iterations")
    print(f"rollbacks={res['rollbacks']} recomputed_tokens={res['recomputed']} "
          f"({100.0 * res['recomputed'] / max(out, 1):.2f}%)")
    if res["device_s"] is not None:
        print(f"device time {res['device_s']:.3f} s (CUDA events) -> "
              f"{out / res['device_s']:.1f} committed tok/s on "
              f"{torch.cuda.get_device_name(device)}")
    else:
        print(f"host wall time {res['host_s']:.3f} s on the CPU "
              f"(plain versions of the kernels; not a device time)")


if __name__ == "__main__":
    main()
