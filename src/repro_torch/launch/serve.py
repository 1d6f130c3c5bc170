"""End-to-end serving driver for the PyTorch port (one engine, or replicas
behind the deterministic router with ``--replicas``).

Runs the LLM-42 engine on a synthetic or ShareGPT-like workload with a mix
of deterministic and non-deterministic requests and reports committed
tokens, rollbacks and recomputed tokens, and two times:

* the run's own time: on the card, device time from CUDA events around the
  whole run; on the CPU, host wall time;
* the modeled H100 time: the cost model (``serving.costmodel.H100``) over
  the run's events at the full config's scale (also under ``--smoke``), or
  the engine's costed clock when ``--verify-latency-ms`` puts it on one.
  It is a model of a compiled engine's device time, not a measurement.

Without ``--smoke`` it serves the full config (random weights from
``--seed``).

  python -m repro_torch.launch.serve --smoke --device cpu
  python -m repro_torch.launch.serve --smoke --device cpu --workload sharegpt \\
      --verify-latency-ms 10 --trace-out trace.json
  python -m repro_torch.launch.serve --requests 8               # on a GPU
  python -m repro_torch.launch.serve --arch seamless-m4t-medium --smoke --device cpu
  python -m repro_torch.launch.serve --arch llava-next-mistral-7b --smoke --device cpu

An encoder-decoder config's requests carry stub audio frames
(``models.multimodal.audio_frames``) and a prefix-embeds config's stub
patch embeddings (``vision_embeds``), drawn from the run's seeded
generator.

``--replicas N`` (N > 1) serves through ``cluster.Cluster``: N engines on
one device that share the params, each with its own KV pool, behind the
deterministic router, on per-replica costed clocks (``cluster.run_online``,
``costmodel.H100``), the requests arriving evenly at ``--qps`` of modeled
time (0: all at t = 0); ``--trace-out`` then writes the merged per-replica
trace.

  python -m repro_torch.launch.serve --smoke --device cpu --replicas 2 --qps 20

``--tp N`` runs the fast path at logical tensor-parallel width N (1, 2 or
4) for the single engine and for every replica: decode GEMMs fold N K
chunks in chunk order, while every committed token comes from the pinned
canonical tree, so committed streams do not change with N.

  python -m repro_torch.launch.serve --smoke --device cpu --tp 2
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs as config_registry
from repro_torch import resolve_device
from repro_torch.core.determinism import FAST_PATH_POLICY, Mode
from repro_torch.models.base import init_params
from repro_torch.models.multimodal import audio_frames, vision_embeds
from repro_torch.serving import costmodel
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import (
    AdaptivePolicy,
    OverlapPolicy,
    PauseDecodePolicy,
)
from repro_torch.training.data import SHAREGPT, sample_workload

SCHEDULERS = {
    "default": None,
    "overlap": OverlapPolicy,
    "pause": PauseDecodePolicy,
    "adaptive": AdaptivePolicy,
}


def build_requests(cfg, n, det_ratio, max_out, seed=0, workload="synthetic",
                   in_len=32, generator=None):
    """``n`` requests of random prompt tokens, deterministic with
    probability ``det_ratio`` (as ``repro.launch.serve.build_requests``).  ``synthetic``:
    ``in_len`` prompt tokens and ``max_out`` new tokens each; ``sharegpt``:
    lengths drawn from the ShareGPT fit (prompts at most 256 tokens, at
    most ``max_out`` new tokens).  An encoder-decoder config's requests get
    ``enc_embeds`` (1, encoder_seq_len, d_model) and a prefix-embeds
    config's ``prefix_embeds`` (1, num_prefix_embeds, d_model), request by
    request from ``generator`` (default: a CPU generator seeded with
    ``seed``), on its device."""
    side = cfg.family == "encdec" or cfg.num_prefix_embeds
    if side and generator is None:
        generator = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    if workload == "sharegpt":
        lens = sample_workload(SHAREGPT, n, seed, max_in=256, max_out=max_out)
    else:
        lens = [(in_len, max_out)] * n
    reqs = []
    for i, (il, ol) in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab_size, il).tolist()
        det = rng.random() < det_ratio
        r = Request(
            rid=i, prompt=prompt,
            sampling=SamplingParams(
                max_new_tokens=min(ol, max_out), is_deterministic=det,
                seed=1000 + i,
            ),
        )
        if cfg.family == "encdec":
            r.enc_embeds = audio_frames(generator, 1, cfg.encoder_seq_len, cfg.d_model)
        if cfg.num_prefix_embeds:
            r.prefix_embeds = vision_embeds(
                generator, 1, cfg.d_model,
                num_tiles=0 if cfg.num_prefix_embeds < 576 else 4,
            )[:, : cfg.num_prefix_embeds]
        reqs.append(r)
    return reqs


def serve(engine: Engine, reqs, metrics_interval: int = 0) -> dict:
    """Submit ``reqs``, run the engine to completion, and return counts
    plus the run's time (``device_s`` from CUDA events on the card,
    ``host_s`` always).  ``metrics_interval`` > 0 prints a metrics line
    every that many iterations."""
    for r in reqs:
        engine.submit(r)
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    if metrics_interval > 0:
        it = 0
        while engine.step():
            it += 1
            if it % metrics_interval == 0:
                snap = engine.obs.metrics.snapshot()
                print(f"[iter {it}] committed={snap['tokens.committed']} "
                      f"running={snap['engine.running']} "
                      f"queued={snap['engine.queued']} "
                      f"rollbacks={snap['verify.rollbacks']} "
                      f"verify_inflight={snap['verify.inflight']}")
            assert it < 100000, "engine did not drain"
        done = engine.finished
    else:
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


def report_outputs(engine: Engine, done, args) -> None:
    """Write the trace, metrics and audit files that ``args`` asks for;
    the trace must pass the schema check and the audit must cover every
    committed token."""
    if args.trace_out:
        from repro_torch.obs import validate_chrome_trace

        trace = engine.obs.tracer.to_chrome_trace()
        errors = validate_chrome_trace(trace)
        assert not errors, f"trace failed schema validation: {errors[:5]}"
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
        print(f"trace: {len(trace['traceEvents'])} events -> {args.trace_out}"
              f" (load in ui.perfetto.dev)")
    if args.metrics_out:
        engine.obs.metrics.dump(args.metrics_out)
        print(f"metrics: {len(engine.obs.metrics.snapshot())} series "
              f"-> {args.metrics_out}")
    if args.audit_out:
        audit = engine.obs.audit
        errors = audit.coverage_errors(done)
        assert not errors, f"audit coverage check failed: {errors[:5]}"
        audit.to_jsonl(args.audit_out)
        print(f"audit: {len(audit.records)} provenance records "
              f"({len(done)} requests, every committed token covered) "
              f"-> {args.audit_out}")


def run_cluster(args, full_cfg, make_engine, reqs) -> None:
    """The multi-replica path: ``args.replicas`` engines behind the
    deterministic router, driven on per-replica costed clocks
    (``cluster.run_online``); prints what ``repro.launch.serve.run_cluster``
    prints, the modeled fleet time on the ``costmodel.H100`` clock."""
    from repro_torch.cluster import Cluster, run_online
    from repro_torch.obs import validate_chrome_trace

    cluster = Cluster(make_engine, args.replicas)
    arrivals = [(i / args.qps) if args.qps > 0 else 0.0 for i in range(len(reqs))]
    t0 = time.perf_counter()
    res = run_online(cluster, full_cfg, list(zip(reqs, arrivals)),
                     invariant_mode=args.mode == "batch_invariant")
    wall = time.perf_counter() - t0
    done = cluster.finished
    print(f"cluster: {args.replicas} replicas, finished {len(done)} "
          f"requests, {res.out_tokens} tokens in {wall:.1f}s wall")
    print(f"modeled H100 fleet time of {full_cfg.name} (cost model, not a "
          f"measurement): {res.total_time * 1e3:.1f} ms -> "
          f"{res.throughput:.0f} tok/s aggregate (goodput @ TTFT<=1s: "
          f"{res.goodput(1.0):.0f} tok/s)")
    rt = cluster.router
    print(f"router: {rt.assignments} assignments, affinity hit rate "
          f"{100 * rt.affinity_hit_rate:.0f}%, {rt.diverted} diverted by load "
          f"guard, {rt.transfers} block transfers ({rt.transferred_tokens} KV "
          f"tokens moved)")
    occ = ", ".join(
        f"r{r.idx}={res.metrics[f'cluster.replica.{r.idx}.occupancy']:.2f}"
        for r in cluster.replicas)
    print(f"final occupancy: {occ}")
    if args.trace_out:
        trace = cluster.chrome_trace()
        errors = validate_chrome_trace(trace)
        assert not errors, f"trace failed schema validation: {errors[:5]}"
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
        print(f"trace: {len(trace['traceEvents'])} events across "
              f"{args.replicas} pids -> {args.trace_out}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions of the kernels)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--det-ratio", type=float, default=0.5)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--mode", default="llm42",
                    choices=["llm42", "nondet", "batch_invariant"])
    ap.add_argument("--workload", default="synthetic",
                    choices=["synthetic", "sharegpt"])
    ap.add_argument("--scheduler", default="default", choices=sorted(SCHEDULERS))
    ap.add_argument("--verify-latency-ms", type=float, default=None,
                    help="run the engine on the costed dual-stream clock "
                         "(modeled H100 time at the full config's scale), "
                         "verdicts landing this many ms after the verify "
                         "stream completes the pass (default: the logical "
                         "clock, one iteration)")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--spec-depth", type=int, default=1)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="tokens per prefill chunk (0 = exclusive prefill)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV block-pool size; default = dense parity.  An "
                         "undersized pool preempts and restores by recompute")
    ap.add_argument("--prefix-cache", default="on", choices=["on", "off"],
                    help="commit-aware radix prefix cache")
    ap.add_argument("--tp", type=int, default=1,
                    help="logical tensor-parallel width of the FAST path: "
                         "decode schedules fold tp K chunks in chunk order "
                         "(must divide the canonical pinned width 4).  The "
                         "commit path replays under the canonical pinned "
                         "tree, so committed streams are the same at any --tp")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the deterministic cluster "
                         "router (they share the params; each owns its pool)")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="replica-mode arrival rate (requests/s of modeled "
                         "time, evenly spaced; 0 = all arrive at t=0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the run")
    ap.add_argument("--metrics-interval", type=int, default=0, metavar="N",
                    help="print a metrics line every N iterations (0 = none)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the final metrics-registry snapshot as JSON")
    ap.add_argument("--audit-out", default=None, metavar="PATH",
                    help="write the per-committed-token audit log as JSONL")
    args = ap.parse_args()

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)
    full_cfg = config_registry.get_config(args.arch)
    cfg = config_registry.get_smoke_config(args.arch) if args.smoke else full_cfg
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"device={device} mode={args.mode} tp={args.tp} n={args.requests} "
          f"det_ratio={args.det_ratio} workload={args.workload}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    sched_cls = SCHEDULERS[args.scheduler]
    hw = costmodel.H100

    def make_engine(idx: int = 0) -> Engine:
        return Engine(
            cfg, params, mode=Mode(args.mode), policy=FAST_PATH_POLICY,
            window=args.window, group=args.group, max_batch=args.max_batch,
            # the prefix embeds take positions before the prompt
            capacity=min(cfg.max_seq_len, 512 + cfg.num_prefix_embeds),
            scheduler=sched_cls() if sched_cls else None,
            spec_depth=args.spec_depth,
            verify_latency_ms=args.verify_latency_ms,
            cost_cfg=full_cfg,  # the clock prices the full model even under --smoke
            hw=hw,
            prefill_chunk=args.prefill_chunk,
            block_size=args.block_size, num_blocks=args.num_blocks,
            prefix_cache=args.prefix_cache == "on",
            trace=args.trace_out is not None,
            audit=args.audit_out is not None,
            tp=args.tp,
        )

    reqs = build_requests(cfg, args.requests, args.det_ratio, args.max_new,
                          args.seed, args.workload, generator=gen)
    if args.replicas > 1:
        run_cluster(args, full_cfg, make_engine, reqs)
        return
    engine = make_engine()
    res = serve(engine, reqs, args.metrics_interval)
    out, done = res["committed"], res["done"]
    print(f"finished {res['finished']} requests, {out} tokens committed in "
          f"{res['iterations']} iterations")
    print(f"rollbacks={res['rollbacks']} recomputed_tokens={res['recomputed']} "
          f"({100.0 * res['recomputed'] / max(out, 1):.2f}%)")
    ms = engine.mem_stats()
    print(f"paged KV: {ms['num_blocks']} blocks x {ms['block_size']} tok, "
          f"peak in use {ms['peak_blocks_in_use']}; preemptions "
          f"{ms['num_preemptions']}, restores {ms['num_restores']} "
          f"({ms['restored_tokens']} tokens recomputed)")
    if engine.prefix_cache is not None:
        hits, misses = ms["prefix_hits"], ms["prefix_misses"]
        print(f"prefix cache: hit rate {100 * hits / max(hits + misses, 1):.0f}% "
              f"({ms['prefix_hit_tokens']} tokens served from cache), "
              f"{ms['prefix_size_blocks']} blocks resident, "
              f"{ms['prefix_evictions']} evicted")
    if res["device_s"] is not None:
        print(f"device time {res['device_s']:.3f} s (CUDA events) -> "
              f"{out / res['device_s']:.1f} committed tok/s on "
              f"{torch.cuda.get_device_name(device)}")
    else:
        print(f"host wall time {res['host_s']:.3f} s on the CPU "
              f"(plain versions of the kernels; not a device time)")
    sim = costmodel.simulate(full_cfg, engine.events, hw,
                             invariant_mode=args.mode == "batch_invariant")
    # a costed engine clock is authoritative (it saw verdict-gated waits
    # that emit no events); the replay is the logical clock's
    total_s = (engine.runtime.makespan if args.verify_latency_ms is not None
               else sim["total_s"])
    prefill_ms = (sim.get("prefill_s", 0) + sim.get("prefill_chunk_s", 0)) * 1e3
    print(f"modeled H100 time of {full_cfg.name} (cost model, not a "
          f"measurement): {total_s * 1e3:.1f} ms -> "
          f"{out / max(total_s, 1e-12):.0f} tok/s (decode "
          f"{sim.get('decode_s', 0) * 1e3:.1f} ms, verify "
          f"{sim.get('verify_s', 0) * 1e3:.1f} ms, prefill {prefill_ms:.1f} ms; "
          f"verify-stream occupancy {100.0 * sim['verify_occupancy']:.0f}%)")
    if args.verify_latency_ms is not None:
        rt = engine.runtime
        print(f"stream clocks: main {rt.main.now * 1e3:.1f} ms, "
              f"verify backlog {rt.verify_backlog * 1e3:.2f} ms, "
              f"makespan {rt.makespan * 1e3:.1f} ms")
    report_outputs(engine, done, args)


if __name__ == "__main__":
    main()
