"""Online-inference runner: Poisson arrivals against the engine's stream clocks.

PyTorch port of ``repro.serving.online``.  The clock is the cost model's
(``serving.costmodel``): on the port it defaults to ``costmodel.H100``, a
device model, so latencies and TTFTs are modeled seconds, not measured
ones.  The reference's notes follow.

Drives the real engine (real scheduling, real rollbacks) in costed-clock
mode: ``Engine.bind_cost_model`` switches the dual-stream runtime
(``serving.streams``) to continuous device time, so the discrete-event
clock IS the engine's main-stream clock — decode/prefill passes advance
it serially, deferred verification queues on the verify stream and only
slows the main stream by the modeled cross-stream contention, and verify
tails longer than their launch iteration spill into the verify stream's
backlog instead of blocking anything.  Produces per-request end-to-end
latency and TTFT (paper Fig. 11 / Table 5).

Exhausting ``max_iters`` before the workload drains raises (it used to
fall out of the loop and silently return truncated latency/TTFT dicts —
quietly partial benchmark numbers); pass ``on_exhaust="warn"`` to instead
keep the partial result and get a warning with the unfinished counts.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Tuple

from repro_torch.models.base import ModelConfig
from repro_torch.serving import costmodel
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request


@dataclasses.dataclass
class OnlineResult:
    latencies: Dict[int, float]  # rid -> end-to-end seconds (modeled)
    ttfts: Dict[int, float]  # rid -> time-to-first-token seconds (modeled)
    total_time: float
    out_tokens: int
    #: final ``engine.obs.metrics.snapshot()`` — the registry view of the
    #: run (stream occupancy, rollback depth distribution, TTFT/TPOT
    #: percentiles on the sim clock, block-pool/prefix-cache state)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)


def run_online(
    engine: Engine,
    cost_cfg: ModelConfig,
    requests: List[Tuple[Request, float]],  # (request, arrival_time_s)
    *,
    hw: costmodel.Hardware = costmodel.H100,
    invariant_mode: bool = False,
    max_iters: int = 200000,
    on_exhaust: str = "raise",  # "raise" | "warn"
) -> OnlineResult:
    assert on_exhaust in ("raise", "warn")
    engine.bind_cost_model(cost_cfg, hw, invariant=invariant_mode)
    pending = sorted(requests, key=lambda p: p[1])
    arrival: Dict[int, float] = {}
    ttft: Dict[int, float] = {}
    latency: Dict[int, float] = {}

    def admit():
        nonlocal pending
        while pending and pending[0][1] <= engine.runtime.now:
            req, t = pending.pop(0)
            arrival[req.rid] = t
            engine.submit(req)

    for _ in range(max_iters):
        admit()
        if not pending and not engine.running and not engine.queue and (
            not engine.preempted
        ):
            break
        # the runtime's event-driven skip (verdict-gated idle iterations)
        # must never jump past the next arrival — the main stream is free
        # to admit and prefill it the moment it lands
        engine.runtime.skip_horizon = pending[0][1] if pending else None
        progressed = engine.step()
        clock = engine.runtime.now
        # first token timestamps (prefill commits T0 synchronously)
        for r in engine.running:
            if r.rid not in ttft and r.committed:
                ttft[r.rid] = clock - arrival[r.rid]
        for r in engine.finished:
            if r.rid not in latency:
                latency[r.rid] = clock - arrival[r.rid]
                ttft.setdefault(r.rid, clock - arrival[r.rid])
        if not progressed and pending:
            engine.runtime.idle_until(pending[0][1])  # idle until next arrival
    # re-check after the loop: a workload that drains on exactly the last
    # permitted step is complete, not truncated
    if pending or engine.running or engine.queue or engine.preempted:
        msg = (
            f"run_online exhausted max_iters={max_iters} before draining: "
            f"{len(engine.running)} running, {len(engine.queue)} queued, "
            f"{len(engine.preempted)} preempted awaiting restore, "
            f"{len(pending)} not yet arrived; latency/TTFT dicts would be "
            f"partial ({len(latency)}/{len(requests)} finished)"
        )
        if on_exhaust == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    clock = engine.runtime.now
    # drain bookkeeping for anything that finished on the last step
    for r in engine.finished:
        latency.setdefault(r.rid, clock - arrival[r.rid])
        ttft.setdefault(r.rid, clock - arrival[r.rid])

    out_tokens = sum(r.num_output for r in engine.finished)
    return OnlineResult(
        latency, ttft, clock, out_tokens, engine.obs.metrics.snapshot()
    )


def percentile(values: List[float], p: float) -> float:
    if not values:
        return float("nan")
    vs = sorted(values)
    idx = min(int(p / 100.0 * len(vs)), len(vs) - 1)
    return vs[idx]
