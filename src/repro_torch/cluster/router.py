"""Deterministic multi-replica front end: router + cluster drive loop.

PyTorch port of ``repro.cluster.router``; the cost model's clock defaults to
``costmodel.H100``, as the port's ``serving.online.run_online`` does, so
latencies, TTFTs and the makespan are modeled seconds.  The reference's
notes follow.

The missing layer between "one deterministic engine" and "millions of
users": N engine replicas behind a router whose request->replica
assignment is a pure function of (arrival order, replica states), so the
same arrival trace produces the same assignment, the same per-replica
schedules, and therefore (by each engine's DVR contract) the same
committed streams, at ANY replica count.  Determinism composes: the
cluster adds no new nondeterminism source because the router consults
nothing outside the simulated state (no wall clock, no hashing of ids, no
randomness).

Routing rule (radix-prefix affinity with a load guard):

1. Probe every replica's radix for the longest whole-block prefix of the
   prompt (``PrefixCache.peek``: non-mutating).
2. Affinity: the replica with the longest match wins (ties: lowest
   index).  A request with no cached prefix anywhere goes to the
   least-loaded replica (ties: lowest index).
3. Load guard: when the affinity replica is overloaded (its load exceeds
   the least-loaded replica's by at least ``imbalance`` requests), the
   request lands on the least-loaded replica instead, and the prefix hit
   is on the *wrong* replica.  Policy ``transfer="copy"`` moves the cached
   blocks device to device (``replica.transfer_prefix``); ``"recompute"``
   moves nothing and lets the target replay the prefill: bitwise the
   same KV by the determinism contract, just a different cost.

Each replica keeps its own ``DualClockRuntime``; the cluster admits an
arrival once the *fleet frontier* (min replica clock) reaches it, steps
every replica with work per iteration, and fast-forwards idle replicas to
the next arrival so the frontier never sticks.  Aggregate goodput comes
off the same cost model the single-engine runner uses.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.cluster.replica import Replica, transfer_prefix
from repro_torch.models.base import ModelConfig
from repro_torch.obs import MetricsRegistry, validate_chrome_trace
from repro_torch.serving import costmodel
from repro_torch.serving.engine import Engine, weak_pull
from repro_torch.serving.request import Request


class Router:
    """Stable request->replica assignment with radix prefix affinity."""

    def __init__(
        self,
        replicas: List[Replica],
        *,
        transfer: str = "copy",  # "copy" | "recompute"
        imbalance: int = 2,  # load-guard threshold (requests)
    ):
        assert transfer in ("copy", "recompute")
        assert imbalance >= 1
        self.replicas = replicas
        self.transfer = transfer
        self.imbalance = imbalance
        # router telemetry (cluster.* metrics read these)
        self.assignments = 0
        self.affinity_hits = 0  # routed to the replica holding the prefix
        self.affinity_misses = 0  # no replica held any prefix
        self.diverted = 0  # prefix existed but load guard diverted
        self.transfers = 0
        self.transferred_tokens = 0

    def route(self, req: Request, now: int) -> Replica:
        """Pick the replica for ``req`` and perform any cross-replica
        prefix transfer the choice implies.  Deterministic: consults only
        replica states, breaks every tie by replica index."""
        scores = [(r.prefix_blocks(req.prompt), r) for r in self.replicas]
        best_blocks, affinity = max(scores, key=lambda s: (s[0], -s[1].idx))
        least = min(self.replicas, key=lambda r: (r.load, r.idx))
        self.assignments += 1

        if best_blocks == 0:
            self.affinity_misses += 1
            return least
        if affinity.load - least.load < self.imbalance or affinity is least:
            self.affinity_hits += 1
            return affinity
        # prefix lives on an overloaded replica: divert to the least-
        # loaded one, carrying (or deterministically recomputing) the KV
        self.diverted += 1
        if self.transfer == "copy":
            moved = transfer_prefix(affinity, least, req.prompt, now)
            if moved:
                self.transfers += 1
                self.transferred_tokens += moved
        return least

    @property
    def affinity_hit_rate(self) -> float:
        return self.affinity_hits / max(self.assignments, 1)


@dataclasses.dataclass
class ClusterResult:
    """Aggregate online-run result (mirrors ``serving.online.OnlineResult``
    plus fleet figures)."""

    latencies: Dict[int, float]  # rid -> end-to-end seconds (sim)
    ttfts: Dict[int, float]  # rid -> time-to-first-token seconds (sim)
    total_time: float  # fleet makespan: max over replica makespans
    out_tokens: int  # committed output tokens, all replicas
    assignment: Dict[int, int]  # rid -> replica idx (the routing record)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    replica_metrics: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )

    @property
    def throughput(self) -> float:
        """Aggregate committed tokens per simulated second."""
        return self.out_tokens / max(self.total_time, 1e-12)

    def goodput(self, slo_ttft_s: float) -> float:
        """Committed tokens/s from requests whose TTFT met the SLO — the
        fleet headline: adding replicas must grow *this*, not just raw
        throughput with queued-to-death stragglers."""
        good = sum(
            1 for rid, t in self.ttfts.items() if t <= slo_ttft_s
        )
        frac = good / max(len(self.ttfts), 1)
        return self.throughput * frac


class Cluster:
    """N engine replicas behind a deterministic router.

    ``make_engine(idx)`` must build identically configured engines — the
    replica index is for observability (per-replica trace pid), not for
    configuration divergence, which would break cross-replica-count
    determinism.
    """

    def __init__(
        self,
        make_engine: Callable[[int], Engine],
        n_replicas: int,
        *,
        transfer: str = "copy",
        imbalance: int = 2,
    ):
        assert n_replicas >= 1
        self.replicas = [
            Replica(i, make_engine(i)) for i in range(n_replicas)
        ]
        self.router = Router(
            self.replicas, transfer=transfer, imbalance=imbalance
        )
        self.metrics = MetricsRegistry()
        self._register_metrics()

    # -- observability ---------------------------------------------------

    def _register_metrics(self) -> None:
        m = self.metrics
        # through a weak reference: the registry is the cluster's own
        pull = functools.partial(weak_pull, self)
        m.gauge_fn("cluster.replicas", pull(lambda c: len(c.replicas)),
                   unit="replicas", help="engine replicas behind the router")
        m.gauge_fn("cluster.router.assignments",
                   pull(lambda c: c.router.assignments),
                   unit="requests", help="routing decisions made")
        m.gauge_fn("cluster.router.affinity_hits",
                   pull(lambda c: c.router.affinity_hits),
                   unit="requests",
                   help="requests routed to the replica holding their prefix")
        m.gauge_fn("cluster.router.affinity_misses",
                   pull(lambda c: c.router.affinity_misses),
                   unit="requests", help="requests with no cached prefix")
        m.gauge_fn("cluster.router.affinity_hit_rate",
                   pull(lambda c: c.router.affinity_hit_rate),
                   unit="fraction", help="affinity hits over assignments")
        m.gauge_fn("cluster.router.diverted",
                   pull(lambda c: c.router.diverted),
                   unit="requests",
                   help="prefix hits diverted by the load guard")
        m.gauge_fn("cluster.router.transfers",
                   pull(lambda c: c.router.transfers),
                   unit="transfers", help="cross-replica block transfers")
        m.gauge_fn("cluster.router.transferred_tokens",
                   pull(lambda c: c.router.transferred_tokens),
                   unit="tokens", help="KV tokens moved between replicas")
        for rep in self.replicas:
            # close over the loop variable via default arg
            m.gauge_fn(
                f"cluster.replica.{rep.idx}.occupancy",
                lambda r=rep: r.occupancy,
                unit="fraction", help="running requests over slot capacity")
            m.gauge_fn(
                f"cluster.replica.{rep.idx}.load",
                lambda r=rep: r.load,
                unit="requests", help="running + queued + preempted")
            m.gauge_fn(
                f"cluster.replica.{rep.idx}.transfers_in",
                lambda r=rep: r.transfers_in,
                unit="transfers", help="prefix transfers received")

    def chrome_trace(self) -> Dict[str, Any]:
        """One merged Chrome trace, each replica under its own pid —
        Perfetto renders the fleet as side-by-side processes."""
        events: List[Dict[str, Any]] = []
        for rep in self.replicas:
            sub = rep.engine.obs.tracer.to_chrome_trace(
                pid=rep.idx, process_name=f"llm42-replica-{rep.idx}"
            )
            events.extend(sub["traceEvents"])
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        problems = validate_chrome_trace(trace)
        assert not problems, f"invalid merged cluster trace: {problems}"
        return trace

    # -- aggregate state -------------------------------------------------

    def drained(self) -> bool:
        return not any(r.has_work() for r in self.replicas)

    @property
    def finished(self) -> List[Request]:
        out: List[Request] = []
        for r in self.replicas:
            out.extend(r.engine.finished)
        return out


def run_online(
    cluster: Cluster,
    cost_cfg: ModelConfig,
    requests: List[Tuple[Request, float]],  # (request, arrival_time_s)
    *,
    hw: costmodel.Hardware = costmodel.H100,
    invariant_mode: bool = False,
    max_iters: int = 200000,
    on_exhaust: str = "raise",  # "raise" | "warn"
) -> ClusterResult:
    """Cluster analogue of ``serving.online.run_online``: drive every
    replica's costed dual-clock runtime against one arrival trace.

    An arrival is admitted (routed + submitted) once the fleet frontier —
    the minimum replica clock — reaches it; replicas then step
    independently, verify streams and all, and idle replicas fast-forward
    to the next arrival so the frontier keeps moving.  ``total_time`` is
    the fleet makespan (max replica clock at drain).
    """
    assert on_exhaust in ("raise", "warn")
    reps = cluster.replicas
    for rep in reps:
        rep.engine.bind_cost_model(cost_cfg, hw, invariant=invariant_mode)
    pending = sorted(requests, key=lambda p: p[1])
    arrival: Dict[int, float] = {}
    ttft: Dict[int, float] = {}
    latency: Dict[int, float] = {}
    assignment: Dict[int, int] = {}
    home: Dict[int, Replica] = {}

    def frontier() -> float:
        return min(r.engine.runtime.now for r in reps)

    def admit() -> None:
        while pending and pending[0][1] <= frontier():
            req, t = pending.pop(0)
            arrival[req.rid] = t
            target = cluster.router.route(req, now=int(t * 1e6))
            assignment[req.rid] = target.idx
            home[req.rid] = target
            target.engine.submit(req)

    for _ in range(max_iters):
        admit()
        if not pending and cluster.drained():
            break
        next_arrival: Optional[float] = pending[0][1] if pending else None
        progressed = False
        for rep in reps:
            if not rep.has_work():
                continue
            rep.engine.runtime.skip_horizon = next_arrival
            stepped = rep.engine.step()
            progressed = progressed or stepped
            clock = rep.engine.runtime.now
            for r in rep.engine.running:
                if r.rid not in ttft and r.committed:
                    ttft[r.rid] = clock - arrival[r.rid]
            for r in rep.engine.finished:
                if r.rid not in latency:
                    latency[r.rid] = clock - arrival[r.rid]
                    ttft.setdefault(r.rid, clock - arrival[r.rid])
        if next_arrival is not None:
            # idle replicas wait for traffic; a fully stalled fleet
            # (verdict-gated everywhere) waits out the next arrival too
            for rep in reps:
                if not rep.has_work() or not progressed:
                    rep.engine.runtime.idle_until(next_arrival)

    if pending or not cluster.drained():
        busy = sum(r.load for r in reps)
        msg = (
            f"cluster run_online exhausted max_iters={max_iters} before "
            f"draining: {busy} requests in flight across "
            f"{len(reps)} replicas, {len(pending)} not yet arrived; "
            f"latency/TTFT dicts would be partial "
            f"({len(latency)}/{len(requests)} finished)"
        )
        if on_exhaust == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)

    # drain bookkeeping against each request's OWN replica clock
    for rid, rep in home.items():
        clock = rep.engine.runtime.now
        for r in rep.engine.finished:
            if r.rid == rid:
                latency.setdefault(rid, clock - arrival[rid])
                ttft.setdefault(rid, clock - arrival[rid])

    out_tokens = sum(r.num_output for r in cluster.finished)
    makespan = max(r.engine.runtime.makespan for r in reps)
    return ClusterResult(
        latencies=latency,
        ttfts=ttft,
        total_time=makespan,
        out_tokens=out_tokens,
        assignment=assignment,
        metrics=cluster.metrics.snapshot(),
        replica_metrics=[
            r.engine.obs.metrics.snapshot() for r in reps
        ],
    )
