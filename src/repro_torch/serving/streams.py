"""Event-driven execution streams: the engine's dual-clock runtime.

The paper's verify-rollback loop is asynchronous in spirit — verification
runs *beside* decoding, not inside it — but the engine originally modeled
that with a single lock-step integer iteration counter and a fixed
``verify_latency`` iteration count.  That is too coarse to study deeper
pipelining (ROADMAP): a verify pass that takes 1.7 decode-iterations of
device time either rounds to 1 or to 2, verify passes can never queue
behind each other, and the cost model had to approximate concurrency with
a composite per-iteration "overlap" formula.

This module replaces the time model with *execution streams*, the same
abstraction accelerators expose (CUDA/TPU streams): an :class:`ExecStream`
is an in-order work queue with its own continuous clock; concurrency
between streams is real (each stream has its own frontier), while work
within a stream serializes.  The engine composes two of them in a
:class:`DualClockRuntime`:

* the **main** stream runs everything the scheduler plans on the fast
  path — decode batches and prefill chunks (serial within an iteration:
  they are separate kernel launches on one stream);
* the **verify** stream runs deferred verification passes.  A launch
  starts no earlier than its launch iteration and no earlier than the
  previous verify pass's completion (passes queue — genuine stream
  occupancy), and its verdict becomes visible ``extra latency`` seconds
  after the pass completes.

Cross-stream interference is modeled with a single contention coefficient:
the portion of a verify pass that overlaps the launching iteration's
main-stream work slows the main stream by ``contention * overlap`` (both
streams share HBM).  ``contention = 0`` is an ideal dual-issue machine;
``contention = 1`` degenerates to serial execution.

Determinism note: stream timing decides only *when* verdicts land, never
what they say — the committed stream of a deterministic request is the
verifier's reference sequence by construction, so it is bitwise identical
across clock modes, verify latencies, and verdict landing orders
(``tests/test_scheduler.py::TestVerdictOrdering`` asserts the out-of-order
case explicitly via ``latency_schedule``).

Two clock modes:

* **logical** (``cost_fn is None``) — the engine's default clock: every
  iteration advances the main clock by exactly 1.0 and a verify launch
  is ready ``latency`` ticks later (the engine passes 1 — a verdict
  lands the iteration after its launch).
* **costed** (``cost_fn`` given) — clocks advance by modeled device
  seconds (``serving.costmodel.step_time``); verify passes have real
  durations, queue on their stream, and land ``latency`` *seconds* after
  completion (``--verify-latency-ms``).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """A deadline in stream time.  Ordered by (time, seq): two events due
    at the same instant resolve in push order — deterministic tie-break."""

    time: float
    seq: int
    kind: str
    payload: Any = None


class EventQueue:
    """Min-heap of :class:`StreamEvent` deadlines."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, StreamEvent]] = []
        self._seq = 0

    def push(self, time: float, kind: str, payload: Any = None) -> StreamEvent:
        ev = StreamEvent(time=time, seq=self._seq, kind=kind, payload=payload)
        heapq.heappush(self._heap, (time, self._seq, ev))
        self._seq += 1
        return ev

    def pop_due(self, now: float) -> List[StreamEvent]:
        """All events with ``time <= now``, in (time, push-order) order."""
        out: List[StreamEvent] = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)


class ExecStream:
    """An in-order execution stream with a continuous clock.

    ``now`` is the stream's frontier: the time through which work has been
    scheduled.  ``launch`` appends work (start = max(frontier, not_before)),
    ``wait`` stalls the frontier without accruing busy time.  ``busy``
    accumulates only launched work, so ``occupancy(horizon)`` is the
    utilization telemetry the scheduler reads.
    """

    def __init__(self, name: str, start: float = 0.0) -> None:
        self.name = name
        self.now = float(start)
        self.busy = 0.0

    def launch(self, duration: float, *, not_before: float = 0.0) -> Tuple[float, float]:
        """Queue ``duration`` seconds of work; returns (start, finish)."""
        assert duration >= 0.0, "a pass cannot take negative time"
        start = max(self.now, not_before)
        finish = start + duration
        self.now = finish
        self.busy += duration
        return start, finish

    def wait(self, t: float) -> None:
        """Stall (idle) until ``t``; no-op if the frontier is already past."""
        self.now = max(self.now, t)

    def advance(self, dt: float) -> None:
        """Push the frontier forward by ``dt`` without accruing busy time
        (contention slip, logical ticks)."""
        assert dt >= 0.0
        self.now += dt

    def occupancy(self, horizon: float) -> float:
        """Fraction of ``horizon`` this stream spent executing work."""
        return self.busy / horizon if horizon > 0 else 0.0


class DualClockRuntime:
    """Main + verify execution streams + the verdict deadline queue.

    One engine iteration brackets as::

        now = rt.begin_iteration()      # land verdicts with ready <= now
        rt.charge(decode_event)         # main-stream passes, serial
        rt.charge(prefill_event)
        ready = rt.launch_verify(ev)    # verify-stream pass -> verdict time
        rt.end_iteration()              # event-driven skip when main idled

    ``cost_fn`` maps an engine event dict to modeled device seconds; when
    ``None`` the runtime runs the logical (iteration-count) shim.
    ``latency`` is the extra delay between a verify pass completing and its
    verdict becoming visible — iterations in logical mode, seconds in
    costed mode.  ``latency_schedule`` (when set) overrides ``latency``
    per launch, in launch order — a test hook for out-of-order verdict
    landings; entries past the schedule fall back to ``latency``.
    """

    def __init__(
        self,
        cost_fn: Optional[Callable[[Dict[str, Any]], float]] = None,
        *,
        latency: float = 1.0,
        contention: float = 0.0,
    ) -> None:
        assert latency >= 0.0, "a verdict cannot land before its launch"
        assert 0.0 <= contention <= 1.0
        self.cost_fn = cost_fn
        self.latency = float(latency)
        self.contention = float(contention)
        self.main = ExecStream("main")
        self.verify = ExecStream("verify")
        self.verdicts = EventQueue()
        self.latency_schedule: Optional[List[float]] = None
        #: earliest external event (e.g. the online runner's next request
        #: arrival): the event-driven skip never jumps past it, so an
        #: arrival during a verdict-gated idle window is admitted at its
        #: arrival time, not at the verdict deadline
        self.skip_horizon: Optional[float] = None
        #: deepest verdict queue seen (verdicts launched, not yet due):
        #: with multi-window pipelining (Engine spec_depth > 1) several
        #: verdicts per request can be airborne — this is the occupancy
        #: telemetry benchmarks report alongside verify-stream busy time
        self.peak_outstanding = 0
        #: (start, finish) of the most recent costed launch on each stream
        #: — the tracer reads these right after ``charge`` /
        #: ``launch_verify`` to place the pass's slice on the timeline.
        #: None under the logical clock (passes there have no extent; the
        #: tracer synthesizes a layout inside the iteration window instead)
        self.last_main_span: Optional[Tuple[float, float]] = None
        self.last_verify_span: Optional[Tuple[float, float]] = None
        self._n_launches = 0
        self._t0 = 0.0
        self._did_main_work = False

    # ------------------------------------------------------------------

    @property
    def logical(self) -> bool:
        return self.cost_fn is None

    @property
    def now(self) -> float:
        """The main-stream clock — 'the present' from the scheduler's view."""
        return self.main.now

    @property
    def makespan(self) -> float:
        """Time at which ALL scheduled work (both streams) has completed."""
        return max(self.main.now, self.verify.now)

    @property
    def verify_backlog(self) -> float:
        """Seconds of verify-stream work scheduled past the present — how
        far behind the verify stream is running (0 when caught up)."""
        return max(0.0, self.verify.now - self.main.now)

    @property
    def outstanding_verdicts(self) -> int:
        """Verdicts launched but not yet due (the in-flight window count
        as the streams see it)."""
        return len(self.verdicts)

    def _latency_for_launch(self) -> float:
        i = self._n_launches
        self._n_launches += 1
        if self.latency_schedule is not None and i < len(self.latency_schedule):
            return float(self.latency_schedule[i])
        return self.latency

    # ------------------------------------------------------------------
    # iteration protocol
    # ------------------------------------------------------------------

    def begin_iteration(self) -> float:
        """Start an iteration; returns the clock against which verdict
        deadlines are checked (``ready_at <= now`` lands)."""
        if self.logical:
            self.main.advance(1.0)
        self._t0 = self.main.now
        self._did_main_work = False
        # drain deadlines that have come due; application itself is the
        # engine's job (per-request ``InflightVerify.ready_at`` check)
        self.verdicts.pop_due(self.main.now)
        return self.main.now

    def charge(self, ev: Dict[str, Any]) -> float:
        """Charge one main-stream pass (decode / prefill); returns its
        modeled duration.  Passes within an iteration serialize — they are
        separate kernel launches on one stream."""
        self._did_main_work = True
        if self.logical:
            self.last_main_span = None
            return 0.0
        dur = self.cost_fn(ev)
        self.last_main_span = self.main.launch(dur)
        return dur

    def launch_verify(self, ev: Dict[str, Any], *, sync: bool = False) -> float:
        """Launch a verification pass; returns its verdict-ready time.

        Deferred (``sync=False``): the pass queues on the verify stream
        (start = max(iteration start, previous pass's completion)) and the
        verdict is visible ``latency`` after completion.  The overlap with
        this iteration's main-stream work costs ``contention * overlap`` of
        main-stream slip.  Sync (``sync=True``, pause-style): the pass
        blocks the main stream for its full duration — the verdict applies
        inside the iteration, so the returned time is just 'now'.
        """
        lat = self._latency_for_launch()
        if self.logical:
            self.last_verify_span = None
            if sync:
                self._did_main_work = True
                return self.main.now
            ready = self.main.now + lat
            self.verdicts.push(ready, "verdict", ev)
            self.peak_outstanding = max(self.peak_outstanding, len(self.verdicts))
            return ready
        dur = self.cost_fn(ev)
        if sync:
            # exclusive: everything waits on the pass (and on any verify
            # work still draining); busy time accrues to the verify stream
            # so occupancy telemetry sees sync and deferred passes alike
            start, finish = self.verify.launch(dur, not_before=self.main.now)
            self.last_verify_span = (start, finish)
            self.main.wait(finish)
            self._did_main_work = True
            return self.main.now
        start, finish = self.verify.launch(dur, not_before=self._t0)
        self.last_verify_span = (start, finish)
        overlap = max(0.0, min(self.main.now, finish) - max(self._t0, start))
        self.main.advance(self.contention * overlap)
        ready = finish + lat
        self.verdicts.push(ready, "verdict", ev)
        self.peak_outstanding = max(self.peak_outstanding, len(self.verdicts))
        return ready

    def end_iteration(self) -> None:
        """Close the iteration.  Event-driven skip: an iteration that did
        no main-stream work (everything gated on in-flight verdicts) waits
        for the earliest pending deadline instead of spinning — this is
        what makes the continuous clock terminate where the old integer
        counter relied on +1 per iteration."""
        if self.logical or self._did_main_work:
            return
        t = self.verdicts.peek_time()
        if t is None or t <= self.main.now:
            return
        if self.skip_horizon is not None and self.skip_horizon > self.main.now:
            t = min(t, self.skip_horizon)
        self.main.wait(t)

    def idle_until(self, t: float) -> None:
        """Idle the main stream until ``t`` (online runner: no work until
        the next arrival)."""
        self.main.wait(t)
