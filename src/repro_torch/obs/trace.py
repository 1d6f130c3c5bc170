"""Dual-stream request tracing with Chrome/Perfetto trace-event export.

Spans are recorded against the engine's :class:`DualClockRuntime` timeline
— the same clock that decides verdict deadlines — so a trace shows exactly
what the scheduler saw: decode/prefill passes on the **main** stream row,
deferred verification on the **verify** stream row (queueing, backlog and
all), protocol instants (window submit, commit, rollback, preempt,
restore) on a third row, and one async track per request spanning
submit → retire.

Two timing modes, matching the runtime's:

* **costed clock** — every pass has real ``(start, finish)`` stream times
  (``ExecStream.launch``); the runtime stashes the last span per stream
  (``last_main_span`` / ``last_verify_span``) and the engine hands it to
  :meth:`Tracer.pass_span` verbatim.
* **logical clock** — passes have no duration (the clock ticks once per
  iteration), so ``pass_span`` receives ``span=None`` and the tracer
  defers layout: at :meth:`end_iteration` the iteration's pending passes
  are laid out sequentially across the iteration window ``[t0, t1]``.
  Relative widths are synthetic; ordering, stream attribution and nesting
  are real.

A fused mixed-batch launch (``Engine._fused_step``) renders as ONE parent
``fused_step`` slice on the main row with its sub-passes nested inside:
the engine brackets the sub-pass bookkeeping with ``begin_group`` /
``end_group`` and the tracer emits a parent span covering the min/max
envelope of the group's children.

Export is the Chrome trace-event JSON format (the ``traceEvents`` array
form) — loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``:

* ``"ph": "X"`` complete slices for passes (``ts``/``dur`` in µs),
* ``"ph": "i"`` instants for protocol events,
* ``"ph": "b"``/``"e"`` async begin/end per request lifecycle,
* ``"ph": "M"`` metadata naming the process and the stream rows.

:func:`validate_chrome_trace` is the schema gate CI runs on every exported
trace: required fields per phase type, non-negative µs clocks, per-row
monotonicity, and proper slice nesting (no partial overlap within a row).

The tracer is host-side bookkeeping only — it never changes what the
engine launches, so committed streams are bitwise identical with tracing
on or off (``tests/test_obs.py`` proves it property-style).  When tracing
is off the engine holds a :class:`NullTracer` whose methods are no-ops
behind a single ``enabled`` flag check.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: thread-id (row) assignment: one process, three fixed rows + per-request
#: async tracks (async events carry their own ids, not tids)
TID_MAIN = 0
TID_VERIFY = 1
TID_PROTOCOL = 2

_TID_FOR_STREAM = {"main": TID_MAIN, "verify": TID_VERIFY,
                   "protocol": TID_PROTOCOL}
_THREAD_NAMES = {TID_MAIN: "main stream", TID_VERIFY: "verify stream",
                 TID_PROTOCOL: "protocol"}

_US = 1e6  # stream-clock seconds/ticks -> trace microseconds


class NullTracer:
    """No-op recorder: one attribute read per call site, zero allocation."""

    enabled = False

    def begin_iteration(self, it: int, t0: float) -> None:
        pass

    def end_iteration(self, t1: float) -> None:
        pass

    def pass_span(self, stream: str, name: str,
                  span: Optional[Tuple[float, float]],
                  args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def instant(self, name: str, t: float, stream: str = "protocol",
                **args: Any) -> None:
        pass

    def request_begin(self, rid: int, t: float) -> None:
        pass

    def request_end(self, rid: int, t: float) -> None:
        pass

    def begin_group(self, name: str, **args: Any) -> None:
        pass

    def end_group(self) -> None:
        pass

    def to_chrome_trace(
        self, pid: int = 0, process_name: str = "llm42-engine"
    ) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


class Tracer(NullTracer):
    enabled = True

    def __init__(self) -> None:
        #: finished slices: (name, tid, start, end, args)
        self._spans: List[Tuple[str, int, float, float, Dict[str, Any]]] = []
        #: instants: (name, tid, t, args)
        self._instants: List[Tuple[str, int, float, Dict[str, Any]]] = []
        #: async request events: (ph, rid, t)
        self._asyncs: List[Tuple[str, int, float]] = []
        #: passes awaiting layout: (stream, name, span|None, args, group_id)
        self._pending: List[Tuple[str, str, Optional[Tuple[float, float]],
                                  Dict[str, Any], int]] = []
        self._groups: Dict[int, Tuple[str, Dict[str, Any]]] = {}
        self._group_id = 0
        self._open_group: Optional[int] = None
        self._t0 = 0.0
        self._it = 0

    # -- iteration protocol --------------------------------------------

    def begin_iteration(self, it: int, t0: float) -> None:
        self._it = it
        self._t0 = float(t0)

    def end_iteration(self, t1: float) -> None:
        """Lay out the iteration's pending passes.  Spans that arrived
        with explicit stream times pass through; logical-clock spans
        (``span=None``) divide the iteration window ``[t0, t1]`` equally,
        in record order."""
        self._flush(float(t1))

    def _flush(self, t1: float) -> None:
        if not self._pending:
            return
        t0 = self._t0
        if t1 <= t0:
            t1 = t0 + 1.0  # degenerate window (drained-engine tail flush)
        n_synth = sum(1 for p in self._pending if p[2] is None)
        w = (t1 - t0) / max(n_synth, 1)
        cursor = t0
        placed: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
        for stream, name, span, args, gid in self._pending:
            if span is None:
                span = (cursor, cursor + w)
                cursor += w
            start, end = float(span[0]), float(span[1])
            end = max(end, start)  # zero-width passes still render
            tid = _TID_FOR_STREAM[stream]
            self._spans.append((name, tid, start, end, args))
            if gid >= 0:
                placed.setdefault((gid, tid), []).append((start, end))
        self._pending.clear()
        # fused groups: one parent slice nesting the group's sub-passes
        # (the "one launch with nested sub-pass slices" rendering).  The
        # parent lives on the main row and covers only main-row members —
        # verify sub-passes keep their stream-truthful verify-row slices
        # (they may drain past the iteration, and a cross-row envelope
        # would partially overlap the next iteration's main work).  A
        # verify-only fused launch parents on the verify row instead.
        for gid, (gname, gargs) in sorted(self._groups.items()):
            members = placed.get((gid, TID_MAIN))
            tid = TID_MAIN
            if not members:
                members = placed.get((gid, TID_VERIFY))
                tid = TID_VERIFY
            if not members:
                continue
            start = min(s for s, _ in members)
            end = max(e for _, e in members)
            self._spans.append((gname, tid, start, end, gargs))
        self._groups.clear()

    # -- recording ------------------------------------------------------

    def pass_span(self, stream: str, name: str,
                  span: Optional[Tuple[float, float]],
                  args: Optional[Dict[str, Any]] = None) -> None:
        """One device pass on ``stream`` ("main"/"verify").  ``span`` is
        the runtime's ``(start, finish)`` stream time, or None under the
        logical clock (laid out at ``end_iteration``)."""
        a = dict(args or {})
        a.setdefault("iter", self._it)
        gid = self._open_group if self._open_group is not None else -1
        self._pending.append((stream, name, span, a, gid))

    def instant(self, name: str, t: float, stream: str = "protocol",
                **args: Any) -> None:
        args.setdefault("iter", self._it)
        self._instants.append((name, _TID_FOR_STREAM[stream], float(t), args))

    def request_begin(self, rid: int, t: float) -> None:
        self._asyncs.append(("b", rid, float(t)))

    def request_end(self, rid: int, t: float) -> None:
        self._asyncs.append(("e", rid, float(t)))

    def begin_group(self, name: str, **args: Any) -> None:
        """Open a fused-launch group: subsequent ``pass_span`` calls nest
        under one parent slice until ``end_group``."""
        args.setdefault("iter", self._it)
        self._group_id += 1
        self._groups[self._group_id] = (name, args)
        self._open_group = self._group_id

    def end_group(self) -> None:
        self._open_group = None

    # -- export ---------------------------------------------------------

    def to_chrome_trace(
        self, pid: int = 0, process_name: str = "llm42-engine"
    ) -> Dict[str, Any]:
        """Chrome trace-event JSON (``traceEvents`` array form).

        ``pid``/``process_name`` namespace this tracer's rows: the cluster
        front end exports each replica under its own pid, so Perfetto
        shows the fleet side by side as separate processes
        (``Cluster.chrome_trace`` merges the per-replica arrays; the
        validator keys rows on (pid, tid), so a merged trace validates).
        """
        self._flush(self._t0 + 1.0)  # leftovers from a final partial iter
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": process_name}},
        ]
        for tid, tname in _THREAD_NAMES.items():
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name", "args": {"name": tname}})
        # complete slices, per-row (ts, -dur) order => parents precede
        # children at equal boundaries, rows are monotone
        for name, tid, start, end, args in sorted(
            self._spans, key=lambda s: (s[1], s[2], -(s[3] - s[2]))
        ):
            # dur from the ROUNDED endpoints: adjacent slices then abut
            # exactly instead of drifting apart by float error
            ts = round(start * _US, 3)
            events.append({
                "ph": "X", "pid": pid, "tid": tid, "name": name,
                "cat": "pass", "ts": ts,
                "dur": round(round(end * _US, 3) - ts, 3),
                "args": args,
            })
        for name, tid, t, args in sorted(self._instants, key=lambda i: i[2]):
            events.append({
                "ph": "i", "pid": pid, "tid": tid, "name": name,
                "cat": "protocol", "s": "t", "ts": round(t * _US, 3),
                "args": args,
            })
        for ph, rid, t in sorted(self._asyncs, key=lambda a: (a[2], a[0])):
            events.append({
                "ph": ph, "pid": pid, "tid": TID_PROTOCOL,
                "name": f"request {rid}", "cat": "request", "id": str(rid),
                "ts": round(t * _US, 3),
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Schema-check an exported trace; returns problems (empty = valid).

    Enforces what Perfetto's importer needs: the ``traceEvents`` container,
    required fields per phase, non-negative µs clocks, per-(pid, tid)
    monotone ``X`` starts, matched async begin/end per id, and proper
    nesting — two slices on one row either disjoint or contained, never
    partially overlapping."""
    errs: List[str] = []
    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ):
        return ["top level must be an object with a 'traceEvents' list"]
    by_row: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    async_depth: Dict[str, int] = {}
    for i, ev in enumerate(trace["traceEvents"]):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "b", "e", "M", "C"):
            errs.append(f"{where}: unknown phase {ph!r}")
            continue
        for field in ("pid", "name"):
            if field not in ev:
                errs.append(f"{where} (ph={ph}): missing {field!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where} (ph={ph}): ts must be a non-negative "
                        f"number of microseconds, got {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X event needs dur >= 0, got {dur!r}")
                continue
            if "tid" not in ev:
                errs.append(f"{where}: X event missing tid")
                continue
            by_row.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ts), float(ts) + float(dur), ev.get("name", "?"))
            )
        elif ph == "i":
            if ev.get("s", "t") not in ("t", "p", "g"):
                errs.append(f"{where}: instant scope must be t/p/g")
        elif ph in ("b", "e"):
            if "id" not in ev or "cat" not in ev:
                errs.append(f"{where}: async {ph} event needs id and cat")
                continue
            d = async_depth.get(str(ev["id"]), 0) + (1 if ph == "b" else -1)
            async_depth[str(ev["id"])] = d
            if d < 0:
                errs.append(f"{where}: async end before begin for "
                            f"id {ev['id']!r}")
    for aid, d in async_depth.items():
        if d > 0:
            errs.append(f"async id {aid!r}: {d} begin(s) without end")
    eps = 1e-6  # sub-nanosecond slack for float error in ts + dur sums
    for (pid, tid), rows in by_row.items():
        last_start = -1.0
        for start, _, name in rows:
            if start < last_start - eps:
                errs.append(
                    f"row (pid={pid}, tid={tid}): X events not sorted by ts "
                    f"at slice {name!r}"
                )
                break
            last_start = start
        stack: List[Tuple[float, float, str]] = []
        for start, end, name in rows:
            while stack and start >= stack[-1][1] - eps:
                stack.pop()
            if stack and end > stack[-1][1] + eps:
                errs.append(
                    f"row (pid={pid}, tid={tid}): slice {name!r} "
                    f"[{start}, {end}) partially overlaps enclosing "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, {stack[-1][1]})"
                )
                break
            stack.append((start, end, name))
    return errs
