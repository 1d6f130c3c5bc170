"""Scheduler subsystem: per-iteration verify/decode co-scheduling policies.

The paper's prototype pauses *all* decoding whenever a verification pass
runs (§5.2 limitation (1)) — a handful of deterministic requests stalls the
whole non-deterministic fast path.  This module makes that choice pluggable:

* ``PauseDecodePolicy`` — the prototype's behaviour, verbatim: an iteration
  is either one verify pass or one decode batch, never both.  Kept as the
  reference policy (and for A/B ablation in ``benchmarks/fig_overlap.py``).
* ``OverlapPolicy``      — the default for ``Mode.LLM42``: a verify group is
  launched *alongside* the same iteration's decode batch.  Non-deterministic
  requests never idle behind verification, and a deterministic request
  keeps speculating past windows already in flight — and keeps *launching*
  further windows, up to the engine's ``spec_depth`` pipelining bound
  (``SchedulerView.spec_depth``) — ``core.pipeline`` owns the in-order
  splice / cascade-rollback bookkeeping, ``serving.statepool`` the device
  state checkpoints that make the depth safe on recurrent archs.

Prefill is the third lane (§5.2 limitation (2)): when the engine runs with
``prefill_chunk > 0``, admitted requests enter ``State.PREFILLING`` and
advance one fixed-shape chunk per iteration instead of one exclusive
whole-prompt pass at admission.  ``OverlapPolicy`` co-schedules one chunk
(shortest-remaining-first) with the iteration's decode batch and verify
launch; ``PauseDecodePolicy`` runs chunks exclusively, preserving the
prototype's prefill-stalls-everything semantics chunk by chunk.  A
per-request fixed chunk schedule is shape-consistent by construction, so
committed streams are bitwise identical across chunk sizes too.

* ``AdaptivePolicy``     — acceptance-adaptive: runs ``OverlapPolicy``
  verbatim while speculation is paying off, but watches each request's
  acceptance EMA (``Request.accept_ema``, updated by ``core.dvr`` on every
  verdict) and *demotes* requests whose candidates keep flipping to
  pause-style verification: synchronous verdicts (no in-flight window, no
  speculation past it — nothing wasted on latency) and *eager* partial
  windows whose depth scales with the acceptance rate, so a request in a
  near-constant-rollback regime stops burning W-1 doomed decode
  iterations per committed token.  Hysteresis (demote below / promote
  above) keeps it from flapping; a recovered request is promoted back to
  full overlapped speculation.

A policy maps a :class:`SchedulerView` (what is decodable, what is ready
to verify, stream occupancy, acceptance telemetry) to a :class:`Plan`
(what this iteration runs).  It decides *scheduling*, never token
semantics — the committed stream of a deterministic request is the
verifier's reference sequence by construction, so it is bitwise identical
across policies, arrival orders and co-batched traffic.
``tests/test_scheduler.py`` asserts exactly that.

Recurrent/hybrid archs used to cap speculation at one window (their fast
path advances state irreversibly); with the double-buffered state pool the
verifier never writes live state at launch, so the engine now reports
``speculate_past_inflight=True`` for every family.  The flag remains for
policy logic (and for hypothetical deployments without the pool): when
False, requests with in-flight windows are excluded from the decode batch.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import List, Mapping, Optional, Set

from repro_torch.core import dvr
from repro_torch.core.determinism import Mode
from repro_torch.serving.request import Request, State


@dataclasses.dataclass(frozen=True)
class SchedulerView:
    """Immutable snapshot the engine hands a policy each iteration."""

    running: tuple  # all RUNNING requests, admission order
    mode: Mode
    window: int
    group: int
    #: False for ssm/hybrid archs: no speculation past an in-flight window
    speculate_past_inflight: bool
    now: int  # logical iteration counter
    #: requests mid chunked-prefill (State.PREFILLING), admission order;
    #: empty when the engine runs legacy exclusive prefill (chunk size 0)
    prefilling: tuple = ()
    #: continuous main-stream clock (seconds under a costed clock,
    #: iteration ticks under the logical shim)
    now_time: float = 0.0
    #: stream occupancy: number of verify windows currently in flight
    #: (submitted, verdict not yet landed) across all requests
    verify_inflight: int = 0
    #: seconds of verify-stream work scheduled past ``now_time`` — how far
    #: behind the verify stream is running (0 when caught up / logical)
    verify_backlog: float = 0.0
    #: per-request acceptance telemetry: rid -> EMA of the accepted
    #: fraction per verdict (Request.accept_ema); 1.0 before any verdict
    acceptance: Mapping[int, float] = dataclasses.field(default_factory=dict)
    #: engine pipelining bound: verify windows a single request may have in
    #: flight (``Engine(spec_depth=...)`` / ``serve.py --spec-depth``); the
    #: paper's protocol is depth 1.  Policies may plan shallower (the
    #: adaptive policy scales depth with acceptance) but never deeper —
    #: the state pool holds exactly this many checkpoint buffers per slot
    spec_depth: int = 1
    #: paged-KV memory telemetry (serving.blockpool): free blocks in the
    #: pool right now, and requests currently preempted (blocks evicted,
    #: waiting on the restore lane).  Policies may read these to shape
    #: speculation depth under memory pressure; admission/preemption
    #: themselves are the engine's BlockMemoryPolicy's job.
    free_blocks: int = 0
    num_preempted: int = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one engine iteration executes.  ``verify`` non-empty launches a
    grouped verification pass; ``decode`` non-empty runs a decode batch;
    ``prefill`` non-None advances that request's prefill by one fixed-shape
    chunk.  Multiple lanes non-empty == an overlapped iteration (costed as
    concurrent by the cost model)."""

    decode: List[Request] = dataclasses.field(default_factory=list)
    verify: List[Request] = dataclasses.field(default_factory=list)
    prefill: Optional[Request] = None
    #: True forces this iteration's verify pass to apply its verdict
    #: synchronously (pause-style) even under a deferring policy —
    #: AdaptivePolicy uses it for demoted high-flip requests
    sync_verify: bool = False

    @property
    def overlapped(self) -> bool:
        lanes = bool(self.decode) + bool(self.verify) + (self.prefill is not None)
        return lanes >= 2

    @property
    def empty(self) -> bool:
        return not self.decode and not self.verify and self.prefill is None


def decodable(view: SchedulerView) -> List[Request]:
    """Requests that can take a fast-path decode token this iteration."""
    out = []
    max_cand = dvr.candidates_per_window(view.window)
    for r in view.running:
        if r.state is State.PREFILLING:
            continue  # no committed token yet: nothing to decode from
        if r.done_decoding():
            continue
        if view.mode == Mode.LLM42 and r.sampling.is_deterministic:
            if len(r.candidates) >= max_cand:
                continue  # current window full; awaiting (or in) verification
            if r.pipeline and not view.speculate_past_inflight:
                continue  # no state pool: no speculation past a window
        out.append(r)
    return out


def verify_ready(
    view: SchedulerView, depth: Optional[int] = None
) -> List[Request]:
    """Requests with a submittable window.  ``depth`` bounds windows in
    flight per request (default: the engine's ``spec_depth``); a request
    already at depth waits for a verdict before launching again."""
    if view.mode != Mode.LLM42:
        return []
    d = view.spec_depth if depth is None else depth
    return [
        r for r in view.running
        if dvr.ready_for_verify(r, view.window, depth=d)
    ]


def expand_chained(
    view: SchedulerView, ready: List[Request], depth_of=None
) -> List[Request]:
    """Lift the one-window-per-iteration cap: a request whose speculation
    buffer holds SEVERAL due windows (spec_depth > 1 — e.g. its verdicts
    all landed this iteration and re-opened the pipeline) contributes one
    plan entry PER submittable window, as a contiguous run.  The engine's
    fused step packs the k-th occurrences into the k-th chained grouped
    pass, so every due window lands the iteration it became due instead of
    dribbling out one per iteration.  ``depth_of`` overrides the
    per-request pipelining bound (AdaptivePolicy's acceptance-scaled
    depth); entries stay bounded by FIFO room either way.  Engines that
    launch one window per request per iteration (the legacy lanes) simply
    collapse the run to its first entry — pacing, never semantics."""
    k = dvr.candidates_per_window(view.window)
    out: List[Request] = []
    for r in ready:
        d = view.spec_depth if depth_of is None else depth_of(r)
        room = d - len(r.pipeline)
        full = len(r.candidates) // k
        windows = full + (
            1 if (len(r.candidates) % k and r.done_decoding()) else 0
        )
        out.extend([r] * max(1, min(windows, room)))
    return out


def pick_prefill(view: SchedulerView) -> Optional[Request]:
    """The prefill chunk that rides a co-scheduled iteration, picked
    shortest-remaining-first — a short prompt's single chunk never queues
    behind a long prefill (head-of-line blocking; ties break by admission
    order, stable min).  Every fourth iteration serves the admission-order
    head instead, so a sustained stream of short arrivals can never starve
    a long prefill (it advances at least every 4 iterations) while shorts
    rarely wait more than one extra slot.  Lane order never affects token
    semantics — per-request prefill numerics are independent of when the
    chunks run."""
    if not view.prefilling:
        return None
    if view.now % 4 == 0:
        return view.prefilling[0]
    return min(view.prefilling, key=lambda r: r.prefill_remaining)


class SchedulePolicy(abc.ABC):
    """Maps a scheduler view to this iteration's plan."""

    name: str = "abstract"
    #: True => verify verdicts go through per-request in-flight state and
    #: land at their verify-stream deadline (serving.streams); False =>
    #: the verdict is applied synchronously inside the verify pass (seed
    #: flow).
    defers_verify: bool = False

    @abc.abstractmethod
    def plan(self, view: SchedulerView) -> Plan:
        ...


class PauseDecodePolicy(SchedulePolicy):
    """Paper-prototype scheduling: verification pauses decoding.

    Verify when a full group is ready or when nothing can decode; otherwise
    decode.  One device pass per iteration — the §5.2 limitation (1)
    behaviour the seed engine shipped with."""

    name = "pause_decode"

    def plan(self, view: SchedulerView) -> Plan:
        if view.prefilling:
            # exclusive prefill chunk, head of line: the prototype's
            # synchronous-prefill semantics, merely sliced into fixed-shape
            # pieces — nothing else runs while a prompt is prefilling
            return Plan(prefill=view.prefilling[0])
        # sync verdicts apply in the launch iteration: nothing is ever in
        # flight, so the pipelining depth is irrelevantly 1 here
        ready = verify_ready(view, depth=1)
        dec = decodable(view)
        if ready and (len(ready) >= view.group or not dec):
            return Plan(verify=ready)
        if dec:
            return Plan(decode=dec)
        if ready:  # drain stragglers
            return Plan(verify=ready)
        return Plan()


class OverlapPolicy(SchedulePolicy):
    """Co-schedule a verify group alongside the iteration's decode batch.

    The decode batch always contains every decodable request — verification
    never idles the fast path.  Verify groups are launched group-aware: a
    fixed-shape (G, W) pass costs the same however few rows are real, so a
    partial group waits while other deterministic windows are still filling
    (they will pool into a fuller pass) and launches once no more can join —
    or once nothing can decode, where holding would stall the iteration.
    Holding is not free for the HELD rows: their window is full, so they
    neither decode nor verify until the group launches (the same wait
    pause-decode's full-group gate imposes); what the policy never trades
    away is the progress of everything else in the batch."""

    name = "overlap"
    defers_verify = True

    def __init__(self, max_inflight: int = 0):
        #: GLOBAL cap on concurrently in-flight verify windows across all
        #: requests (0 = unbounded) — the verify-stream backlog knob.  The
        #: per-request pipelining depth is the engine's ``spec_depth``
        #: (``SchedulerView.spec_depth``): the policy keeps launching a
        #: request's next window while its FIFO has room, so with a slow
        #: verify stream (--verify-latency-ms) a single request can hide
        #: ``spec_depth`` verdict round-trips — the depth axis
        #: benchmarks/fig_pipeline.py sweeps.
        self.max_inflight = max_inflight

    def plan(self, view: SchedulerView) -> Plan:
        return self._compose(
            view, expand_chained(view, verify_ready(view)), decodable(view),
            view.running,
        )

    def _compose(
        self,
        view: SchedulerView,
        ready: List[Request],
        dec: List[Request],
        det_pool,
    ) -> Plan:
        """Overlap composition over an explicit candidate set.

        ``ready``/``dec`` are the verify-ready and decodable requests this
        policy may schedule; ``det_pool`` is the set whose deterministic
        members might still *join* a partial verify group (AdaptivePolicy
        passes a filtered pool so demoted requests — which will never
        launch deferred — cannot hold a group open forever)."""
        if ready and len(ready) < view.group and dec:
            ready_set = set(id(r) for r in ready)
            may_join = any(
                r.sampling.is_deterministic
                and id(r) not in ready_set
                # a PREFILLING request's join horizon (finish prefill, then
                # fill a window) is too far out to hold a ready group for
                and r.state is not State.PREFILLING
                and (bool(r.pipeline) or not r.done_decoding())
                for r in det_pool
            )
            if may_join:
                ready = []
        if self.max_inflight and ready:
            # depth cap: a launch may only fill the REMAINING room, so the
            # in-flight window count never exceeds max_inflight (a
            # pre-launch gate alone would overshoot by up to group-1 —
            # the launch itself adds up to `group` windows).  Runs after
            # the group-holding logic: a trimmed partial launch is the
            # cap's doing, not a group worth waiting to fill.
            room = self.max_inflight - view.verify_inflight
            ready = ready[: max(room, 0)]
        if ready and view.speculate_past_inflight:
            # the rows being submitted (the engine takes the first `group`
            # DISTINCT requests — chained-window entries repeat) decode in
            # this very iteration too — their first token past the window
            # rides the launch quantum instead of costing an iteration of
            # their own.  The engine decodes BEFORE landing the verify
            # submits' state rule, so the window's KV repair still wins
            # (engine.step docstring); excluded on recurrent archs like
            # any other past-window speculation
            seen: Set[int] = set()
            for r in ready:
                if len(seen) >= view.group:
                    break
                if id(r) in seen:
                    continue
                seen.add(id(r))
                if not r.done_decoding():
                    dec.append(r)
        return Plan(decode=dec, verify=ready, prefill=pick_prefill(view))


class AdaptivePolicy(SchedulePolicy):
    """Acceptance-adaptive scheduling: overlap while speculation pays,
    pause-style verification for requests it keeps failing.

    Near-constant rollback is where overlapping loses (fig_overlap
    ``50pct_stress``): a high-flip request burns W-1 decode iterations
    filling a window the verifier is about to reject, its in-flight
    verdict lands a latency late, and everything it speculated past the
    window is recomputed — the contention term with nothing hidden behind
    it.  This policy watches the per-request acceptance EMA the view
    carries and **demotes** a request once its EMA drops below
    ``demote_below``:

    * its verification turns synchronous and exclusive (the pause
      prototype's semantics — no in-flight window, no speculation past
      it, verdict applied in the launch iteration);
    * its windows shrink to an *eager* depth that scales with the EMA
      (``max(1, round(ema * (W-1)))``): at near-zero acceptance it
      submits after a single candidate, so each committed token costs one
      decode plus its share of a grouped verify pass instead of W-1
      doomed speculations.  Window pacing is scheduling, not semantics —
      the committed stream is the same reference sequence at every depth.

    A demoted request whose EMA recovers above ``promote_above`` is
    promoted back to full overlapped speculation (hysteresis prevents
    flapping).  Non-demoted requests pipeline with **acceptance-scaled
    depth**: a request may hold ``max(1, round(ema * spec_depth))``
    windows in flight, so a request whose candidates have started flipping
    stops pushing a deep pipeline it will mostly cascade away, *before*
    the demotion threshold trips.  At full acceptance (and always at
    ``spec_depth=1``) the policy IS ``OverlapPolicy`` — identical plans,
    identical events — so low-rollback traffic keeps the whole overlap
    win.

    Note the policy carries per-request hysteresis state (the demoted
    set), unlike the stateless pause/overlap policies — use one instance
    per engine."""

    name = "adaptive"
    defers_verify = True

    def __init__(
        self,
        demote_below: float = 0.6,
        promote_above: float = 0.8,
        max_inflight: int = 0,
    ):
        assert 0.0 < demote_below <= promote_above <= 1.0
        self.demote_below = demote_below
        self.promote_above = promote_above
        self._overlap = OverlapPolicy(max_inflight=max_inflight)
        self._demoted: Set[int] = set()
        # hysteresis-transition telemetry (obs.metrics gauges)
        self.num_demotions = 0
        self.num_promotions = 0

    def _update_demotions(self, view: SchedulerView) -> None:
        alive = set()
        for r in view.running:
            if not r.sampling.is_deterministic:
                continue
            alive.add(r.rid)
            ema = view.acceptance.get(r.rid, 1.0)
            if r.rid in self._demoted:
                if ema >= self.promote_above:
                    self._demoted.discard(r.rid)
                    self.num_promotions += 1
            elif ema < self.demote_below:
                self._demoted.add(r.rid)
                self.num_demotions += 1
        self._demoted &= alive  # drop retired requests

    def _eager_depth(self, view: SchedulerView, r: Request) -> int:
        ema = view.acceptance.get(r.rid, 1.0)
        return max(1, int(round(ema * dvr.candidates_per_window(view.window))))

    def _pipeline_depth(self, view: SchedulerView, r: Request) -> int:
        """Acceptance-scaled in-flight depth for a promoted request: full
        ``spec_depth`` at EMA 1.0, shrinking toward 1 as candidates start
        flipping — a deep pipeline behind a likely rollback is pure
        cascade fodder.  Never 0: demotion (not depth) turns overlap off."""
        ema = view.acceptance.get(r.rid, 1.0)
        return max(1, int(round(ema * view.spec_depth)))

    def _promoted_ready(self, view: SchedulerView) -> List[Request]:
        return [
            r for r in view.running
            if r.rid not in self._demoted
            and dvr.ready_for_verify(
                r, view.window, depth=self._pipeline_depth(view, r)
            )
        ]

    def _expanded_ready(self, view: SchedulerView) -> List[Request]:
        """Promoted ready set with chained-window entries, bounded by each
        request's ACCEPTANCE-SCALED depth (not the engine's full
        spec_depth): a request trending toward rollback keeps a shallow
        pipeline even when several of its windows are due at once."""
        return expand_chained(
            view, self._promoted_ready(view),
            depth_of=lambda r: self._pipeline_depth(view, r),
        )

    def plan(self, view: SchedulerView) -> Plan:
        self._update_demotions(view)
        if not self._demoted:
            return self._overlap._compose(
                view, self._expanded_ready(view), decodable(view),
                view.running,
            )
        demoted = [r for r in view.running if r.rid in self._demoted]
        dem_ready = [
            r for r in demoted
            # sync verification replays from committed[-1]: a freshly
            # demoted request first drains its in-flight FIFO
            if not r.pipeline and dvr.ready_for_verify(
                r, view.window, min_candidates=self._eager_depth(view, r)
            )
        ]
        dec = decodable(view)
        dem_decodable = [r for r in dec if r.rid in self._demoted]
        if dem_ready and (
            len(dem_ready) >= min(view.group, len(demoted))
            or not dem_decodable
        ):
            # pause-style exclusive verification for the demoted group:
            # sync verdict, no decode co-scheduled — exactly the
            # prototype's iteration, so a fully demoted workload
            # degenerates to PauseDecodePolicy with shallower (cheaper)
            # windows.  A prefill chunk still rides along: it touches only
            # its own slot (order-independent) and starving it every sync
            # iteration would halve a co-resident prompt's prefill rate
            # at eager depth 1 (sync passes can fire every other
            # iteration)
            return Plan(
                verify=dem_ready[: view.group], sync_verify=True,
                prefill=pick_prefill(view),
            )
        # otherwise: overlap composition for everything else.  Demoted
        # requests may decode (filling their eager window) but never
        # launch deferred, and — because they can never join a deferred
        # group — they are excluded from the group-holding pool.
        ready = self._expanded_ready(view)
        det_pool = [r for r in view.running if r.rid not in self._demoted]
        return self._overlap._compose(view, ready, dec, det_pool)


class BlockMemoryPolicy:
    """Admission + preemption policy for the paged KV block pool.

    The scheduler's verify/decode policies above decide what RUNS each
    iteration; this policy decides who gets MEMORY when the block pool
    runs dry:

    * **victim choice** — least-recently-scheduled (LRU) among the running
      requests, deterministic ``(last_sched, rid)`` tie-break.  Requests
      mid-prefill are never preempted (they have committed nothing — their
      replay anchor does not exist yet), and the engine excludes the
      requester itself.
    * **anti-thrash hysteresis** — (a) a freshly *restored* request is
      passed over as a victim for ``restore_cooldown`` iterations unless
      every candidate is equally fresh (preempting what you just replayed
      is pure thrash — but forward progress beats fairness, so the shield
      is advisory, never absolute); (b) a preempted request re-admits only
      once ``restore_cooldown`` iterations have passed since ITS
      preemption AND the pool can cover its full worst-case need plus
      ``watermark_blocks`` of headroom — a restore that would immediately
      preempt someone else (or be re-preempted itself) never starts.

    Preemption is *safe* by the commit rule: the victim keeps its slot
    (recurrent state rows are O(1) — the memory being reclaimed is KV
    blocks), its committed stream, and its statepool replay anchor; the
    restore replays only committed tokens through the chunked-prefill
    lane, which is bitwise-identical by construction.
    """

    name = "block-lru"

    def __init__(self, watermark_blocks: int = 0, restore_cooldown: int = 8):
        assert watermark_blocks >= 0 and restore_cooldown >= 0
        self.watermark_blocks = watermark_blocks
        self.restore_cooldown = restore_cooldown

    def pick_victim(
        self, candidates: List[Request], now: int
    ) -> Optional[Request]:
        """LRU victim among ``candidates`` (running, not the requester,
        not mid-prefill — the engine pre-filters)."""
        if not candidates:
            return None
        shielded = lambda r: now - r.restore_iter < self.restore_cooldown  # noqa: E731
        pool = [r for r in candidates if not shielded(r)] or candidates
        return min(pool, key=lambda r: (r.last_sched, r.rid))

    def may_restore(
        self, req: Request, free_blocks: int, need_blocks: int, now: int
    ) -> bool:
        """Gate the restore lane: cooldown since the request's own
        preemption + full worst-case need + watermark of headroom."""
        if now - req.preempt_iter < self.restore_cooldown:
            return False
        return free_blocks - need_blocks >= self.watermark_blocks

    def may_admit(self, free_blocks: int, need_blocks: int) -> bool:
        """Gate fresh admission on the prompt's block need + watermark.
        Fresh traffic never preempts running work — it waits; only the
        *growth* of already-admitted requests may preempt."""
        return free_blocks - need_blocks >= self.watermark_blocks


def default_policy(mode: Mode) -> SchedulePolicy:
    """LLM42 overlaps by default; other modes never verify, so the pause
    policy's decode-only branch is all they use."""
    return OverlapPolicy() if mode == Mode.LLM42 else PauseDecodePolicy()
