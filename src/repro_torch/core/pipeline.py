"""Multi-window speculation pipeline (per-request in-flight verify FIFO).

PR 3's ``fig_pipeline`` sweep showed the binding constraint on deep
verify/decode pipelining is the *protocol*, not verify-stream bandwidth:
with one outstanding window per request, 50 ms of verdict latency drops
throughput to ~0.45x pause-decode while the verify stream idles.  The
paper's verify-rollback loop (§4.2) never requires a single outstanding
window — only that commits splice in submission order.  This module owns
that generalized protocol: ``Request.pipeline`` is a FIFO of
:class:`~repro.serving.request.InflightVerify` records (replacing the old
single ``req.inflight`` slot), and the functions here keep three
invariants:

* **in-order splicing** — only the FIFO's *front* verdict may land.  A
  verdict that arrives early (out-of-order landings across launch groups)
  waits until every earlier window of the same request has spliced, so the
  committed stream is extended strictly in submission order.
* **front normalization** — window *k+1* is submitted *chained*: its
  conditioning token is window *k*'s last candidate, and its first
  candidate occupies the same output position as window *k*'s commit
  token.  When window *k* fully matches and its commit token agrees with
  that first candidate, the successor's already-committed head is popped
  (and its ``n_match`` shifted) so the record reaching the FIFO front is
  always *anchored* on ``committed[-1]`` — the depth-1 splice rule then
  applies verbatim at every depth.
* **cascading invalidation** — a rollback in window *k* (partial match, or
  a full match whose commit token disagrees with the next speculated
  token) discards windows *k+1..n* and the fresh speculation tail: they
  all descend from a token the verifier rejected.  The engine restores the
  slot's device state from the window's state-pool checkpoint
  (``serving.statepool``) whenever :attr:`SpliceOutcome.restore_state` is
  set — on every rollback, and on a clean splice that leaves no surviving
  speculation (the live recurrent state then lags the committed stream by
  one token, exactly the gap the checkpoint closes).

Scheduling (when windows launch, how deep the pipeline runs) stays in
``serving.scheduler``; device passes stay in ``core.verifier``.  Nothing
here moves a committed token: the committed stream is the verifier's
reference sequence at every depth, which is what keeps streams bitwise
identical across ``--spec-depth``, policies, clock modes, and adversarial
verdict-landing schedules.
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core import dvr
from repro_torch.serving.request import InflightVerify, Request, State


def depth(req: Request) -> int:
    """Windows currently in flight for this request."""
    return len(req.pipeline)


def spec_len(req: Request) -> int:
    """Total candidates inside in-flight windows (sequence positions
    between ``committed`` and the fresh ``candidates`` buffer)."""
    return sum(len(fl.cands) for fl in req.pipeline)


def conditioning_token(req: Request) -> int:
    """The token the next submitted window's replay re-consumes first:
    the last in-flight candidate, or ``committed[-1]`` when the FIFO is
    empty (the anchored, depth-1 case)."""
    if req.pipeline:
        return int(req.pipeline[-1].cands[-1])
    return int(req.committed[-1])


@dataclasses.dataclass
class SpliceOutcome:
    """What one front splice did — the engine's cue for device-state work."""

    record: InflightVerify
    rolled_back: bool  #: any candidate (in-window or cascaded) was rejected
    cascaded: List[InflightVerify]  #: later windows discarded wholesale
    #: True => restore the slot's live state (and replay anchor) from the
    #: record's state-pool checkpoint: required on rollback, and on a clean
    #: splice with no surviving speculation (live recurrent state would
    #: otherwise lag ``committed`` by one consumed token)
    restore_state: bool
    #: True => the FIFO is empty after this splice: the NEXT window will
    #: launch *anchored* on ``committed[-1]``, so the replay anchor must
    #: move to this record's checkpoint (= state after its last candidate
    #: on a full match) even when the live state and a surviving
    #: speculation tail are untouched.  The anchor currently holds the
    #: chained start state (one token earlier), which is only right for a
    #: successor launched behind an in-flight window.
    reanchor: bool = False
    #: committed-stream extent of this splice AFTER the budget clamp:
    #: ``req.committed[committed_base : committed_base + committed_count]``
    #: are exactly the tokens this splice committed — the audit log's
    #: per-token provenance slice (the clamp may truncate the nominal
    #: matched-prefix + commit-token extension, so record counts must come
    #: from here, not from ``n_match``)
    committed_base: int = 0
    committed_count: int = 0
    #: speculated tokens this splice rejected (in-window rollback plus the
    #: cascaded windows' and fresh tail's candidates)
    rejected: int = 0


def submit_window(
    req: Request,
    window: int,
    submitted_at: float,
    ready_at: float,
    ring_idx: int = 0,
) -> InflightVerify:
    """Move the next window's candidates out of the speculation buffer and
    append them to the in-flight FIFO.  The request keeps decoding behind
    the window (fresh candidates queue after it); ``ring_idx`` names the
    state-pool checkpoint buffer the window's verify pass writes."""
    assert req.candidates, "no candidates to submit"
    k = dvr.candidates_per_window(window)
    fl = InflightVerify(
        cands=req.candidates[:k],
        submitted_at=submitted_at,
        ready_at=ready_at,
        cond_tok=conditioning_token(req),
        ring_idx=ring_idx,
        seq=req.window_seq,
    )
    req.candidates = req.candidates[k:]
    req.pipeline.append(fl)
    req.window_seq += 1
    # window is out: the request resumes speculating unless its budget is
    # already covered by outstanding speculation (then it awaits verdicts)
    if req.state is not State.FINISHED:
        req.state = (
            State.AWAITING_VERIFY if req.done_decoding() else State.RUNNING
        )
    return fl


def apply_ready(req: Request, window: int, now: float) -> List[SpliceOutcome]:
    """Splice every *due* verdict at the FIFO front (``ready_at <= now``),
    in submission order.  A ready verdict behind an unready front waits —
    in-order splicing is the protocol invariant that makes out-of-order
    cross-request landings harmless."""
    out: List[SpliceOutcome] = []
    while req.pipeline:
        fl = req.pipeline[0]
        if fl.n_match < 0 or fl.ready_at > now:
            break
        out.append(splice_front(req, window))
    return out


def splice_front(req: Request, window: int = 0) -> SpliceOutcome:
    """Apply the FIFO front's verdict (the depth-1 commit rule, thanks to
    front normalization) and cascade/normalize what rides behind it.

    Every record in the FIFO must already carry its device result
    (``n_match >= 0``): the discrete-event engine computes verdicts eagerly
    at launch and only their *visibility* is delayed, so a front splice may
    need to shift the successor's ``n_match`` during normalization."""
    fl = req.pipeline.pop(0)
    k = len(fl.cands)
    # acceptance telemetry over the window AS SUBMITTED: candidates popped
    # by front normalization were accepted (they got committed), so they
    # re-enter both numerator and denominator here
    dvr._update_acceptance(req, fl.n_match + fl.shifted, k + fl.shifted)
    n = min(fl.n_match, k)
    rejected = k - n

    committed_base = len(req.committed)
    req.committed.extend(fl.cands[:n])
    req.committed.append(int(fl.commit_tok))
    req.num_verify_passes += 1

    # Does the speculation behind this window survive?  Only a full match
    # whose commit token equals the next speculated token (it was
    # conditioned on exactly what got committed); the agreeing head is
    # popped — it is now committed as the commit token itself.
    chain = False
    cascaded: List[InflightVerify] = []
    if n == k:
        ct = int(fl.commit_tok)
        if req.pipeline:
            succ = req.pipeline[0]
            if succ.cands and int(succ.cands[0]) == ct:
                succ.cands.pop(0)
                if succ.margins:  # keep margins parallel to cands+commit
                    succ.margins.pop(0)
                # the successor's replay re-predicted this position from the
                # same context the commit token came from; the fixed-shape
                # fixed-schedule replay is batch-invariant, so it matched
                assert succ.n_match >= 1, (
                    "chained verdict disagrees with its own conditioning "
                    "context — verify replay is not batch-invariant"
                )
                succ.n_match -= 1
                succ.shifted += 1
                chain = True
        elif req.candidates:
            if int(req.candidates[0]) == ct:
                req.candidates.pop(0)
                chain = True
        else:
            chain = True  # nothing speculated past the window: clean splice

    if not chain:  # rollback: cascade-invalidate everything behind
        cascaded = req.pipeline
        req.pipeline = []
        rejected += sum(len(c.cands) for c in cascaded) + len(req.candidates)
        req.candidates = []
        req.num_cascaded_windows += len(cascaded)

    if rejected > 0:
        req.num_rollbacks += 1
        req.num_recomputed_tokens += rejected

    pre_clamp = req.pipeline
    dvr._clamp_budget(req)
    if pre_clamp and not req.pipeline:
        # the budget clamp mooted windows still in flight: no rollback
        # semantics (their tokens fell past the budget, not to a verdict),
        # but depth accounting and telemetry must see them discarded
        cascaded = cascaded + pre_clamp
        req.num_cascaded_windows += len(pre_clamp)
    if req.state is not State.FINISHED:
        req.state = State.RUNNING  # verdict landed: no longer verify-gated
        if window:  # unless the budget is covered by leftover speculation
            dvr.mark_window_state(req, window)
    return SpliceOutcome(
        record=fl,
        rolled_back=rejected > 0,
        cascaded=cascaded,
        restore_state=not chain or not (req.pipeline or req.candidates),
        reanchor=not req.pipeline,
        committed_base=committed_base,
        committed_count=len(req.committed) - committed_base,
        rejected=rejected,
    )
