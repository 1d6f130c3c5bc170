"""Decode-verify-rollback bookkeeping (paper §4.2).

Host-side protocol logic for one request; the device-side fixed-shape pass
lives in ``core.verifier``.  The engine calls:

  * ``append_candidate``   after each fast-path decode of a det request
  * ``ready_for_verify``   to decide when a window is full
  * ``apply_verify_result`` to commit / roll back after a verify pass

Commit rule (paper Fig. 8): commit the leading run of matching candidates
plus the verifier token at the first mismatch (or the trailing verifier
token on a full match).  Every verify pass commits >= 1 token — guaranteed
forward progress.

In-flight verification (scheduler ``OverlapPolicy``, beyond §5.2
limitation (1)): windows can be *submitted* without pausing the request —
the candidates move to the request's in-flight FIFO (``req.pipeline``) and
the fast path keeps appending fresh candidates behind them, up to the
engine's ``spec_depth`` outstanding windows.  ``core.pipeline`` owns the
in-order splice / cascade-invalidation semantics; this module keeps the
synchronous commit rule, readiness/housekeeping helpers, and the verify-row
builder (which conditions each row on the speculation immediately preceding
it, so chained windows replay the right context).  Either way the committed
stream is the same deterministic reference sequence, which is why policies,
depths and verdict-landing orders are interchangeable bit-for-bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.serving.request import Request, State


def candidates_per_window(window: int) -> int:
    """A window of W inputs verifies W-1 candidates (input 0 is the last
    committed token) and emits one fresh verifier token."""
    return window - 1


#: EMA step for per-request acceptance telemetry.  High on purpose: the
#: adaptive scheduler must react within a verdict or two of a request
#: entering (or leaving) a high-flip regime.
ACCEPT_EMA_ALPHA = 0.5


def _update_acceptance(req: Request, n_match: int, n_submitted: int) -> None:
    """Fold one verdict into the request's acceptance EMA.  The sample is
    the accepted fraction of the *submitted* candidates — a partial
    (eager) window counts the same as a full one, so the signal tracks
    flip probability, not window pacing."""
    if n_submitted <= 0:
        return
    frac = min(n_match, n_submitted) / n_submitted
    req.accept_ema += ACCEPT_EMA_ALPHA * (frac - req.accept_ema)


def ready_for_verify(
    req: Request,
    window: int,
    *,
    min_candidates: Optional[int] = None,
    depth: int = 1,
) -> bool:
    """A window is ready once full (W-1 candidates) or once the request is
    done decoding — and once the in-flight FIFO has room: ``depth`` is the
    pipelining bound (windows outstanding per request; the old protocol is
    ``depth=1``).  ``min_candidates`` lowers the fullness bar: the adaptive
    scheduler verifies high-flip requests *eagerly* with partial windows —
    the fixed-shape (G, W) verify pass pads short rows, and the committed
    stream is a prefix-stable reference sequence, so window pacing moves
    only throughput, never tokens."""
    if not req.sampling.is_deterministic:
        return False
    if req.state == State.FINISHED or not req.candidates:
        return False
    if len(req.pipeline) >= max(depth, 1):
        return False  # pipeline at configured depth: wait for a verdict
    threshold = candidates_per_window(window)
    if min_candidates is not None:
        threshold = max(1, min(min_candidates, threshold))
    return len(req.candidates) >= threshold or req.done_decoding()


def mark_window_state(req: Request, window: int) -> None:
    """Truthful ``State`` bookkeeping after a fast-path candidate lands: a
    deterministic request whose candidate window is full — or whose output
    budget is already covered by outstanding speculation — cannot take
    another fast-path token and is awaiting verification."""
    if req.state is State.FINISHED:
        return
    if len(req.candidates) >= candidates_per_window(window) or (
        req.candidates and req.done_decoding()
    ):
        req.state = State.AWAITING_VERIFY


def build_verify_row(
    req: Request, window: int, pad_token: int = 0
) -> Tuple[List[int], List[int], int, int, int]:
    """Returns (inputs[W], cand[W-1], cand_len, start_pos, out_base).

    The row conditions on the token immediately preceding its candidates in
    sequence order: ``committed[-1]`` with an empty in-flight FIFO (the
    anchored, depth-1 case) or the last in-flight candidate (a chained
    window at depth > 1).  Positions shift past the in-flight candidates —
    splices later move tokens from the FIFO into ``committed`` without
    changing ``committed + in-flight`` length, so the absolute positions
    fixed here stay valid however verdicts land."""
    W = window
    cand = req.candidates[: W - 1]
    cand_len = len(cand)
    spec = sum(len(fl.cands) for fl in req.pipeline)
    cond = req.pipeline[-1].cands[-1] if req.pipeline else req.committed[-1]
    inputs = [cond] + cand
    inputs = inputs + [pad_token] * (W - len(inputs))
    cand_padded = cand + [-1] * ((W - 1) - cand_len)
    # abs position of inputs[0]: prompt (+ any prefix embeds) + committed
    # + in-flight speculation - 1
    prefix = getattr(req, "_prefix_len", 0)
    start_pos = req.prompt_len + prefix + len(req.committed) + spec - 1
    out_base = len(req.committed) + spec  # output index of v_0
    return inputs, cand_padded, cand_len, start_pos, out_base


def apply_verify_result(
    req: Request, n_match: int, commit_tok: int, window: int = 0
) -> Tuple[int, int]:
    """Commit matching prefix + the verifier token; roll back the rest.

    The synchronous (pause-style) path: the row was conditioned on
    ``committed[-1]``, which requires an empty in-flight FIFO — a request
    with outstanding windows must drain them (``core.pipeline``) before it
    can be verified synchronously.

    Returns ``(n_committed, n_rejected)``: tokens actually appended to the
    committed stream (AFTER the budget clamp — what the audit log must
    cover) and candidates rolled back."""
    assert not req.pipeline, "sync verify requires an empty in-flight FIFO"
    cand_len = len(req.candidates)
    _update_acceptance(req, n_match, cand_len)
    n_match = min(n_match, cand_len)
    accepted = req.candidates[:n_match]
    rejected = cand_len - n_match

    base = len(req.committed)
    req.committed.extend(accepted)
    req.committed.append(int(commit_tok))
    req.candidates = []
    req.num_verify_passes += 1
    if rejected > 0:
        req.num_rollbacks += 1
        req.num_recomputed_tokens += rejected

    _clamp_budget(req)
    if req.state is not State.FINISHED:
        req.state = State.RUNNING  # verdict landed: no longer gated on verify
        if window:  # unless the budget is still covered by leftover cands
            mark_window_state(req, window)
    return len(req.committed) - base, rejected


def _clamp_budget(req: Request) -> None:
    # clamp to the output budget (the verifier may add one token past it)
    budget = req.sampling.max_new_tokens
    if len(req.committed) > budget:
        req.committed = req.committed[:budget]
    if len(req.committed) >= budget:
        # budget reached: any outstanding speculation — fresh candidates
        # AND windows still in flight — is moot
        req.candidates = []
        req.pipeline = []
