"""SEEDED VIOLATION (do not fix): split-K fast path on the verify path.

A commit-annotated verify step that picks its GEMM schedule from
``FAST_PATH_POLICY.schedule_for(batch)``: the batch-adaptive split-K
schedule leaking onto the commit side, the one thing the contract exists
to prevent.  The checker must flag (the taint pass reads the AST; nothing
here is run):
  * taint/fast-schedule-on-commit-path  (schedule_for on the root)
  * taint/unresolved-schedule           (a schedule= from an opaque attribute)
"""

from __future__ import annotations

from repro_torch.core.determinism import FAST_PATH_POLICY, matmul


def _project(x, w, sched):
    # schedule threaded from a parameter: resolved at the caller, not here
    return matmul(x, w, schedule=sched)


def _mystery_project(x, w, cfg):
    # VIOLATION: schedule from an opaque attribute, which nothing proves safe
    return matmul(x, w, schedule=cfg.decode_schedule)


# det: commit-path
def verify_step_fast(params, x, batch: int):
    # VIOLATION: batch-adaptive split-K schedule on the commit side
    sched = FAST_PATH_POLICY.schedule_for(batch)
    h = _project(x, params["w1"], sched)
    return _mystery_project(h, params["w2"], params["cfg"])
