"""Request lifecycle for the serving engine.

The paper's per-request determinism control (O4) is the
``SamplingParams.is_deterministic`` flag: deterministic requests go through
the decode-verify-rollback protocol; everything else streams straight from
the fast path with zero overhead.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class State(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"  # admitted; prompt advancing chunk by chunk
    RUNNING = "running"  # decoding (candidates may be outstanding)
    AWAITING_VERIFY = "awaiting_verify"  # candidate window full, needs verify
    PREEMPTED = "preempted"  # KV blocks evicted; committed stream retained
    FINISHED = "finished"


@dataclasses.dataclass
class InflightVerify:
    """A verification window submitted to the device but not yet applied.

    Requests hold a FIFO of these (``Request.pipeline``): the scheduler may
    keep a request speculating — and keep *submitting further windows* —
    while earlier windows are outstanding, up to the engine's
    ``spec_depth``.  ``core.pipeline`` owns the in-order splice / cascade
    semantics.  ``n_match``/``commit_tok`` are filled in when the device
    pass completes (< 0 means still pending from the protocol's view — the
    discrete-event engine computes them eagerly but *applies* them at
    ``ready_at`` to model verification latency).

    ``submitted_at``/``ready_at`` are continuous stream-clock times
    (``serving.streams``): seconds under a costed clock, iteration ticks
    under the deprecated logical shim.  The verdict lands at the first
    iteration whose main-stream clock reaches ``ready_at`` — and only once
    every earlier window of the same request has spliced."""

    cands: List[int]
    submitted_at: float
    ready_at: float
    n_match: int = -1
    commit_tok: int = -1
    #: token the window's replay re-consumed first: the previous in-flight
    #: window's last candidate (chained) or ``committed[-1]`` (anchored)
    cond_tok: int = -1
    #: state-pool ring buffer holding this window's rollback checkpoint
    ring_idx: int = 0
    #: candidates popped off the front by predecessor splices (front
    #: normalization): they were ACCEPTED — committed as the predecessor's
    #: commit token — so acceptance telemetry must count them even though
    #: ``cands``/``n_match`` no longer do
    shifted: int = 0
    #: per-request window submission sequence number (``Request.window_seq``
    #: at submit) — the audit log's window id
    seq: int = -1
    #: verifier top-1/top-2 logit margins per window position, parallel to
    #: ``cands`` + the commit token (audit provenance; filled only when an
    #: audit log is attached, and popped alongside ``cands`` by front
    #: normalization so the alignment survives shifts)
    margins: Optional[List[float]] = None


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy (argmax, first-max tiebreak)
    top_k: int = 0  # 0 => no truncation; deterministic for fixed k
    seed: int = 42
    max_new_tokens: int = 64
    is_deterministic: bool = False  # the paper's new API flag; default False
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_time: float = 0.0

    # --- runtime state (engine-managed) ---
    state: State = State.QUEUED
    slot: int = -1
    # paged-KV block table (serving.blockpool): block j holds this
    # request's full-attention KV for absolute positions
    # [j * block_size, (j+1) * block_size).  The first ``blocks_shared``
    # entries are read-only prefix-cache blocks (refcounted, never written
    # — all writes land past the committed-prefix match by construction).
    blocks: List[int] = dataclasses.field(default_factory=list)
    blocks_shared: int = 0
    # chunk-resumable prefill progress (chunked-prefill lane): positions
    # [0, prefill_pos) of the input sequence (prefix embeds + prompt) are
    # already written into the cache; prefill_total is the full length.
    # ``prefill_stream`` is the token stream the lane feeds: the prompt
    # on admission, prompt + committed[:-1] on a post-preemption restore
    # replay (``replaying`` skips the T0 sample — T0 is already committed).
    prefill_pos: int = 0
    prefill_total: int = 0
    prefill_stream: Optional[List[int]] = None
    replaying: bool = False
    committed: List[int] = dataclasses.field(default_factory=list)
    candidates: List[int] = dataclasses.field(default_factory=list)
    # FIFO of windows submitted for verification while decoding continues
    # (core.pipeline owns in-order splicing and cascade invalidation)
    pipeline: List[InflightVerify] = dataclasses.field(default_factory=list)
    # monotone per-request window counter (state-pool ring indexing)
    window_seq: int = 0
    # acceptance telemetry: EMA of per-verdict acceptance fraction
    # (n_match / candidates submitted), updated by core.dvr on every
    # verdict.  Starts optimistic; AdaptivePolicy reads it to demote
    # high-flip requests to pause-style verification (and promote back).
    accept_ema: float = 1.0
    # preemption / memory-pressure bookkeeping (serving.blockpool lane):
    # last_sched drives the LRU victim choice; preempt_iter / restore_iter
    # feed the anti-thrash hysteresis in scheduler.BlockMemoryPolicy
    last_sched: int = 0
    preempt_iter: int = -(10 ** 9)
    restore_iter: int = -(10 ** 9)
    num_preemptions: int = 0
    num_preempted_tokens: int = 0  # speculation dropped at preemption
    cached_prefix_tokens: int = 0  # prompt tokens served by the prefix cache
    # stats
    num_rollbacks: int = 0
    num_recomputed_tokens: int = 0
    num_verify_passes: int = 0
    num_cascaded_windows: int = 0  # windows discarded by cascade rollbacks
    prefill_time: float = -1.0
    finish_time: float = -1.0
    # stream-clock latency marks (obs.metrics TTFT/TPOT/e2e histograms):
    # set at submit / first committed token, read at retirement
    submit_clock: float = -1.0
    first_token_clock: float = -1.0
    # encdec / multimodal payloads (stub-frontend outputs)
    enc_embeds: Optional[object] = None
    prefix_embeds: Optional[object] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def prefill_remaining(self) -> int:
        """Input positions still to be written (0 once prefill completes)."""
        return max(0, self.prefill_total - self.prefill_pos)

    @property
    def num_output(self) -> int:
        """Committed output length (what the user has received)."""
        return len(self.committed)

    @property
    def inflight_cands(self) -> List[int]:
        """All in-flight window candidates, submission (= sequence) order."""
        return [t for fl in self.pipeline for t in fl.cands]

    @property
    def speculation(self) -> List[int]:
        """All uncommitted tokens in sequence order (in-flight FIFO first)."""
        return self.inflight_cands + self.candidates

    @property
    def total_generated(self) -> int:
        return len(self.committed) + len(self.inflight_cands) + len(self.candidates)

    def done_decoding(self) -> bool:
        """All tokens generated (committed + speculation reach the budget)."""
        if self.total_generated >= self.sampling.max_new_tokens:
            return True
        eos = self.sampling.eos_id
        if eos is not None and (
            eos in self.committed
            or eos in self.candidates
            or eos in self.inflight_cands
        ):
            return True
        return False

    def finished(self) -> bool:
        if self.num_output >= self.sampling.max_new_tokens:
            return True
        eos = self.sampling.eos_id
        if eos is not None and eos in self.committed:
            return True
        return False
