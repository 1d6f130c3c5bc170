"""The LLM-42 serving engine: continuous batching + selective determinism.

PyTorch counterpart of ``repro.serving.engine``, main-path subset.  Three
modes (paper §5 baselines):

  * ``Mode.NONDET``           — fast path only; schedules vary with the
                                dynamic batch size.
  * ``Mode.BATCH_INVARIANT``  — one universal schedule for every op.
  * ``Mode.LLM42``            — fast path for everyone + decode-verify-
                                rollback for requests with
                                ``is_deterministic=True``.

What is ported: all three modes and scheduler policies (pause, overlap,
adaptive), any ``spec_depth``, exclusive and chunked prefill, decode,
grouped verify, the fused mixed-batch step, both clocks of the dual-stream
runtime (the logical clock by default; the costed clock behind
``verify_latency_ms`` and ``bind_cost_model``, priced by
``serving.costmodel`` at ``cost_cfg``'s scale on ``hw``, default
``costmodel.H100``), and the
memory lanes the engine calls (block-pool admission, preemption with
restore-by-recompute, the radix prefix cache).  The host protocol is the
JAX engine's, line for line where it can be.

Both memory lanes: ``paged_attention=True`` (the default) reads and writes
the KV pool in place through the block tables
(``models.layers.attention_paged``); ``paged_attention=False`` is the
gathered lane, which copies each row's blocks into a dense view, runs the
forward on it (``models.layers.attention_cached``) and scatters it back
(``serving.kv_cache.pool_forward``).  Committed LLM42 streams are bitwise
equal between the lanes.  Greedy and seeded sampling
(``serving.sampler``).

Every device step runs as one program per shape class
(``serving.programs``), keyed as the JAX engine's ``_fns`` are:
``("decode", B, schedule)``, ``("prefill", P)``, ``("prefill_chunk", C)``
(``"prefill_chunk_rec"`` on a recurrent config), ``("cross", Se)`` and
``("fused", C, B, schedule, n_groups)``, plus ``("verify", G, W)``, the
counterpart of ``make_verify_fn``.  On the card a program is a CUDA graph,
captured at its key's first step and replayed after that; on the CPU it
runs its body on the same input buffers; under ``programs.eager()`` it
calls its body directly.  The host prepares each step's inputs as host
tensors (slots, tables, tokens, positions, sampling parameters), checked
on the host, and the program copies them into its buffers.  What differs:
the JAX engine threads an immutable pool through its programs; here the
pool, the state pool's buffers and the cross caches are updated in place
and keep their addresses, which a replayed graph needs.  An iteration of
more than one sub-pass runs the ``fused`` program, the prefill-chunk,
decode and verify bodies one after the other on the shared pool; a single
sub-pass runs its own lane's program, as in the reference's dispatch.
Device work runs under ``core.determinism.deterministic_torch`` (pad rows
write the scratch block through duplicate indices).  On the card every
GEMM runs in the two hand-written GEMMs and single-token attention in the
paged kernels (paged lane) or the dense-cache decode kernel (gathered
lane).

Served families: dense and MoE (``first_k_dense`` head layers included),
with full or sliding-window attention, the recurrent ssm family (rwkv6),
the hybrid family (jamba: attention and mamba layers in a stacked block
period), the encoder-decoder family (seamless-m4t) and prefix embeddings
(llava-next).  A sliding config keeps per-slot rings (``window + RING_SLACK``
slots) in place of paged KV, so it has no paged lane and no prefix cache;
its prefill runs in chunks the ring contract allows (``_ring_pass_cap``).
A recurrent config keeps O(1) state per slot, advanced irreversibly by the
fast path: the double-buffered state pool (``serving.statepool``) carries
the verify replay's anchor and one commit checkpoint per in-flight window,
so speculation runs ``spec_depth`` windows deep; its prefill passes keep
the state after their last real position (pads never enter it), and it
has no prefix cache (rwkv, with slot leaves only, has no paged lane
either).  A hybrid config pages its attention layers' KV and keeps its
mamba layers' ``conv`` and ``ssm`` state in slot leaves of the same pool:
one verify pass repairs the KV and selects the per-position states
together.  An encoder-decoder
request carries ``enc_embeds`` (1, Se, D): at admission, and again on
every restore, the encoder runs once under ``VERIFY_SCHEDULE`` at B = 1 in
every mode (``_build_cross``) and its cross K/V fill the slot's
read-only ``cross`` leaves.  A prefix-embeds request carries
``prefix_embeds`` (1, P, D) (zeros when absent): they take KV positions
[0, P) before the prompt, every prefill pass (exclusive, chunked, restore
replay) feeds them again (``_chunk_embeds``), and every position count
(capacity, blocks, decode and verify positions, prefill events) includes
them.  Neither config shares prefixes: the radix key sees tokens, not these
side inputs.

``tp`` is the fast path's logical tensor-parallel width: decode passes run
with ``tp_shards=tp`` un-pinned (``kernels.ops.matmul`` folds the chunks in
the split-K kernel), while the commit path replays under
``VERIFY_SCHEDULE``'s pinned tree, so committed streams are the same at
every ``tp`` dividing ``CANONICAL_TP_SHARDS``; other widths are refused.
"""

from __future__ import annotations

import functools
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Set

import torch

from repro_torch.core import dvr, pipeline
from repro_torch.core.determinism import (
    CANONICAL_TP_SHARDS,
    FAST_PATH_POLICY,
    INVARIANT_SCHEDULE,
    Mode,
    ReductionPolicy,
    Schedule,
    VERIFY_SCHEDULE,
    deterministic_torch,
)
from repro_torch.core.verifier import make_verify_body
from repro_torch.models.base import ModelConfig, check_ported
from repro_torch.models.transformer import RING_SLACK, build_cross_cache
from repro_torch.obs import Observability, TokenProvenance
from repro_torch.serving import (
    blockpool, costmodel, kv_cache, prefixcache, programs, statepool, streams,
)
from repro_torch.serving import scheduler as sched
from repro_torch.serving.request import Request, State
from repro_torch.serving.sampler import sample_batch, sample_token, top2_margin


_M32 = 0xFFFFFFFF


def _host(values, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """A program input built on the host (the program copies it to its
    device buffer)."""
    return torch.tensor(values, dtype=dtype)


def _sampling_inputs(params) -> tuple:
    """(seeds int64 mod 2**32, temperatures f32, top_ks int64) host tensors
    of the rows' ``SamplingParams``."""
    return (_host([p.seed & _M32 for p in params], torch.int64),
            _host([p.temperature for p in params], torch.float32),
            _host([p.top_k for p in params], torch.int64))


def _bucket(n: int) -> int:
    """Next power-of-two bucket (>= 8) for prompt padding."""
    b = 8
    while b < n:
        b *= 2
    return b


def weak_pull(owner: Any, read: Callable[[Any], float]) -> Callable[[], float]:
    """A pull gauge's callback returning ``read(owner)``, holding ``owner``
    by a weak reference, so that a registry the owner holds keeps no
    reference cycle through it; it reads 0 once the owner is gone."""
    ref = weakref.ref(owner)

    def fn() -> float:
        obj = ref()
        return 0 if obj is None else read(obj)

    return fn


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict,
        *,
        mode: Mode = Mode.LLM42,
        policy: ReductionPolicy = FAST_PATH_POLICY,
        window: int = 8,  # verification window W (verifies W-1 candidates)
        group: int = 4,  # requests verified together (grouped verification)
        max_batch: int = 8,
        capacity: Optional[int] = None,
        scheduler: Optional[sched.SchedulePolicy] = None,
        spec_depth: int = 1,  # verify windows in flight per request
        verify_latency_ms: Optional[float] = None,  # continuous verdict latency
        cost_cfg: Optional[ModelConfig] = None,  # config the stream clocks cost at
        hw: costmodel.Hardware = costmodel.H100,
        prefill_chunk: int = 0,  # tokens per prefill chunk; 0 = exclusive
        block_size: int = blockpool.DEFAULT_BLOCK_SIZE,  # KV tokens per block
        num_blocks: Optional[int] = None,  # pool size; None = dense parity
        prefix_cache: bool = True,  # share committed-prefix KV blocks
        mem_policy: Optional[sched.BlockMemoryPolicy] = None,
        paged_attention: bool = True,  # in-place paged forward; False = gathered views
        trace: bool = False,  # dual-stream request tracing (obs.trace)
        audit: bool = False,  # per-token determinism audit (obs.audit)
        tp: int = 1,  # fast-path tensor-parallel width
    ):
        check_ported(cfg)
        # Logical TP width of the FAST PATH: decode schedules carry
        # tp_shards=tp un-pinned (the chunk-order combine a width-tp ring
        # all-reduce would produce).  The commit path never reads it: the
        # verify body closes over VERIFY_SCHEDULE, whose pinned balanced tree
        # every power-of-two width dividing CANONICAL_TP_SHARDS realizes
        # bitwise.
        if not (tp >= 1 and CANONICAL_TP_SHARDS % tp == 0):
            raise ValueError(
                f"tp={tp} must divide the canonical shard count "
                f"{CANONICAL_TP_SHARDS} for the commit tree to be realizable")
        assert spec_depth >= 1, "at least one verify window must be allowed"
        assert prefill_chunk >= 0, "prefill_chunk must be >= 0 (0 = exclusive)"
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.mode = mode
        self.policy = policy
        self.window = window
        self.group = group
        self.max_batch = max_batch
        self.capacity = capacity or cfg.max_seq_len
        self.pool = kv_cache.CachePool(
            cfg, max_batch, self.capacity, device=self.device,
            block_size=block_size, num_blocks=num_blocks,
        )
        # commit-aware prefix sharing needs paged full-attention KV to share
        # (a sliding config's rings are per slot), a token-addressable
        # position 0 (prefix embeds and cross caches are per-request side
        # inputs the radix key cannot see) and no recurrent state (an O(1)
        # state at the match point cannot be rebuilt from shared KV)
        shareable = (
            self.pool.paged
            and not statepool.has_recurrent_state(cfg)
            and not cfg.num_prefix_embeds
            and cfg.family != "encdec"
        )
        self.prefix_cache: Optional[prefixcache.PrefixCache] = (
            prefixcache.PrefixCache(self.pool.block_size)
            if (prefix_cache and shareable) else None
        )
        self.mem_policy = mem_policy or sched.BlockMemoryPolicy()
        # recurrent archs advance their state irreversibly on the fast path;
        # the state pool carries the verify replay anchor + per-window
        # rollback checkpoints so speculation can run spec_depth windows
        # deep.  For attention archs it is host-side telemetry only.
        self.has_recurrent_state = statepool.has_recurrent_state(cfg)
        self.spec_depth = int(spec_depth)
        self.statepool = statepool.StatePool(cfg, max_batch, self.spec_depth,
                                             device=self.device)
        self.scheduler = scheduler if scheduler is not None else sched.default_policy(mode)
        assert verify_latency_ms is None or verify_latency_ms >= 0.0
        self.verify_latency_ms = verify_latency_ms
        self.hw = hw
        self.tp = int(tp)
        # the logical clock (1 tick per iteration, verdicts 1 tick after
        # launch) unless verify_latency_ms is given or bind_cost_model() is
        # called (run_online does): then the costed clock, continuous
        # main/verify stream times from the cost model
        self.runtime = streams.DualClockRuntime(latency=1.0)
        if verify_latency_ms is not None:
            self.bind_cost_model(cost_cfg or cfg, hw)
        self.prefill_chunk = int(prefill_chunk)
        self.chunked_prefill = self.prefill_chunk > 0

        self.queue: List[Request] = []
        self.running: List[Request] = []
        self.preempted: List[Request] = []  # blocks evicted, restore pending
        self.finished: List[Request] = []
        self.events: List[Dict[str, Any]] = []
        # a pool without paged leaves (sliding rings only) has no paged lane
        self._paged_fwd = self.pool.paged and bool(paged_attention)
        self._verify_body = make_verify_body(
            cfg, group, window, self.pool.layout, paged=self._paged_fwd)
        # one program per shape class (serving.programs), the reference's
        # _fns cache plus its verify program
        self._programs: Dict[Any, programs.Program] = {}
        self._pad_row: Optional[torch.Tensor] = None
        self._now = 0  # logical iteration counter
        self.num_preemptions = 0
        self.num_restores = 0
        self.num_cross_builds = 0  # encoder passes (admissions + restores)
        self.restored_tokens = 0
        self.peak_running = 0
        self.obs = Observability(trace=trace, audit=audit)
        self._register_metrics()

    # ------------------------------------------------------------------
    # stream clocks
    # ------------------------------------------------------------------

    def bind_cost_model(
        self,
        cost_cfg: ModelConfig,
        hw: Optional[costmodel.Hardware] = None,
        *,
        invariant: bool = False,
    ) -> None:
        """Switch the runtime to a costed clock: stream times come from the
        cost model evaluated at ``cost_cfg``'s scale on ``hw`` (default the
        engine's, ``costmodel.H100`` unless given), so a reduced model can
        be scheduled on the full model's clock.  Must happen before the
        first step: rebinding mid-run would tear the clock.

        Verdict latency under a costed clock is ``verify_latency_ms``
        (default 0: a verdict is visible as soon as the verify-stream pass
        completes)."""
        assert getattr(self, "_now", 0) == 0, "bind the clock before stepping"
        hw = hw or self.hw
        self.hw = hw

        tp = self.tp  # read now: the engine holds this runtime, which must not hold it

        def cost_fn(ev: Dict[str, Any]) -> float:
            if invariant:
                ev = dict(ev, invariant=True)
            if tp > 1 and "tp" not in ev:
                ev = dict(ev, tp=tp)
            return costmodel.step_time(cost_cfg, ev, hw)

        self.runtime = streams.DualClockRuntime(
            cost_fn,
            latency=(self.verify_latency_ms or 0.0) / 1e3,
            contention=hw.stream_contention,
        )

    # ------------------------------------------------------------------
    # observability (repro_torch.obs)
    # ------------------------------------------------------------------

    def _register_metrics(self) -> None:
        """Register every engine series with the metrics registry.  Pull
        gauges read attributes of the engine at snapshot time, never the
        objects themselves (``bind_cost_model`` replaces ``self.runtime``
        wholesale), and reach it through a weak reference
        (``weak_pull``): a closure over ``self`` kept in the
        engine's own registry would hold the engine and its pool in a
        reference cycle, freed only by the next collection."""
        m = self.obs.metrics
        pull = functools.partial(weak_pull, self)
        self._c_iters = m.counter(
            "engine.iterations", unit="iterations",
            help="scheduler iterations stepped")
        self._c_submitted = m.counter(
            "engine.requests_submitted", unit="requests",
            help="requests submitted to the engine")
        self._c_finished = m.counter(
            "engine.requests_finished", unit="requests",
            help="requests retired")
        self._c_fused = m.counter(
            "engine.fused_steps", unit="launches",
            help="iterations whose whole device side ran as one fused "
                 "mixed-batch step")
        m.gauge_fn("engine.running", pull(lambda e: len(e.running)),
                   unit="requests", help="requests in the running set")
        m.gauge_fn("engine.queued", pull(lambda e: len(e.queue)),
                   unit="requests", help="requests awaiting admission")
        m.gauge_fn("engine.preempted", pull(lambda e: len(e.preempted)),
                   unit="requests", help="requests evicted, restore pending")
        m.gauge_fn("engine.peak_running", pull(lambda e: e.peak_running),
                   unit="requests", help="peak concurrent running requests")
        self._c_committed = m.counter(
            "tokens.committed", unit="tokens",
            help="tokens committed across all requests (prefill T0 + "
                 "direct decode commits + verify splices)")
        self._c_recomputed = m.counter(
            "tokens.recomputed", unit="tokens",
            help="speculated tokens rejected by verification")
        self._c_windows = m.counter(
            "verify.windows_submitted", unit="windows",
            help="verify windows moved into in-flight FIFOs (deferred path)")
        self._c_passes = m.counter(
            "verify.passes", unit="verdicts",
            help="verify verdicts applied (sync passes + pipelined splices)")
        self._c_rollbacks = m.counter(
            "verify.rollbacks", unit="rollbacks",
            help="verdicts that rejected at least one speculated token")
        self._c_cascaded = m.counter(
            "verify.cascaded_windows", unit="windows",
            help="in-flight windows discarded by cascade invalidation")
        self._h_rollback_depth = m.histogram(
            "verify.rollback_depth", unit="tokens",
            help="tokens rejected per rolling-back verdict")
        self._h_acceptance = m.histogram(
            "verify.acceptance_ema", unit="fraction",
            help="per-request acceptance EMA at retirement (det requests)")
        m.gauge_fn("verify.inflight",
                   pull(lambda e: sum(len(r.pipeline) for r in e.running)),
                   unit="windows", help="verify windows currently in flight")
        m.gauge_fn("streams.main_busy", pull(lambda e: e.runtime.main.busy),
                   unit="s", help="main-stream busy time (costed clock)")
        m.gauge_fn("streams.verify_busy", pull(lambda e: e.runtime.verify.busy),
                   unit="s", help="verify-stream busy time (costed clock)")
        m.gauge_fn("streams.makespan", pull(lambda e: e.runtime.makespan),
                   unit="s", help="completion time of all scheduled work")
        m.gauge_fn("streams.verify_backlog",
                   pull(lambda e: e.runtime.verify_backlog),
                   unit="s", help="verify-stream work scheduled past now")
        m.gauge_fn("streams.outstanding_verdicts",
                   pull(lambda e: e.runtime.outstanding_verdicts),
                   unit="verdicts", help="verdicts launched but not yet due")
        m.gauge_fn("streams.peak_outstanding",
                   pull(lambda e: e.runtime.peak_outstanding),
                   unit="verdicts", help="deepest verdict queue seen")
        m.gauge_fn("mem.preemptions", pull(lambda e: e.num_preemptions),
                   unit="preemptions", help="requests evicted under pressure")
        m.gauge_fn("mem.restores", pull(lambda e: e.num_restores),
                   unit="restores", help="preempted requests re-admitted")
        m.gauge_fn("mem.restored_tokens", pull(lambda e: e.restored_tokens),
                   unit="tokens", help="positions replayed by restores")
        m.gauge_fn("blockpool.block_size", pull(lambda e: e.pool.block_size),
                   unit="tokens", help="KV positions per block")
        m.gauge_fn("blockpool.num_blocks",
                   pull(lambda e: e.pool.alloc_blocks.num_blocks),
                   unit="blocks", help="total pool blocks")
        m.gauge_fn("blockpool.blocks_in_use",
                   pull(lambda e: e.pool.alloc_blocks.in_use()),
                   unit="blocks", help="blocks currently referenced")
        m.gauge_fn("blockpool.peak_blocks_in_use",
                   pull(lambda e: e.pool.alloc_blocks.peak_in_use),
                   unit="blocks", help="peak referenced blocks")
        m.gauge_fn("blockpool.free_blocks",
                   pull(lambda e: e.pool.alloc_blocks.num_free()),
                   unit="blocks", help="immediately free blocks")
        m.gauge_fn("blockpool.paged", pull(lambda e: int(e.pool.paged)),
                   help="1 when full-attention KV is paged")
        if self.prefix_cache is not None:
            def _pc(key: str):
                return pull(lambda e: e.prefix_cache.stats()[key])
            m.gauge_fn("prefixcache.hits", _pc("prefix_hits"),
                       unit="lookups", help="admissions matching >= 1 block")
            m.gauge_fn("prefixcache.misses", _pc("prefix_misses"),
                       unit="lookups", help="admissions matching 0 blocks")
            m.gauge_fn("prefixcache.hit_tokens", _pc("prefix_hit_tokens"),
                       unit="tokens", help="prompt tokens served from cache")
            m.gauge_fn("prefixcache.insertions", _pc("prefix_insertions"),
                       unit="blocks", help="blocks registered with the radix")
            m.gauge_fn("prefixcache.evictions", _pc("prefix_evictions"),
                       unit="blocks", help="cached blocks reclaimed LRU")
            m.gauge_fn("prefixcache.size_blocks", _pc("prefix_size_blocks"),
                       unit="blocks", help="blocks resident in the cache")
        if hasattr(self.scheduler, "num_demotions"):
            m.gauge_fn("scheduler.demotions",
                       pull(lambda e: e.scheduler.num_demotions),
                       unit="transitions",
                       help="adaptive demotions to sync verification")
            m.gauge_fn("scheduler.promotions",
                       pull(lambda e: e.scheduler.num_promotions),
                       unit="transitions",
                       help="adaptive promotions back to overlap")
        self._h_ttft = m.histogram(
            "latency.ttft", unit="s",
            help="submit to first committed token (stream clock)")
        self._h_tpot = m.histogram(
            "latency.tpot", unit="s",
            help="mean inter-token time past T0 (stream clock)")
        self._h_e2e = m.histogram(
            "latency.e2e", unit="s",
            help="submit to retirement (stream clock)")

    def _charge_main(self, ev: Dict[str, Any]) -> None:
        """Charge one main-stream pass and record its trace slice."""
        self.runtime.charge(ev)
        tr = self.obs.tracer
        if tr.enabled:
            tr.pass_span("main", ev["kind"], self.runtime.last_main_span,
                         self._trace_args(ev))

    @staticmethod
    def _trace_args(ev: Dict[str, Any]) -> Dict[str, Any]:
        """Scalar-only view of an engine event for trace-slice args."""
        return {
            k: (list(v) if k == "rids" else v)
            for k, v in ev.items()
            if k not in ("wall",)
            and isinstance(v, (int, float, str, bool, list, tuple))
        }

    def _note_t0(self, req: Request, margin: Optional[float] = None) -> None:
        """Metrics + audit for the T0 token a prefill pass just committed
        (sampled under the verify-grade schedule in every mode)."""
        self._c_committed.inc()
        if req.first_token_clock < 0:
            req.first_token_clock = self.runtime.now
        au = self.obs.audit
        if au.enabled:
            # bound inline, as in every prefill builder, so that the
            # determinism checker's taint pass resolves it
            schedule = (
                INVARIANT_SCHEDULE if self.mode == Mode.BATCH_INVARIANT
                else VERIFY_SCHEDULE
            )
            au.record(TokenProvenance(
                rid=req.rid, index=len(req.committed) - 1,
                token=req.committed[-1], origin="prefill",
                schedule=schedule, margin=margin,
            ))

    def _note_splice(self, req: Request, outcome: pipeline.SpliceOutcome) -> None:
        """Metrics + trace + audit for one pipelined front splice."""
        fl = outcome.record
        self._c_passes.inc()
        self._c_committed.inc(outcome.committed_count)
        if outcome.rejected:
            self._c_rollbacks.inc()
            self._c_recomputed.inc(outcome.rejected)
            self._h_rollback_depth.observe(outcome.rejected)
        if outcome.cascaded:
            self._c_cascaded.inc(len(outcome.cascaded))
        tr = self.obs.tracer
        if tr.enabled:
            tr.instant(
                "rollback" if outcome.rolled_back else "commit",
                t=self.runtime.now, rid=req.rid, window=fl.seq,
                n_match=fl.n_match, committed=outcome.committed_count,
                rejected=outcome.rejected, cascaded=len(outcome.cascaded),
            )
        if req.first_token_clock < 0 and req.committed:
            req.first_token_clock = self.runtime.now
        au = self.obs.audit
        if not au.enabled:
            return
        n = min(fl.n_match, len(fl.cands))
        for j in range(outcome.committed_count):
            idx = outcome.committed_base + j
            au.record(TokenProvenance(
                rid=req.rid, index=idx, token=req.committed[idx],
                origin="verify", schedule=VERIFY_SCHEDULE,
                window=fl.seq, occurrence=fl.ring_idx,
                n_match=fl.n_match, accepted=j < n,
                rollback=outcome.rolled_back,
                cascaded=len(outcome.cascaded), shifted=fl.shifted,
                margin=(fl.margins[j]
                        if fl.margins and j < len(fl.margins) else None),
            ))

    # ------------------------------------------------------------------
    # device steps: one program per shape class (the pool is updated in
    # place)
    # ------------------------------------------------------------------

    def _program(self, key: Any, fn: Callable[..., Any]) -> programs.Program:
        """The program of ``key``, made at the key's first step: ``fn(engine,
        *inputs)`` is its body.  The program reaches the engine through a
        weak reference, so that the engine holds no reference cycle through
        its own programs (a dropped engine frees its pool at once)."""
        prog = self._programs.get(key)
        if prog is None:
            ref = weakref.ref(self)
            prog = programs.Program(key, lambda *args: fn(ref(), *args), self.device)
            self._programs[key] = prog
        return prog

    def _slot_index(self, slots: List[int]) -> torch.Tensor:
        """A pass's slot index, checked on the host (``check_slots``)."""
        return kv_cache.slot_index(self.pool.data, self.pool.layout, slots,
                                   torch.device("cpu"))

    def _check_view(self, starts: List[int], width: int) -> None:
        """The gathered lane's view-capacity check, on the host."""
        if not self._paged_fwd and self.cfg.attn_kind != "sliding":
            kv_cache.check_view(self.pool.layout, starts, width)

    def _sync(self) -> None:
        """Wait for the device, so a wall time covers the device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, params, pool, slots, tables, start_pos, schedule, **inputs):
        """One forward over the pool in this engine's memory lane."""
        return kv_cache.pool_forward(
            params, self.cfg, self.pool.layout, pool, slots, tables, start_pos,
            schedule, paged=self._paged_fwd, **inputs)

    def _state_at(self, last: torch.Tensor) -> Optional[torch.Tensor]:
        """A prefill pass's ``state_at``: on a recurrent config the state
        kept is the one after the pass's last real position, so padding
        never enters it; None (no per-position states) otherwise."""
        return last.reshape(1) if self.has_recurrent_state else None

    def _decode_body(self, batch_size: int, schedule: Schedule):
        """One-token decode over the pool through the block tables.  The
        slots and sampling parameters are host sequences or (B,) tensors
        (the program's inputs)."""

        def step(params, pool, slots, tables, tokens, pos, seeds, temps, out_pos,
                 top_ks):
            logits, pool = self._forward(params, pool, slots, tables, pos, schedule,
                                         tokens=tokens[:, None])
            nxt = sample_batch(logits[:, 0], seeds, out_pos, temps, top_ks)
            margins = top2_margin(logits[:, 0])
            return pool, nxt, margins

        return step

    # det: commit-path
    def _prefill_pass(self, idx: torch.Tensor, table: torch.Tensor,
                      last: torch.Tensor, **inputs):
        """Exclusive whole-prompt pass at the prompt's bucket (after the
        prefix embeds, if any), verify-grade schedule in every mode; the
        prompt comes as ``tokens`` or ``inputs_embeds``.  The JAX engine
        gathers a per-row view and runs the dense attention on it (the
        gathered lane here too); the paged forward computes the same masked
        softmax over the same view, reading through the table.  ``idx``:
        the slot index (1,); ``last``: the prompt's last position (a
        recurrent config's state is kept there)."""
        schedule = (
            INVARIANT_SCHEDULE if self.mode == Mode.BATCH_INVARIANT
            else VERIFY_SCHEDULE
        )
        start = torch.zeros(1, dtype=torch.int32, device=table.device)
        logits, _ = self._forward(
            self.params, self.pool.data, idx, table[None], start,
            schedule=schedule, state_at=self._state_at(last), **inputs)
        return logits

    def _prefill_fn(self, P: int) -> programs.Program:
        """The ``("prefill", P)`` program: the exclusive pass at bucket P
        and T0's sample at the prompt's last position, on the device (the
        reference's ``_prefill_fn``).  Inputs: the slot index, the table,
        the prompt (``(1, P)`` tokens, or ``(1, prefix + P, D)`` embeds for
        a prefix-embeds config), the last position and the sampling
        parameters (1,); outputs ``(tok, margin)``, each (1,)."""
        embeds = bool(self.cfg.num_prefix_embeds)

        def step(eng, idx, table, x, last, seed, temp, top_k):
            inputs = {"inputs_embeds": x} if embeds else {"tokens": x}
            logits = eng._prefill_pass(idx, table, last, **inputs)
            row = logits[0].index_select(0, last.reshape(1).long())
            zero = torch.zeros(1, dtype=torch.int64, device=row.device)
            return sample_batch(row, seed, zero, temp, top_k), top2_margin(row)

        return self._program(("prefill", P), step)

    # det: commit-path
    def _prefill_chunk_body(self, C: int):
        """Fixed-shape C-token prefill chunk, verify-grade schedule.  A
        recurrent config keeps the state after ``last``, the chunk's final
        real position, so final-chunk pads never advance it: the chunk
        schedule stays size-invariant.  ``idx`` is the slot index (1,)."""
        schedule = (
            INVARIANT_SCHEDULE if self.mode == Mode.BATCH_INVARIANT
            else VERIFY_SCHEDULE
        )

        def chunk(params, pool, idx, table, embeds, start, last):
            logits, pool = self._forward(params, pool, idx, table[None],
                                         start[None], schedule=schedule,
                                         inputs_embeds=embeds,
                                         state_at=self._state_at(last))
            return pool, logits

        return chunk

    def _prefill_chunk_fn(self, C: int) -> programs.Program:
        """The ``("prefill_chunk", C)`` program (``"prefill_chunk_rec"`` on
        a recurrent config, as in the reference): the chunk's logits."""
        rec = self.has_recurrent_state
        key = ("prefill_chunk_rec" if rec else "prefill_chunk", C)
        return self._program(key, lambda eng, *args: eng._prefill_chunk_body(C)(
            eng.params, eng.pool.data, *args)[1])

    def _decode_fn(self, B: int, schedule: Schedule) -> programs.Program:
        """The ``("decode", B, schedule)`` program: ``(tokens, margins)``."""
        return self._program(("decode", B, schedule), lambda eng, *args: eng._decode_body(
            B, schedule)(eng.params, eng.pool.data, *args)[1:])

    def _verify_outs(self, args):
        """One grouped verify body on the pool: ``(n_match, commit_tok,
        margins, commit_rows)``.  A recurrent config's replay starts from
        the state pool's anchor and advances it in place; its
        ``commit_rows`` (each row's commit-index state) go to the ring,
        else None."""
        if self.has_recurrent_state:
            (_, _, commit_rows, n_match, commit_tok, _v, margins) = self._verify_body(
                self.params, self.pool.data, self.statepool.anchor, *args)
        else:
            _, n_match, commit_tok, _v, margins = self._verify_body(
                self.params, self.pool.data, *args)
            commit_rows = None
        return n_match, commit_tok, margins, commit_rows

    def _verify_fn(self) -> programs.Program:
        """The ``("verify", G, W)`` program, the counterpart of the
        reference's ``make_verify_fn``."""
        return self._program(("verify", self.group, self.window),
                             lambda eng, *args: eng._verify_outs(args))

    def _cross_fn(self, Se: int) -> programs.Program:
        """The ``("cross", Se)`` program: the encoder and every decoder
        layer's cross K/V at B = 1 under ``VERIFY_SCHEDULE``."""
        return self._program(("cross", Se), lambda eng, enc: build_cross_cache(
            eng.params, eng.cfg, enc, schedule=VERIFY_SCHEDULE))

    def _fused_fn(self, C: Optional[int], B: int, schedule: Schedule,
                  n_groups: int) -> programs.Program:
        """ONE program for the iteration's whole mixed batch (the
        reference's ``_fused_fn``): the current prefill chunk (``C`` tokens,
        or None), the decode batch (``B`` rows, or 0) and ``n_groups`` due
        verify groups as sequential sub-passes on the shared pool (and the
        state pool's anchor), each its standalone body under its own
        schedule, so fusing moves no committed token.  Returns
        ``(logits_p, nxt, dmarg, vouts)``."""

        def fused(eng, pargs, dargs, vargs_list):
            logits_p = nxt = dmarg = None
            if C is not None:
                _, logits_p = eng._prefill_chunk_body(C)(eng.params, eng.pool.data, *pargs)
            if B:
                _, nxt, dmarg = eng._decode_body(B, schedule)(
                    eng.params, eng.pool.data, *dargs)
            vouts = [eng._verify_outs(vargs) for vargs in vargs_list]
            return logits_p, nxt, dmarg, vouts

        return self._program(("fused", C, B, schedule, n_groups), fused)

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self._check_side_inputs(req)
        # KV positions before the prompt (core.dvr reads it for verify rows)
        req._prefix_len = self.cfg.num_prefix_embeds
        self._check_capacity(req)
        req.state = State.QUEUED
        req.submit_clock = self.runtime.now
        self.queue.append(req)
        self._c_submitted.inc()
        tr = self.obs.tracer
        if tr.enabled:
            tr.request_begin(req.rid, req.submit_clock)
            tr.instant("submit", t=req.submit_clock, rid=req.rid,
                       prompt_len=req.prompt_len,
                       deterministic=req.sampling.is_deterministic)

    def _check_side_inputs(self, req: Request) -> None:
        """Raise unless the request carries the side inputs its config
        takes, at their shapes: ``enc_embeds`` (1, encoder_seq_len,
        d_model) for an encoder-decoder config (required), ``prefix_embeds``
        (1, num_prefix_embeds, d_model) for a prefix-embeds one (optional:
        zeros stand in)."""
        cfg = self.cfg
        want = {}
        if cfg.family == "encdec":
            if req.enc_embeds is None:
                raise ValueError(f"request {req.rid}: an encoder-decoder config "
                                 "needs enc_embeds")
            want["enc_embeds"] = (1, cfg.encoder_seq_len, cfg.d_model)
        if cfg.num_prefix_embeds and req.prefix_embeds is not None:
            want["prefix_embeds"] = (1, cfg.num_prefix_embeds, cfg.d_model)
        for name, shape in want.items():
            got = tuple(getattr(req, name).shape)
            if got != shape:
                raise ValueError(f"request {req.rid}: {name} {got}, want {shape}")

    def _worst_need(self, req: Request) -> int:
        """Worst-case KV positions this request can ever occupy (the max of
        the prefill extent and prefix + prompt + output budget + the
        ``spec_depth x (W-1) + 1`` verify-row reservation)."""
        prefix = self.cfg.num_prefix_embeds
        L = prefix + req.prompt_len
        if self._use_chunked(req):
            C = self._chunk_size()
            extent = -(-L // C) * C  # the last chunk pads to the chunk shape
        else:
            extent = prefix + _bucket(req.prompt_len)
        spec = (
            self.spec_depth * (self.window - 1) + 1
            if self.mode == Mode.LLM42 and req.sampling.is_deterministic
            else 0
        )
        return max(extent, L + req.sampling.max_new_tokens + spec)

    def _check_capacity(self, req: Request) -> None:
        """Reject a request whose worst-case footprint exceeds the
        per-request block-table reach or the whole pool.  A config without
        full attention (sliding rings wrap, recurrent state is O(1)) rejects
        nothing."""
        if not self.pool.paged:
            return
        need = self._worst_need(req)
        total_blocks = self.pool.alloc_blocks.num_blocks
        need_blocks = self._blocks_for(need)
        if need > self.capacity or need_blocks > total_blocks:
            raise ValueError(
                f"request {req.rid} cannot fit the KV pool: "
                f"max(prefill extent, prompt "
                f"{self.cfg.num_prefix_embeds + req.prompt_len} + "
                f"max_new_tokens {req.sampling.max_new_tokens} + verify "
                f"rows [depth {self.spec_depth} x (W-1) + 1]) = {need} "
                f"positions = {need_blocks} blocks > per-request capacity "
                f"{self.capacity} or pool {total_blocks} blocks of "
                f"{self.pool.block_size}"
            )

    def _ring_pass_cap(self, C: int) -> int:
        """``C`` capped, for a sliding config, at the longest pass the ring
        contract allows: ``window + RING_SLACK`` slots hold a pass of W
        tokens only if ``W + window - 1`` fit, so W <= RING_SLACK + 1.  The
        reference caps at ``window`` alone, which is the same cap wherever
        ``window <= RING_SLACK + 1`` and trips the ring contract's assertion
        above it (at every published window)."""
        if self.cfg.attn_kind == "sliding":
            C = min(C, self.cfg.window, RING_SLACK + 1)
        return C

    def _chunk_size(self) -> int:
        return max(1, self._ring_pass_cap(self.prefill_chunk))

    def _use_chunked(self, req: Request) -> bool:
        """Chunked lane only when the prefix and prompt span more than one
        chunk."""
        return (self.chunked_prefill
                and self.cfg.num_prefix_embeds + req.prompt_len > self._chunk_size())

    # ------------------------------------------------------------------
    # block-pool accounting, admission, preemption
    # ------------------------------------------------------------------

    def _blocks_for(self, positions: int) -> int:
        return -(-max(positions, 0) // self.pool.block_size)

    def _alloc_block(self) -> Optional[int]:
        """One free block, reclaiming LRU zero-ref prefix-cache blocks on
        demand.  None = pool genuinely exhausted (preemption's cue)."""
        alloc = self.pool.alloc_blocks
        bid = alloc.alloc()
        while bid is None and self.prefix_cache is not None:
            evicted = self.prefix_cache.evict_lru(alloc)
            if evicted is None:
                break
            self.pool.free_blocks([evicted])
            bid = alloc.alloc()
        return bid

    def _grow_blocks(self, req: Request, target_blocks: int) -> bool:
        while len(req.blocks) < target_blocks:
            bid = self._alloc_block()
            if bid is None:
                return False
            req.blocks.append(bid)
        return True

    def _ensure_blocks(self, req: Request, end_pos: int) -> bool:
        """Guarantee the table covers KV positions [0, end_pos), preempting
        LRU victims when the pool is dry.  False = unsatisfiable now."""
        if not self.pool.paged:
            return True
        target = self._blocks_for(min(end_pos, self.capacity))
        while not self._grow_blocks(req, target):
            cands = [
                r for r in self.running
                if r is not req and r.state is not State.PREFILLING
            ]
            victim = self.mem_policy.pick_victim(cands, self._now)
            if victim is None:
                return False
            self.preempt(victim)
        return True

    def _release_blocks(self, req: Request, *, insert: bool) -> None:
        """Drop the request's block references (``insert=True`` registers
        the committed-stream prefix with the radix cache first)."""
        alloc = self.pool.alloc_blocks
        if insert and self.prefix_cache is not None:
            stream = self._cacheable_stream(req)
            n = len(stream) // self.pool.block_size
            if n:
                self.prefix_cache.insert(stream, req.blocks[:n], self._now, alloc)
        freed = []
        for bid in req.blocks:
            if alloc.decref(bid) == 0 and bid not in alloc.cached:
                freed.append(bid)
        self.pool.free_blocks(freed)
        req.blocks = []
        req.blocks_shared = 0

    def _cacheable_stream(self, req: Request) -> List[int]:
        """The committed stream whose KV is deterministic AND resident: the
        prompt, plus committed output for deterministic traffic, minus the
        last committed token.  Never fast-path output."""
        det_out = (
            self.mode == Mode.BATCH_INVARIANT
            or (self.mode == Mode.LLM42 and req.sampling.is_deterministic)
        )
        if det_out and req.committed:
            return list(req.prompt) + list(req.committed[:-1])
        return list(req.prompt)

    def _insert_prompt_blocks(self, req: Request) -> None:
        if self.prefix_cache is None:
            return
        n = req.prompt_len // self.pool.block_size
        if n:
            self.prefix_cache.insert(
                req.prompt, req.blocks[:n], self._now, self.pool.alloc_blocks)

    def _admit(self) -> None:
        # restore lane first, gated by the memory policy's hysteresis
        while self.preempted and len(self.running) < self.max_batch:
            req = self.preempted[0]
            avail = self.pool.alloc_blocks.available() if self.pool.paged else 10 ** 9
            need = self._blocks_for(self._worst_need(req))
            if not self.mem_policy.may_restore(req, avail, need, self._now):
                break
            self.preempted.pop(0)
            self._restore(req)
        while self.queue and self.pool.num_free() > 0 and (
            len(self.running) < self.max_batch
        ):
            if not self._try_admit(self.queue[0]):
                break  # FIFO admission: the head waits for memory
            self.queue.pop(0)

    def _try_admit(self, req: Request) -> bool:
        """Admit one queued request if the block pool can cover its prompt:
        map the longest committed-prefix match to shared blocks, allocate
        private blocks for the tail, start prefill on the tail."""
        L = self.cfg.num_prefix_embeds + req.prompt_len
        alloc = self.pool.alloc_blocks
        matched: List[int] = []
        if self.prefix_cache is not None:
            matched = self.prefix_cache.match(req.prompt, self._now)
            # the boundary block is never shared: T0's position must run
            matched = matched[: (req.prompt_len - 1) // self.pool.block_size]
        if self.pool.paged:
            need = self._blocks_for(L) - len(matched)
            if not self.mem_policy.may_admit(alloc.available(), need):
                return False
        for bid in matched:
            alloc.incref(bid)
        req.blocks = list(matched)
        req.blocks_shared = len(matched)
        req.cached_prefix_tokens = len(matched) * self.pool.block_size
        if self.pool.paged and not self._grow_blocks(req, self._blocks_for(L)):
            self._release_blocks(req, insert=False)
            return False
        if self.prefix_cache is not None:
            self.prefix_cache.note_lookup(len(matched))
        req.slot = self.pool.alloc()
        cached = req.cached_prefix_tokens
        if cached:
            self.events.append({
                "kind": "cache_hit", "rid": req.rid, "tokens": cached,
                "iter": self._now,
            })
        tr = self.obs.tracer
        if tr.enabled:
            tr.instant("admit", t=self.runtime.now, rid=req.rid,
                       cached_tokens=cached, slot=req.slot)
        if self._use_chunked(req) or cached > 0:
            self._prepare_prefill(req)
            req.prefill_pos = cached
            req.state = State.PREFILLING
            if not self._use_chunked(req):
                self._prefill_tail_sync(req)
        else:
            self._prefill(req)
            req.state = State.RUNNING
        self.running.append(req)
        return True

    def _flush_pipeline(self, req: Request) -> None:
        """Force-apply every in-flight verdict in submission order.  Device
        state work is skipped: the caller is about to evict the slot's KV,
        and the restore replay rebuilds recurrent state from the committed
        stream."""
        for outcome in pipeline.apply_ready(req, self.window, float("inf")):
            self._note_splice(req, outcome)
            self.statepool.note_splice(req.slot, len(outcome.cascaded))
        self.statepool.note_preempt(req.slot)

    def preempt(self, req: Request) -> bool:
        """Evict a running request's KV blocks; its slot and committed
        stream survive, speculation is dropped, in-flight verdicts flushed
        first, so the later restore is bitwise identical."""
        if req not in self.running or req.state is State.PREFILLING:
            return False
        self._flush_pipeline(req)
        if req.finished():
            self._finish(req)
            return True
        dropped = len(req.candidates)
        req.candidates = []
        req.num_preempted_tokens += dropped
        req.num_preemptions += 1
        req.preempt_iter = self._now
        self._release_blocks(req, insert=True)
        req.state = State.PREEMPTED
        self.running.remove(req)
        self.preempted.append(req)
        self.num_preemptions += 1
        self.events.append({
            "kind": "preempt", "rid": req.rid, "iter": self._now,
            "dropped_tokens": dropped, "committed": len(req.committed),
        })
        tr = self.obs.tracer
        if tr.enabled:
            tr.instant("preempt", t=self.runtime.now, rid=req.rid,
                       dropped_tokens=dropped, committed=len(req.committed))
        return True

    def _restore(self, req: Request) -> None:
        """Re-admit a preempted request by deterministic recompute: replay
        prompt + committed[:-1] through the prefill lane (verify-grade
        schedule), re-matching blocks still resident in the prefix cache.
        The replay starts on a wiped slot: the slot survived preemption,
        but its ring or recurrent state holds the victim's post-speculation
        content; the replay rebuilds the state and, at its end, the replay
        anchor, bitwise as an un-preempted run holds them."""
        stream = list(req.prompt) + list(req.committed[:-1])
        self.pool.reset_slot(req.slot)
        alloc = self.pool.alloc_blocks
        matched: List[int] = []
        if self.prefix_cache is not None:
            matched = self.prefix_cache.match(stream, self._now)
        for bid in matched:
            alloc.incref(bid)
        req.blocks = list(matched)
        req.blocks_shared = len(matched)
        self._prepare_prefill(req, stream=stream)
        req.prefill_pos = len(matched) * self.pool.block_size
        req.replaying = True
        ok = not self.pool.paged or self._grow_blocks(
            req, self._blocks_for(self.cfg.num_prefix_embeds + len(stream)))
        assert ok, "restore gate admitted a replay the pool cannot hold"
        self.num_restores += 1
        replay = max(req.prefill_total - req.prefill_pos, 0)
        self.restored_tokens += replay
        self.events.append({
            "kind": "restore", "rid": req.rid, "iter": self._now,
            "replay_tokens": replay, "rematched_blocks": len(matched),
        })
        tr = self.obs.tracer
        if tr.enabled:
            tr.instant("restore", t=self.runtime.now, rid=req.rid,
                       replay_tokens=replay, rematched_blocks=len(matched))
        self.running.append(req)
        if req.prefill_pos >= req.prefill_total:
            self._finish_prefill(req, sample=False)
        else:
            req.state = State.PREFILLING
            if not self.chunked_prefill:
                self._prefill_tail_sync(req)

    def _prefill_tail_sync(self, req: Request) -> None:
        """Exclusive prefill of the remaining ``[prefill_pos,
        prefill_total)`` span at the tail's power-of-two bucket, capped by
        ``_ring_pass_cap`` (a sliding prompt runs several such passes)."""
        start = req.prefill_pos
        replay = req.replaying
        C = self._ring_pass_cap(_bucket(max(req.prefill_total - start, 1)))
        wall = 0.0
        while req.prefill_pos < req.prefill_total:
            wall += self._prefill_advance(req, C)["wall"]
        ev = {
            "kind": "prefill", "tokens": req.prefill_total - start,
            "padded": -(-(req.prefill_total - start) // C) * C,
            "wall": wall, "iter": self._now, "cached": start,
            "replay": replay,
        }
        self._charge_main(ev)
        self.events.append(ev)

    def mem_stats(self) -> Dict[str, Any]:
        """Memory telemetry read from the metrics registry."""
        snap = self.obs.metrics.snapshot()
        out: Dict[str, Any] = {
            "block_size": snap["blockpool.block_size"],
            "num_blocks": snap["blockpool.num_blocks"],
            "blocks_in_use": snap["blockpool.blocks_in_use"],
            "peak_blocks_in_use": snap["blockpool.peak_blocks_in_use"],
            "free_blocks": snap["blockpool.free_blocks"],
            "num_preemptions": snap["mem.preemptions"],
            "num_restores": snap["mem.restores"],
            "restored_tokens": snap["mem.restored_tokens"],
            "peak_running": snap["engine.peak_running"],
            "paged": bool(snap["blockpool.paged"]),
        }
        if self.prefix_cache is not None:
            out.update({
                "prefix_hits": snap["prefixcache.hits"],
                "prefix_misses": snap["prefixcache.misses"],
                "prefix_hit_tokens": snap["prefixcache.hit_tokens"],
                "prefix_insertions": snap["prefixcache.insertions"],
                "prefix_evictions": snap["prefixcache.evictions"],
                "prefix_size_blocks": snap["prefixcache.size_blocks"],
            })
        return out

    # det: commit-path
    def _build_cross(self, req: Request) -> None:
        """The encoder over the request's ``enc_embeds`` and every decoder
        layer's cross K/V, at B = 1 under ``VERIFY_SCHEDULE`` in every mode
        (a fixed shape: a restore's rebuild gives the first build's bits),
        written into the slot's cross leaves."""
        cfg = self.cfg
        enc = req.enc_embeds.to(device=self.device, dtype=getattr(torch, cfg.dtype))
        with deterministic_torch():
            cross = self._cross_fn(enc.shape[1])(enc)
            blockpool.write_cross(self.pool.data, req.slot, cross)
        self.num_cross_builds += 1

    def _prefix_source(self, req: Request) -> torch.Tensor:
        """The request's prefix embeddings (1, P, D) on the device in the
        model dtype (zeros when it carries none, as in the reference)."""
        cfg = self.cfg
        shape = (1, cfg.num_prefix_embeds, cfg.d_model)
        dtype = getattr(torch, cfg.dtype)
        if req.prefix_embeds is None:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return req.prefix_embeds.to(device=self.device, dtype=dtype)

    def _prepare_prefill(self, req: Request, stream: Optional[List[int]] = None) -> None:
        """Side inputs (the cross cache, the prefix embeds) and the chunk
        cursor for chunk-resumable prefill; ``stream`` overrides the fed
        tokens (a restore replays prompt + committed[:-1])."""
        cfg = self.cfg
        if cfg.family == "encdec":
            self._build_cross(req)
        if cfg.num_prefix_embeds:
            req._prefix_src = self._prefix_source(req)
        req.prefill_stream = list(stream) if stream is not None else list(req.prompt)
        req.prefill_total = cfg.num_prefix_embeds + len(req.prefill_stream)
        req.prefill_pos = 0

    def _chunk_embeds(self, req: Request, s: int, C: int) -> torch.Tensor:
        """Input embeddings for prefill positions [s, s+C): the prefix
        embeds where the chunk overlaps the prefix region, token embeddings
        of the fed stream after it."""
        prefix = self.cfg.num_prefix_embeds
        stream = req.prefill_stream
        parts = []
        if s < prefix:
            parts.append(req._prefix_src[:, s: min(prefix, s + C)])
        lo, hi = max(s - prefix, 0), min(s + C - prefix, len(stream))
        if hi > lo:
            parts.append(self.params["embed"][
                torch.tensor([stream[lo:hi]], dtype=torch.long, device=self.device)])
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _pad_embed(self) -> torch.Tensor:
        """(1, 1, D) embedding of token 0, the pad content."""
        if self._pad_row is None:
            self._pad_row = self.params["embed"][
                torch.zeros((1, 1), dtype=torch.long, device=self.device)]
        return self._pad_row

    def _finish_prefill(self, req: Request, *, sample: bool, logits=None,
                        last_rel: int = 0) -> None:
        """Prefill completion: ``sample=True`` commits T0 from the final
        chunk's logits; a restore replay skips it."""
        if sample:
            tok = sample_token(logits[0, last_rel], req.sampling.seed, 0,
                               req.sampling.temperature, req.sampling.top_k)
            req.committed.append(int(tok))  # T0: deterministic by construction
            self._note_t0(req, (
                float(top2_margin(logits[0, last_rel]))
                if self.obs.audit.enabled else None
            ))
        # commit point == post-stream state: the verify replay anchor (on a
        # replay, the state after committed[:-1], exactly what the next
        # anchored window starts from)
        self.statepool.set_commit_point(self.pool.data, req.slot)
        if req.prefill_time < 0:
            req.prefill_time = self._now
        req.state = State.RUNNING
        req._prefix_src = None
        if req.replaying:
            req.replaying = False
            req.restore_iter = self._now
        else:
            self._insert_prompt_blocks(req)

    def _prefill_chunk_prep(self, req: Request, C: int):
        """Device arguments for the request's next C-token prefill chunk;
        pad positions embed token 0 and land in the scratch block."""
        s = req.prefill_pos
        emb = self._chunk_embeds(req, s, C)
        real = emb.shape[1]
        if real < C:
            pad = self._pad_embed().expand(1, C - real, emb.shape[2])
            emb = torch.cat([emb, pad], dim=1)
        self._check_view([s], C)
        table = self.pool.table_array([req.blocks])[0]
        args = (self._slot_index([req.slot]), table, emb, _host(s),
                _host(max(real - 1, 0)))
        return args, s, real

    def _prefill_chunk_post(self, req: Request, C: int, s: int, real: int,
                            logits, wall: float) -> Dict[str, Any]:
        """Advance the cursor; the final chunk samples T0 (unless this is a
        restore replay) and flips the request to RUNNING."""
        req.last_sched = self._now
        req.prefill_pos = s + real
        total = req.prefill_total
        done = req.prefill_pos >= total
        replay = req.replaying
        if done:
            self._finish_prefill(req, sample=not replay, logits=logits,
                                 last_rel=total - 1 - s)
        return {
            "kind": "prefill_chunk", "tokens": real, "padded": C, "start": s,
            "wall": wall, "iter": self._now, "rid": req.rid, "done": done,
            "replay": replay,
        }

    def _prefill_advance(self, req: Request, C: int) -> Dict[str, Any]:
        """One fixed-shape C-token prefill chunk as a standalone step."""
        args, s, real = self._prefill_chunk_prep(req, C)
        t0 = time.perf_counter()
        with deterministic_torch():
            logits = self._prefill_chunk_fn(C)(*args)
        self._sync()
        wall = time.perf_counter() - t0
        return self._prefill_chunk_post(req, C, s, real, logits, wall)

    # det: commit-path
    def _prefill(self, req: Request) -> None:
        P = _bucket(req.prompt_len)
        self._prepare_prefill(req)
        if self._ring_pass_cap(P) < P:
            # ring contract: feed the prompt in chunks the ring allows (the
            # reference's _prefill_sliding: the same fixed-chunk loop)
            self._prefill_tail_sync(req)
            return
        prefix = self.cfg.num_prefix_embeds
        L = req.prefill_total
        if prefix:
            emb = self._chunk_embeds(req, 0, L)
            pad = self._pad_embed().expand(1, P - req.prompt_len, emb.shape[2])
            x = torch.cat([emb, pad], dim=1)
        else:
            x = _host([req.prompt + [0] * (P - req.prompt_len)])
        req.prefill_pos, req._prefix_src = L, None
        self._check_view([0], prefix + P)
        table = self.pool.table_array([req.blocks])[0]
        args = (self._slot_index([req.slot]), table, x, _host(L - 1),
                *_sampling_inputs([req.sampling]))
        t0 = time.perf_counter()
        with deterministic_torch():
            tok, marg = self._prefill_fn(P)(*args)
        tok = int(tok[0])
        wall = time.perf_counter() - t0
        req.last_sched = self._now
        # commit point == post-prompt state: the first verify replay anchor
        self.statepool.set_commit_point(self.pool.data, req.slot)
        req.committed.append(tok)  # T0: deterministic by construction
        self._note_t0(req, float(marg[0]) if self.obs.audit.enabled else None)
        req.prefill_time = self._now
        self._insert_prompt_blocks(req)
        ev = {
            "kind": "prefill", "tokens": L,
            "padded": prefix + P, "wall": wall, "iter": self._now,
        }
        self._charge_main(ev)
        self.events.append(ev)

    def _view(self, stalled: Optional[Set[int]] = None) -> sched.SchedulerView:
        """Snapshot handed to the schedule policy each iteration."""
        stalled = stalled or set()
        visible = tuple(r for r in self.running if r.rid not in stalled)
        return sched.SchedulerView(
            running=visible,
            mode=self.mode,
            window=self.window,
            group=self.group,
            speculate_past_inflight=True,
            now=self._now,
            prefilling=tuple(r for r in visible if r.state is State.PREFILLING),
            now_time=self.runtime.now,
            verify_inflight=sum(len(r.pipeline) for r in self.running),
            verify_backlog=self.runtime.verify_backlog,
            acceptance={r.rid: r.accept_ema for r in self.running},
            spec_depth=self.spec_depth,
            free_blocks=self.pool.num_free_blocks(),
            num_preempted=len(self.preempted),
        )

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _decode_schedule(self, B: int) -> Schedule:
        if self.mode == Mode.BATCH_INVARIANT:
            return INVARIANT_SCHEDULE
        sched_ = self.policy.schedule_for(B)
        if self.tp > 1:
            # fast path on a width-tp mesh: the TP partial-sum tree follows
            # the mesh (un-pinned), which perturbs decode as batch geometry
            # does, and DVR catches both the same way
            sched_ = sched_._replace(tp_shards=self.tp, tp_pinned=False)
        return sched_

    def _decode_prep(self, batch: List[Request]):
        """The decode program's inputs for one pass over ``batch`` (host
        tensors)."""
        tables = self.pool.table_array([r.blocks for r in batch])
        last_tok, pos, out_pos = [], [], []
        for r in batch:
            seq = r.committed + r.speculation
            last_tok.append(seq[-1])
            pos.append(self.cfg.num_prefix_embeds + r.prompt_len + len(seq) - 1)
            out_pos.append(len(seq))
            r.last_sched = self._now
        self._check_view(pos, 1)
        seeds, temps, top_ks = _sampling_inputs([r.sampling for r in batch])
        args = (self._slot_index([r.slot for r in batch]), tables, _host(last_tok),
                _host(pos), seeds, temps, _host(out_pos, torch.int64), top_ks)
        return args, pos

    def _decode_post(self, batch: List[Request], schedule: Schedule,
                     pos: List[int], nxt, wall: float, margins=None) -> Dict[str, Any]:
        """Land one decode pass's tokens: fresh candidates for det requests
        under LLM42, committed tokens otherwise."""
        B = len(batch)
        nxt = [int(t) for t in nxt.tolist()]
        au = self.obs.audit
        marg = margins.tolist() if (au.enabled and margins is not None) else None
        for i, (r, t) in enumerate(zip(batch, nxt)):
            if self.mode == Mode.LLM42 and r.sampling.is_deterministic:
                r.candidates.append(t)
                dvr.mark_window_state(r, self.window)
            else:
                r.committed.append(t)
                self._c_committed.inc()
                if r.first_token_clock < 0:
                    r.first_token_clock = self.runtime.now
                if au.enabled:
                    au.record(TokenProvenance(
                        rid=r.rid, index=len(r.committed) - 1, token=t,
                        origin="decode", schedule=schedule,
                        margin=marg[i] if marg is not None else None,
                    ))
        return {
            "kind": "decode", "batch": B, "schedule": tuple(schedule),
            "ctx_sum": sum(pos) + B, "wall": wall, "iter": self._now,
            "rids": [r.rid for r in batch],
        }

    def _decode_step(self, batch: List[Request]) -> Dict[str, Any]:
        B = len(batch)
        schedule = self._decode_schedule(B)
        args, pos = self._decode_prep(batch)
        t0 = time.perf_counter()
        with deterministic_torch():
            nxt, margins = self._decode_fn(B, schedule)(*args)
        self._sync()
        wall = time.perf_counter() - t0
        return self._decode_post(batch, schedule, pos, nxt, wall, margins)

    def _pad_verify_row(self, inputs, cands, cand_lens, starts, bases, slots,
                        seeds, temps, tks, ring_idxs, table_rows) -> None:
        """One padding row for a short verify group: its empty block table
        sends reads to the null block and writes to the scratch block."""
        W = self.window
        inputs.append([0] * W)
        cands.append([-1] * (W - 1))
        cand_lens.append(0)
        starts.append(0)
        bases.append(0)
        slots.append(self.pool.scratch_slot)
        seeds.append(0)
        temps.append(0.0)
        tks.append(0)
        ring_idxs.append(0)
        table_rows.append([])

    def _verify_args(self, inputs, cands, cand_lens, starts, bases, slots,
                     seeds, temps, tks, table_rows):
        """The verify program's inputs for one pass (host tensors)."""
        self._check_view(starts, self.window)
        return (
            self._slot_index(slots), self.pool.table_array(table_rows),
            _host(starts), _host(inputs), _host(cands), _host(cand_lens),
            _host([x & _M32 for x in seeds], torch.int64),
            _host(temps, torch.float32), _host(bases, torch.int64),
            _host(tks, torch.int64),
        )

    def _verify_prelaunch(self, rows: List[Request]):
        """Host protocol work for one deferred verify group, BEFORE the
        device pass: build each row's replay inputs, then move its window
        into the in-flight FIFO as a placeholder record (``n_match = -1``)."""
        G, W = self.group, self.window
        assert len({id(r) for r in rows}) == len(rows), (
            "a request may contribute one window per grouped pass — chained "
            "windows replay sequentially, never inside one batch"
        )
        n_pad = G - len(rows)
        inputs, cands, cand_lens, starts, bases, slots, seeds, temps, tks = (
            [], [], [], [], [], [], [], [], []
        )
        ring_idxs: List[int] = []
        fls: List[pipeline.InflightVerify] = []
        table_rows: List[List[int]] = []
        for r in rows:
            assert len(r.pipeline) < self.spec_depth, (
                "scheduler plan exceeds the configured spec_depth"
            )
            ring_idx = r.window_seq % self.spec_depth
            i, c, cl, sp, ob = dvr.build_verify_row(r, W)
            inputs.append(i)
            cands.append(c)
            cand_lens.append(cl)
            starts.append(sp)
            bases.append(ob)
            slots.append(r.slot)
            seeds.append(r.sampling.seed)
            temps.append(r.sampling.temperature)
            tks.append(r.sampling.top_k)
            table_rows.append(r.blocks)
            r.last_sched = self._now
            ring_idxs.append(ring_idx)
            fls.append(pipeline.submit_window(r, W, 0.0, float("inf"),
                                              ring_idx=ring_idx))
        for _ in range(n_pad):
            self._pad_verify_row(inputs, cands, cand_lens, starts, bases,
                                 slots, seeds, temps, tks, ring_idxs, table_rows)
        args = self._verify_args(inputs, cands, cand_lens, starts, bases,
                                 slots, seeds, temps, tks, table_rows)
        return args, fls, ring_idxs, slots, starts, n_pad

    def _verify_event(self, rows: List[Request], starts: List[int], n_pad: int,
                      wall: float, n_decodable: int, deferred: bool) -> Dict[str, Any]:
        G, W = self.group, self.window
        return {
            "kind": "verify", "group": len(rows), "window": W,
            "pad_rows": n_pad,
            "ctx_sum": sum(starts) + W * G, "wall": wall, "iter": self._now,
            "rids": [r.rid for r in rows], "n_decodable": n_decodable,
            "deferred": deferred,
        }

    def _verify_postlaunch(self, rows: List[Request], fls, ev: Dict[str, Any],
                           ring_idxs, slots, starts, n_match, commit_tok,
                           commit_rows=None, margins=None) -> None:
        """Land the host side of one deferred verify pass: stream-clock
        launch, state-pool checkpoints, verdict payloads into the
        placeholder FIFO records, and the post-submit state rule (evaluated
        after this iteration's decode bookkeeping)."""
        W = self.window
        ready_at = self.runtime.launch_verify(ev, sync=False)
        submitted_at = self.runtime.now
        tr = self.obs.tracer
        if tr.enabled:
            tr.pass_span("verify", "verify", self.runtime.last_verify_span,
                         self._trace_args(ev))
        self._c_windows.inc(len(rows))
        audit = self.obs.audit.enabled
        self.statepool.checkpoint(ring_idxs, slots, commit_rows)
        n_match = [int(n) for n in n_match.tolist()]
        commit_tok = [int(t) for t in commit_tok.tolist()]
        marg = margins.tolist() if (audit and margins is not None) else None
        for i, r in enumerate(rows):
            fl = fls[i]
            fl.submitted_at, fl.ready_at = submitted_at, ready_at
            fl.n_match, fl.commit_tok = n_match[i], commit_tok[i]
            if marg is not None:
                fl.margins = [float(x) for x in marg[i]]
            if tr.enabled:
                tr.instant("verify_submit", t=submitted_at, rid=r.rid,
                           window=fl.seq, cands=len(fl.cands),
                           ready_at=ready_at)
            self.statepool.note_submit(r.slot, starts[i] + W)
            if r.state is not State.FINISHED:
                r.state = (
                    State.AWAITING_VERIFY if r.done_decoding() else State.RUNNING
                )

    def _pack_verify_groups(self, entries: List[Request]) -> List[List[Request]]:
        """Split the plan's verify entries into grouped passes; the k-th
        occurrence of a request is its k-th chained window and replays
        after its predecessors."""
        layers: List[List[Request]] = []
        seen: Dict[int, int] = {}
        for r in entries:
            k = seen.get(id(r), 0)
            seen[id(r)] = k + 1
            if k == len(layers):
                layers.append([])
            layers[k].append(r)
        groups: List[List[Request]] = []
        for layer in layers:
            for i in range(0, len(layer), self.group):
                groups.append(layer[i:i + self.group])
        return groups

    def _run_verify(self, args):
        """One grouped verify pass on the pool through the verify program;
        returns ``(n_match, commit_tok, margins, commit_rows)``
        (``_verify_outs``)."""
        with deterministic_torch():
            return self._verify_fn()(*args)

    def _verify_step(self, group: List[Request], *, defer: bool = False,
                     n_decodable: int = 0) -> Dict[str, Any]:
        """One grouped verification pass as a standalone step.

        ``defer=False`` (pause policy / an adaptive sync plan): the verdict
        applies synchronously and the pass blocks the main stream.
        ``defer=True``: the windows move into the in-flight FIFOs and the
        verdict becomes visible one tick later (logical clock)."""
        G, W = self.group, self.window
        rows = group[:G]
        if defer:
            args, fls, ring_idxs, slots, starts, n_pad = self._verify_prelaunch(rows)
            t0 = time.perf_counter()
            n_match, commit_tok, margins, commit_rows = self._run_verify(args)
            self._sync()
            ev = self._verify_event(rows, starts, n_pad,
                                    time.perf_counter() - t0, n_decodable, True)
            self._verify_postlaunch(rows, fls, ev, ring_idxs, slots, starts,
                                    n_match, commit_tok, commit_rows, margins)
            return ev
        # ---- sync path: FIFOs are empty, the verdict applies on the spot
        assert len({id(r) for r in rows}) == len(rows), (
            "a request may contribute one window per grouped pass — chained "
            "windows replay sequentially, never inside one batch"
        )
        n_pad = G - len(rows)
        inputs, cands, cand_lens, starts, bases, slots, seeds, temps, tks = (
            [], [], [], [], [], [], [], [], []
        )
        ring_idxs: List[int] = []
        table_rows: List[List[int]] = []
        for r in rows:
            i, c, cl, sp, ob = dvr.build_verify_row(r, W)
            inputs.append(i)
            cands.append(c)
            cand_lens.append(cl)
            starts.append(sp)
            bases.append(ob)
            slots.append(r.slot)
            seeds.append(r.sampling.seed)
            temps.append(r.sampling.temperature)
            tks.append(r.sampling.top_k)
            table_rows.append(r.blocks)
            r.last_sched = self._now
            ring_idxs.append(0)
        for _ in range(n_pad):
            self._pad_verify_row(inputs, cands, cand_lens, starts, bases,
                                 slots, seeds, temps, tks, ring_idxs, table_rows)
        t0 = time.perf_counter()
        args = self._verify_args(inputs, cands, cand_lens, starts, bases,
                                 slots, seeds, temps, tks, table_rows)
        n_match, commit_tok, margins, commit_rows = self._run_verify(args)
        self.statepool.checkpoint(ring_idxs, slots, commit_rows)
        n_match = [int(n) for n in n_match.tolist()]
        commit_tok = [int(t) for t in commit_tok.tolist()]
        wall = time.perf_counter() - t0
        ev = self._verify_event(rows, starts, n_pad, wall, n_decodable, False)
        self.runtime.launch_verify(ev, sync=True)
        tr, au = self.obs.tracer, self.obs.audit
        if tr.enabled:
            tr.pass_span("verify", "verify", self.runtime.last_verify_span,
                         self._trace_args(ev))
        marg = margins.tolist() if au.enabled else None
        for i, (r, n, t) in enumerate(zip(rows, n_match, commit_tok)):
            cand_len = len(r.candidates)
            base = len(r.committed)
            nc, nrej = dvr.apply_verify_result(r, n, t, window=W)
            self._c_passes.inc()
            self._c_committed.inc(nc)
            if nrej:
                self._c_rollbacks.inc()
                self._c_recomputed.inc(nrej)
                self._h_rollback_depth.observe(nrej)
            if tr.enabled:
                tr.instant("rollback" if nrej else "commit",
                           t=self.runtime.now, rid=r.rid,
                           window=r.num_verify_passes - 1, n_match=n,
                           committed=nc, rejected=nrej, cascaded=0)
            if r.first_token_clock < 0 and r.committed:
                r.first_token_clock = self.runtime.now
            if au.enabled:
                for j in range(nc):
                    idx = base + j
                    au.record(TokenProvenance(
                        rid=r.rid, index=idx, token=r.committed[idx],
                        origin="verify", schedule=VERIFY_SCHEDULE,
                        window=r.num_verify_passes - 1, occurrence=0,
                        n_match=n, accepted=j < min(n, cand_len),
                        rollback=nrej > 0,
                        margin=float(marg[i][j]),
                    ))
            if self.statepool.active:
                # live state + replay anchor <- the commit-index state the
                # pass just checkpointed (ring 0)
                self.pool.data = self.statepool.restore(self.pool.data, r.slot, 0)
        return ev

    def _fused_step(self, plan: sched.Plan, view: sched.SchedulerView):
        """The iteration's whole device side: the current prefill chunk, the
        decode batch and EVERY due verify group, as ONE program
        (``_fused_fn``) when there is more than one sub-pass, else the one
        lane's own program, as the reference dispatches.

        Host order: all preps first (prefill args, decode args, verify
        pre-launches in layer order), the device work, then prefill post,
        decode post and verify post-launches in layer order.  Wall time
        splits equally across sub-passes.  Returns ``(pev, dev, vev,
        vextra)``."""
        C = self._chunk_size()
        preq = plan.prefill
        pargs = ps = preal = None
        if preq is not None:
            pargs, ps, preal = self._prefill_chunk_prep(preq, C)
        batch = [r for r in plan.decode if not r.done_decoding()]
        B = len(batch)
        schedule = self._decode_schedule(B)
        dargs = dpos = None
        if batch:
            dargs, dpos = self._decode_prep(batch)
        groups = self._pack_verify_groups(list(plan.verify)) if plan.verify else []
        vstates = []
        for rows in groups:
            vstates.append((rows, *self._verify_prelaunch(rows)))
        n_subs = (preq is not None) + (1 if batch else 0) + len(groups)
        if n_subs == 0:
            return None, None, None, []
        n_decodable = len(sched.decodable(view))

        t0 = time.perf_counter()
        with deterministic_torch():
            if n_subs > 1:
                logits_p, nxt, dmarg, vouts = self._fused_fn(
                    C if preq is not None else None, B, schedule, len(groups))(
                    pargs or (), dargs or (), tuple(args for _, args, *_ in vstates))
            elif preq is not None:
                logits_p, nxt, dmarg, vouts = (
                    self._prefill_chunk_fn(C)(*pargs), None, None, [])
            elif batch:
                logits_p, vouts = None, []
                nxt, dmarg = self._decode_fn(B, schedule)(*dargs)
            else:
                logits_p = nxt = dmarg = None
                vouts = [self._verify_fn()(*vstates[0][1])]
        self._sync()
        wall = time.perf_counter() - t0
        share = wall / n_subs
        if n_subs > 1:
            self._c_fused.inc()
        tr = self.obs.tracer
        if tr.enabled and n_subs > 1:
            tr.begin_group("fused_step", iter=self._now, subs=n_subs)

        pev = dev = vev = None
        vextra: List[Dict[str, Any]] = []
        lead = True
        if preq is not None:
            pev = self._prefill_chunk_post(preq, C, ps, preal, logits_p, share)
            lead = False
            self._charge_main(pev)
        if batch:
            dev = self._decode_post(batch, schedule, dpos, nxt, share, dmarg)
            if not lead:
                dev["fused"] = True
            lead = False
            self._charge_main(dev)
        for (rows, _args, fls, ring_idxs, slots, starts, n_pad), vout in zip(
            vstates, vouts
        ):
            n_match, commit_tok, vmarg, commit_rows = vout
            ev = self._verify_event(rows, starts, n_pad, share, n_decodable, True)
            if not lead:
                ev["fused"] = True
            lead = False
            self._verify_postlaunch(rows, fls, ev, ring_idxs, slots, starts,
                                    n_match, commit_tok, commit_rows, vmarg)
            if vev is None:
                vev = ev
            else:
                vextra.append(ev)
        if tr.enabled and n_subs > 1:
            tr.end_group()
        return pev, dev, vev, vextra

    def _finish(self, req: Request) -> None:
        """Retire one request: committed-stream blocks go to the prefix
        cache, the rest free, the slot returns to the pool."""
        req.state = State.FINISHED
        req.finish_time = self._now
        self.running.remove(req)
        self._release_blocks(req, insert=True)
        self.pool.free(req.slot)
        self.statepool.note_release(req.slot)
        req.slot = -1
        self.finished.append(req)
        self._c_finished.inc()
        now = self.runtime.now
        if req.submit_clock >= 0:
            self._h_e2e.observe(now - req.submit_clock)
            if req.first_token_clock >= 0:
                self._h_ttft.observe(req.first_token_clock - req.submit_clock)
        if req.first_token_clock >= 0 and req.num_output > 1:
            self._h_tpot.observe(
                (now - req.first_token_clock) / (req.num_output - 1))
        if self.mode == Mode.LLM42 and req.sampling.is_deterministic:
            self._h_acceptance.observe(req.accept_ema)
        tr = self.obs.tracer
        if tr.enabled:
            tr.instant("retire", t=now, rid=req.rid,
                       committed=req.num_output,
                       rollbacks=req.num_rollbacks,
                       verify_passes=req.num_verify_passes)
            tr.request_end(req.rid, now)

    def _retire(self) -> None:
        done = [r for r in self.running if r.finished() or (
            not r.sampling.is_deterministic and r.done_decoding()
        ) or (self.mode != Mode.LLM42 and r.done_decoding())]
        for r in done:
            # a det request must have no outstanding speculation at retirement
            if self.mode == Mode.LLM42 and r.sampling.is_deterministic and (
                r.candidates or r.pipeline
            ):
                continue
            self._finish(r)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration.  Returns False when fully drained.

        Order within an iteration: advance the clock, land due verdicts,
        retire, admit, plan, then PREFILL chunk, DECODE, VERIFY.  Decode
        before verify is a correctness requirement: the decode of a row
        being submitted re-feeds its last candidate, writing fast-path KV at
        the window's final position, which the verify replay must then
        repair.  A deferring plan runs as one fused step; sync-verify plans
        keep one step per role."""
        self._now += 1
        self.runtime.begin_iteration()
        self._c_iters.inc()
        tr = self.obs.tracer
        if tr.enabled:
            # iteration window start: under the logical clock
            # begin_iteration just advanced main by 1.0, so the window the
            # tick represents is [now - 1, now]; costed passes extend the
            # frontier from now onward
            tr.begin_iteration(
                self._now,
                self.runtime.now - (1.0 if self.runtime.logical else 0.0),
            )
        applied = self._apply_due_verdicts()
        self._retire()
        self._admit()
        if not self.running and not self.queue and not self.preempted:
            if tr.enabled:
                tr.end_iteration(self.runtime.now)
            return False
        self.peak_running = max(self.peak_running, len(self.running))

        stalled = self._ensure_memory()
        view = self._view(stalled)
        plan = self.scheduler.plan(view)
        defer = self.scheduler.defers_verify and not plan.sync_verify
        pev = dev = vev = None
        vextra: List[Dict[str, Any]] = []
        if defer:
            pev, dev, vev, vextra = self._fused_step(plan, view)
        else:
            if plan.prefill is not None:
                pev = self._prefill_advance(plan.prefill, self._chunk_size())
                self._charge_main(pev)
            if plan.decode:
                batch = [r for r in plan.decode if not r.done_decoding()]
                if batch:
                    dev = self._decode_step(batch)
                    self._charge_main(dev)
            if plan.verify:
                rows, seen = [], set()
                for r in plan.verify:
                    if id(r) not in seen:
                        seen.add(id(r))
                        rows.append(r)
                vev = self._verify_step(
                    rows, defer=defer, n_decodable=len(sched.decodable(view)))
        self.runtime.end_iteration()
        if tr.enabled:
            tr.end_iteration(self.runtime.now)

        subs = [("decode", dev), ("verify", vev), ("prefill", pev)]
        present = [(k, ev) for k, ev in subs if ev is not None]
        if present and (len(present) + len(vextra)) >= 2:
            comp = {
                "kind": "overlap", **dict(present),
                "wall": sum(ev["wall"] for _, ev in present)
                + sum(ev["wall"] for ev in vextra),
                "iter": self._now,
            }
            if vextra:
                comp["verifies"] = vextra
            self.events.append(comp)
        elif present:
            self.events.append(present[0][1])
        if present or applied:
            return True
        return bool(self.running or self.queue or self.preempted)

    def _ensure_memory(self) -> Set[int]:
        """Grow every running request's block table to cover this
        iteration's worst-case writes, preempting LRU victims on
        exhaustion.  Returns the rids that could not be covered.  A pool
        without paged leaves (sliding rings) has no blocks to grow."""
        if not self.pool.paged:
            return set()
        stalled: Set[int] = set()
        for r in list(self.running):
            if r not in self.running:
                continue  # preempted by an earlier request's growth
            if r.state is State.PREFILLING:
                chunk = (
                    self._chunk_size() if self.chunked_prefill
                    else r.prefill_total - r.prefill_pos
                )
                end = min(r.prefill_pos + max(chunk, 1), r.prefill_total)
            else:
                end = (self.cfg.num_prefix_embeds + r.prompt_len + len(r.committed)
                       + len(r.speculation))
            if not self._ensure_blocks(r, end):
                stalled.add(r.rid)
        return stalled

    def _apply_due_verdicts(self) -> bool:
        """Land in-flight verify results whose deadline has been reached,
        per request strictly in submission order.  On a recurrent config a
        rollback splice, or one that leaves no surviving speculation,
        restores the slot's live state (and replay anchor) from the
        window's state-pool checkpoint; a splice that drains the FIFO with
        live speculation surviving only moves the anchor."""
        applied = False
        now = self.runtime.now
        for r in self.running:
            for outcome in pipeline.apply_ready(r, self.window, now):
                applied = True
                self._note_splice(r, outcome)
                self.statepool.note_splice(r.slot, len(outcome.cascaded))
                if not self.statepool.active or (
                    r.finished() and not (r.pipeline or r.candidates)
                ):
                    # no device work for a request about to retire with
                    # nothing left to verify (an EOS-finished request with
                    # a surviving tail still verifies it, from the anchor)
                    continue
                if outcome.restore_state:
                    self.pool.data = self.statepool.restore(
                        self.pool.data, r.slot, outcome.record.ring_idx)
                elif outcome.reanchor:
                    self.statepool.reanchor(r.slot, outcome.record.ring_idx)
        return applied

    def run(self, max_iters: int = 100000) -> List[Request]:
        for _ in range(max_iters):
            if not self.step():
                break
        assert not (self.running or self.queue or self.preempted), (
            "engine did not drain"
        )
        return self.finished
