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
grouped verify, the fused mixed-batch step, the logical clock, and the
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

What differs: the JAX engine jits one function per shape class and threads
an immutable pool through it; here every step runs eagerly and the pool is
updated in place, so the "fused" step is the prefill-chunk, decode and
verify bodies called one after the other on the shared pool.  Device work
runs under ``core.determinism.deterministic_torch`` (pad rows write the
scratch block through duplicate indices).  On the card every GEMM runs in
the two hand-written GEMMs and single-token attention in the paged kernels
(paged lane) or the dense-cache decode kernel (gathered lane).

What waits for later slices: recurrent / enc-dec / prefix-embed /
sliding-window archs, the costed clock (``verify_latency_ms``,
``bind_cost_model``, the cost model) and ``tp > 1``.  The constructor
raises on each.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Set

import torch

from repro_torch.core import dvr, pipeline
from repro_torch.core.determinism import (
    FAST_PATH_POLICY,
    INVARIANT_SCHEDULE,
    Mode,
    ReductionPolicy,
    Schedule,
    VERIFY_SCHEDULE,
    deterministic_torch,
)
from repro_torch.core.verifier import make_verify_body
from repro_torch.models.base import ModelConfig, dense_supported
from repro_torch.obs import Observability, TokenProvenance
from repro_torch.serving import blockpool, kv_cache, prefixcache, statepool, streams
from repro_torch.serving import scheduler as sched
from repro_torch.serving.request import Request, State
from repro_torch.serving.sampler import sample_batch, sample_token, top2_margin


def _bucket(n: int) -> int:
    """Next power-of-two bucket (>= 8) for prompt padding."""
    b = 8
    while b < n:
        b *= 2
    return b


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
        dense_supported(cfg)
        if tp != 1:
            raise NotImplementedError("tp > 1 waits for the distributed/ port")
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
        self.prefix_cache: Optional[prefixcache.PrefixCache] = (
            prefixcache.PrefixCache(self.pool.block_size) if prefix_cache else None
        )
        self.mem_policy = mem_policy or sched.BlockMemoryPolicy()
        self.spec_depth = int(spec_depth)
        self.statepool = statepool.StatePool(cfg, max_batch, self.spec_depth)
        self.scheduler = scheduler if scheduler is not None else sched.default_policy(mode)
        # the logical clock: 1 tick per iteration, verdicts 1 tick after launch
        self.runtime = streams.DualClockRuntime(latency=1.0)
        self.prefill_chunk = int(prefill_chunk)
        self.chunked_prefill = self.prefill_chunk > 0

        self.queue: List[Request] = []
        self.running: List[Request] = []
        self.preempted: List[Request] = []  # blocks evicted, restore pending
        self.finished: List[Request] = []
        self.events: List[Dict[str, Any]] = []
        self._paged_fwd = bool(paged_attention)
        self._verify_body = make_verify_body(
            cfg, group, window, self.pool.layout, paged=self._paged_fwd)
        self._pad_row: Optional[torch.Tensor] = None
        self._now = 0  # logical iteration counter
        self.num_preemptions = 0
        self.num_restores = 0
        self.restored_tokens = 0
        self.peak_running = 0
        self.obs = Observability(trace=trace, audit=audit)
        self._register_metrics()

    # ------------------------------------------------------------------
    # observability (repro_torch.obs)
    # ------------------------------------------------------------------

    def _register_metrics(self) -> None:
        """Register every engine series with the metrics registry."""
        m = self.obs.metrics
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
        m.gauge_fn("engine.running", lambda: len(self.running),
                   unit="requests", help="requests in the running set")
        m.gauge_fn("engine.queued", lambda: len(self.queue),
                   unit="requests", help="requests awaiting admission")
        m.gauge_fn("engine.preempted", lambda: len(self.preempted),
                   unit="requests", help="requests evicted, restore pending")
        m.gauge_fn("engine.peak_running", lambda: self.peak_running,
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
                   lambda: sum(len(r.pipeline) for r in self.running),
                   unit="windows", help="verify windows currently in flight")
        m.gauge_fn("streams.outstanding_verdicts",
                   lambda: self.runtime.outstanding_verdicts,
                   unit="verdicts", help="verdicts launched but not yet due")
        m.gauge_fn("streams.peak_outstanding",
                   lambda: self.runtime.peak_outstanding,
                   unit="verdicts", help="deepest verdict queue seen")
        m.gauge_fn("mem.preemptions", lambda: self.num_preemptions,
                   unit="preemptions", help="requests evicted under pressure")
        m.gauge_fn("mem.restores", lambda: self.num_restores,
                   unit="restores", help="preempted requests re-admitted")
        m.gauge_fn("mem.restored_tokens", lambda: self.restored_tokens,
                   unit="tokens", help="positions replayed by restores")
        m.gauge_fn("blockpool.block_size", lambda: self.pool.block_size,
                   unit="tokens", help="KV positions per block")
        m.gauge_fn("blockpool.num_blocks",
                   lambda: self.pool.alloc_blocks.num_blocks,
                   unit="blocks", help="total pool blocks")
        m.gauge_fn("blockpool.blocks_in_use",
                   lambda: self.pool.alloc_blocks.in_use(),
                   unit="blocks", help="blocks currently referenced")
        m.gauge_fn("blockpool.peak_blocks_in_use",
                   lambda: self.pool.alloc_blocks.peak_in_use,
                   unit="blocks", help="peak referenced blocks")
        m.gauge_fn("blockpool.free_blocks",
                   lambda: self.pool.alloc_blocks.num_free(),
                   unit="blocks", help="immediately free blocks")
        m.gauge_fn("blockpool.paged", lambda: int(self.pool.paged),
                   help="1 when full-attention KV is paged")
        if self.prefix_cache is not None:
            def _pc(key: str):
                return lambda: self.prefix_cache.stats()[key]
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
                       lambda: self.scheduler.num_demotions,
                       unit="transitions",
                       help="adaptive demotions to sync verification")
            m.gauge_fn("scheduler.promotions",
                       lambda: self.scheduler.num_promotions,
                       unit="transitions",
                       help="adaptive promotions back to overlap")
        self._h_ttft = m.histogram(
            "latency.ttft", unit="ticks",
            help="submit to first committed token (logical clock)")
        self._h_tpot = m.histogram(
            "latency.tpot", unit="ticks",
            help="mean inter-token time past T0 (logical clock)")
        self._h_e2e = m.histogram(
            "latency.e2e", unit="ticks",
            help="submit to retirement (logical clock)")

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

    def _commit_schedule(self) -> Schedule:
        """The verify-grade schedule prefill runs under in every mode."""
        return INVARIANT_SCHEDULE if self.mode == Mode.BATCH_INVARIANT else VERIFY_SCHEDULE

    def _note_t0(self, req: Request, margin: Optional[float] = None) -> None:
        """Metrics + audit for the T0 token a prefill pass just committed."""
        self._c_committed.inc()
        if req.first_token_clock < 0:
            req.first_token_clock = self.runtime.now
        au = self.obs.audit
        if au.enabled:
            au.record(TokenProvenance(
                rid=req.rid, index=len(req.committed) - 1,
                token=req.committed[-1], origin="prefill",
                schedule=self._commit_schedule(), margin=margin,
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
    # device steps (eager; the pool is updated in place)
    # ------------------------------------------------------------------

    def _ints(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def _sync(self) -> None:
        """Wait for the device, so a wall time covers the device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, params, pool, tables, start_pos, schedule, **inputs):
        """One forward over the pool in this engine's memory lane."""
        return kv_cache.pool_forward(
            params, self.cfg, self.pool.layout, pool, tables, start_pos,
            schedule, paged=self._paged_fwd, **inputs)

    def _decode_body(self, batch_size: int, schedule: Schedule):
        """One-token decode over the pool through the block tables."""

        def step(params, pool, tables, tokens, pos, seeds, temps, out_pos, top_ks):
            logits, pool = self._forward(params, pool, tables, pos, schedule,
                                         tokens=tokens[:, None])
            nxt = sample_batch(logits[:, 0], seeds, out_pos, temps, top_ks)
            margins = top2_margin(logits[:, 0])
            return pool, nxt, margins

        return step

    # det: commit-path
    def _prefill_pass(self, table: torch.Tensor, tokens: torch.Tensor):
        """Exclusive whole-prompt pass at the prompt's bucket, verify-grade
        schedule in every mode.  The JAX engine gathers a per-row view and
        runs the dense attention on it (the gathered lane here too); the
        paged forward computes the same masked softmax over the same view,
        reading through the table."""
        logits, self.pool.data = self._forward(
            self.params, self.pool.data, table[None], self._ints([0]),
            self._commit_schedule(), tokens=tokens)
        return logits

    def _prefill_chunk_body(self, C: int):
        """Fixed-shape C-token prefill chunk, verify-grade schedule."""
        schedule = self._commit_schedule()

        def chunk(params, pool, table, embeds, start, last):
            logits, pool = self._forward(params, pool, table[None], start[None],
                                         schedule, inputs_embeds=embeds)
            return pool, logits

        return chunk

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
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

    def _worst_need(self, req: Request) -> int:
        """Worst-case KV positions this request can ever occupy (the max of
        the prefill extent and prompt + output budget + the
        ``spec_depth x (W-1) + 1`` verify-row reservation)."""
        L = req.prompt_len
        if self._use_chunked(req):
            C = self._chunk_size()
            extent = -(-L // C) * C  # the last chunk pads to the chunk shape
        else:
            extent = _bucket(req.prompt_len)
        spec = (
            self.spec_depth * (self.window - 1) + 1
            if self.mode == Mode.LLM42 and req.sampling.is_deterministic
            else 0
        )
        return max(extent, L + req.sampling.max_new_tokens + spec)

    def _check_capacity(self, req: Request) -> None:
        """Reject a request whose worst-case footprint exceeds the
        per-request block-table reach or the whole pool."""
        need = self._worst_need(req)
        total_blocks = self.pool.alloc_blocks.num_blocks
        need_blocks = self._blocks_for(need)
        if need > self.capacity or need_blocks > total_blocks:
            raise ValueError(
                f"request {req.rid} cannot fit the KV pool: "
                f"max(prefill extent, prompt {req.prompt_len} + "
                f"max_new_tokens {req.sampling.max_new_tokens} + verify "
                f"rows [depth {self.spec_depth} x (W-1) + 1]) = {need} "
                f"positions = {need_blocks} blocks > per-request capacity "
                f"{self.capacity} or pool {total_blocks} blocks of "
                f"{self.pool.block_size}"
            )

    def _chunk_size(self) -> int:
        return max(1, self.prefill_chunk)

    def _use_chunked(self, req: Request) -> bool:
        """Chunked lane only when the prompt spans more than one chunk."""
        return self.chunked_prefill and req.prompt_len > self._chunk_size()

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
            avail = self.pool.alloc_blocks.available()
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
        L = req.prompt_len
        alloc = self.pool.alloc_blocks
        matched: List[int] = []
        if self.prefix_cache is not None:
            matched = self.prefix_cache.match(req.prompt, self._now)
            # the boundary block is never shared: T0's position must run
            matched = matched[: (req.prompt_len - 1) // self.pool.block_size]
        need = self._blocks_for(L) - len(matched)
        if not self.mem_policy.may_admit(alloc.available(), need):
            return False
        for bid in matched:
            alloc.incref(bid)
        req.blocks = list(matched)
        req.blocks_shared = len(matched)
        req.cached_prefix_tokens = len(matched) * self.pool.block_size
        if not self._grow_blocks(req, self._blocks_for(L)):
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
        """Force-apply every in-flight verdict in submission order."""
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
        schedule), re-matching blocks still resident in the prefix cache."""
        stream = list(req.prompt) + list(req.committed[:-1])
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
        ok = self._grow_blocks(req, self._blocks_for(len(stream)))
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
        prefill_total)`` span at the tail's power-of-two bucket."""
        start = req.prefill_pos
        replay = req.replaying
        C = _bucket(max(req.prefill_total - start, 1))
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

    def _prepare_prefill(self, req: Request, stream: Optional[List[int]] = None) -> None:
        """Chunk cursor for chunk-resumable prefill; ``stream`` overrides
        the fed tokens (a restore replays prompt + committed[:-1])."""
        req.prefill_stream = list(stream) if stream is not None else list(req.prompt)
        req.prefill_total = len(req.prefill_stream)
        req.prefill_pos = 0

    def _chunk_embeds(self, req: Request, s: int, C: int) -> torch.Tensor:
        """Token embeddings for prefill positions [s, s+C) of the stream."""
        toks = req.prefill_stream[s: min(s + C, len(req.prefill_stream))]
        return self.params["embed"][
            torch.tensor([toks], dtype=torch.long, device=self.device)]

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
        if req.prefill_time < 0:
            req.prefill_time = self._now
        req.state = State.RUNNING
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
        table = self.pool.table_array([req.blocks])[0]
        args = (table, emb, self._ints(s), self._ints(max(real - 1, 0)))
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
            self.pool.data, logits = self._prefill_chunk_body(C)(
                self.params, self.pool.data, *args)
        self._sync()
        wall = time.perf_counter() - t0
        return self._prefill_chunk_post(req, C, s, real, logits, wall)

    # det: commit-path
    def _prefill(self, req: Request) -> None:
        P = _bucket(req.prompt_len)
        tokens = self._ints([req.prompt + [0] * (P - req.prompt_len)])
        table = self.pool.table_array([req.blocks])[0]
        t0 = time.perf_counter()
        with deterministic_torch():
            logits = self._prefill_pass(table, tokens)
            last = logits[0, req.prompt_len - 1]
            tok = int(sample_token(last, req.sampling.seed, 0,
                                   req.sampling.temperature, req.sampling.top_k))
            marg = top2_margin(last)
        wall = time.perf_counter() - t0
        req.last_sched = self._now
        req.committed.append(tok)  # T0: deterministic by construction
        self._note_t0(req, float(marg) if self.obs.audit.enabled else None)
        req.prefill_time = self._now
        self._insert_prompt_blocks(req)
        ev = {
            "kind": "prefill", "tokens": req.prompt_len,
            "padded": P, "wall": wall, "iter": self._now,
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
        return self.policy.schedule_for(B)

    def _decode_prep(self, batch: List[Request]):
        """Device arguments for one decode pass over ``batch``."""
        tables = self.pool.table_array([r.blocks for r in batch])
        last_tok, pos, out_pos, seeds, temps, top_ks = [], [], [], [], [], []
        for r in batch:
            seq = r.committed + r.speculation
            last_tok.append(seq[-1])
            pos.append(r.prompt_len + len(seq) - 1)
            out_pos.append(len(seq))
            seeds.append(r.sampling.seed)
            temps.append(r.sampling.temperature)
            top_ks.append(r.sampling.top_k)
            r.last_sched = self._now
        args = (tables, self._ints(last_tok), self._ints(pos), seeds, temps,
                out_pos, top_ks)
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
            self.pool.data, nxt, margins = self._decode_body(B, schedule)(
                self.params, self.pool.data, *args)
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
        """Device tensors (and host sampling lists) of one verify pass."""
        return (
            slots, self.pool.table_array(table_rows), self._ints(starts),
            self._ints(inputs), self._ints(cands), self._ints(cand_lens),
            seeds, temps, bases, tks,
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
                           margins=None) -> None:
        """Land the host side of one deferred verify pass: stream-clock
        launch, verdict payloads into the placeholder FIFO records, and the
        post-submit state rule (evaluated after this iteration's decode
        bookkeeping)."""
        W = self.window
        ready_at = self.runtime.launch_verify(ev, sync=False)
        submitted_at = self.runtime.now
        tr = self.obs.tracer
        if tr.enabled:
            tr.pass_span("verify", "verify", self.runtime.last_verify_span,
                         self._trace_args(ev))
        self._c_windows.inc(len(rows))
        audit = self.obs.audit.enabled
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
        with deterministic_torch():
            pool, n_match, commit_tok, _v, margins = self._verify_body(
                self.params, self.pool.data, *args)
        self.pool.data = pool
        return n_match, commit_tok, margins

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
            n_match, commit_tok, margins = self._run_verify(args)
            self._sync()
            ev = self._verify_event(rows, starts, n_pad,
                                    time.perf_counter() - t0, n_decodable, True)
            self._verify_postlaunch(rows, fls, ev, ring_idxs, slots, starts,
                                    n_match, commit_tok, margins)
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
        n_match, commit_tok, margins = self._run_verify(args)
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
        return ev

    def _fused_step(self, plan: sched.Plan, view: sched.SchedulerView):
        """The iteration's whole device side: the current prefill chunk, the
        decode batch and EVERY due verify group, run one after the other on
        the shared pool (the JAX engine fuses them under one jit).

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
        logits_p = nxt = dmarg = None
        vouts = []
        with deterministic_torch():
            if preq is not None:
                self.pool.data, logits_p = self._prefill_chunk_body(C)(
                    self.params, self.pool.data, *pargs)
            if batch:
                self.pool.data, nxt, dmarg = self._decode_body(B, schedule)(
                    self.params, self.pool.data, *dargs)
        for rows, args, *_ in vstates:
            vouts.append(self._run_verify(args))
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
            n_match, commit_tok, vmarg = vout
            ev = self._verify_event(rows, starts, n_pad, share, n_decodable, True)
            if not lead:
                ev["fused"] = True
            lead = False
            self._verify_postlaunch(rows, fls, ev, ring_idxs, slots, starts,
                                    n_match, commit_tok, vmarg)
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
            tr.begin_iteration(self._now, self.runtime.now - 1.0)
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
        exhaustion.  Returns the rids that could not be covered."""
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
                end = r.prompt_len + len(r.committed) + len(r.speculation)
            if not self._ensure_blocks(r, end):
                stalled.add(r.rid)
        return stalled

    def _apply_due_verdicts(self) -> bool:
        """Land in-flight verify results whose deadline has been reached,
        per request strictly in submission order."""
        applied = False
        now = self.runtime.now
        for r in self.running:
            for outcome in pipeline.apply_ready(r, self.window, now):
                applied = True
                self._note_splice(r, outcome)
                self.statepool.note_splice(r.slot, len(outcome.cascaded))
        return applied

    def run(self, max_iters: int = 100000) -> List[Request]:
        for _ in range(max_iters):
            if not self.step():
                break
        assert not (self.running or self.queue or self.preempted), (
            "engine did not drain"
        )
        return self.finished
