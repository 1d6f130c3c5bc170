"""Cost model: replays engine event logs into modeled device time.

PyTorch port of ``repro.serving.costmodel``, its arithmetic kept in the
same order, so that on one event log and one ``Hardware`` the two packages
give the same floats.  The port's engine charges its costed clock with
``step_time`` (``Engine.bind_cost_model``, ``serving.online``), and the
serve entry point replays a run's events through ``simulate``.  Two ``Hardware``
entries: ``V5E``, the reference's TPU v5e (the parity tests pass it to
both packages), and ``H100``, the port's card and the port's default.  The
model is a device model: it prices each pass as if its whole device side
ran as one compiled launch, which the eager port does not do (about 10^4
kernel launches an iteration), so modeled time sits far below an eager
run's wall time.  A modeled time is labelled as such, never as a
measurement.

The reference's notes, written for the TPU v5e, follow.

Each engine step is costed with a two-term roofline
(compute, HBM) from its shape metadata; the paper's throughput comparisons
(Figs. 5, 10, 11, 12) are reproduced by replaying the *same scheduling
decisions* (the engine's real event log, including real rollbacks and
recomputation measured on the reduced model) through this cost model at the
full model's scale.

Batch-invariance penalty: the paper measures He-et-al. Triton GEMMs at 194
vs. 527 cuBLAS TFLOPS (Fig. 4a, -63%) and batch-invariant RMSNorm at up to
50% slower than the fused kernel (Fig. 4b).  We model BATCH_INVARIANT mode
with ``bi_compute_frac = 194/527`` of peak and ``bi_mem_frac = 0.7`` of
achieved bandwidth, citing those measurements.

Fast-path split-K benefit: at small batch a GEMM cannot fill the machine;
effective compute utilisation ~ min(1, rows * splits / SAT_ROWS).  split-K
raises utilisation exactly as on GPU (it exists to fill SMs/MXU at low
occupancy); the batch-invariant kernel is pinned to splits=1 and eats the
low-utilisation penalty — this is the mechanism behind paper Fig. 5.

Per-stream time accounting (the dual-clock runtime, ``serving.streams``):
the engine executes on two streams — decode and prefill passes serialize
on the **main** stream (separate kernel launches, one queue), deferred
verification rides the **verify** stream.  ``simulate``/``simulate_streams``
replay an event log through exactly that model: a composite ``overlap``
event's decode + prefill sub-passes are charged serially on the main
clock, its verify sub-pass starts at max(iteration start, previous verify
completion) on the verify clock, and the portion of the verify pass that
overlaps the iteration's main-stream work slows the main stream by
``stream_contention * overlap`` (shared HBM).  A verify pass *longer* than
its launch iteration no longer blocks anything — its tail spills into the
verify stream's backlog and only delays when the verdict lands.  Total
simulated time is the two-stream makespan.  Sync (pause-style) verify
events — standalone ``verify`` events without ``deferred: True`` — block
the main stream for their full duration, exactly the prototype's cost.

``step_time`` on a single composite event keeps a memoryless
approximation of the same rule (no cross-event backlog):
t = max(t_main, t_verify) + ``stream_contention`` * min(t_main, t_verify),
where t_main is the decode + prefill serial sum.  This is always <= the
serial sum — the pause policy's cost — and >= the max, i.e. overlap is
never modeled as free.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Tuple

from repro_torch.models.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16 / chip
    hbm_bw: float = 819e9  # B/chip/s
    ici_bw: float = 50e9  # B/link/s (TP all-reduce term, events with "tp")
    # batch-invariance penalties, calibrated from paper Fig. 4
    bi_compute_frac: float = 194.0 / 527.0
    bi_mem_frac: float = 0.7
    # rows needed to saturate the MXU pipeline (128x128 systolic tiles,
    # a few in flight)
    sat_rows: int = 256
    dtype_bytes: int = 2  # bf16 weights/KV at serving time
    # fraction of a concurrent verify-stream pass NOT hidden behind the
    # main stream's work (contention on HBM + inter-pass scheduling gaps);
    # 0 = both streams fully overlapped, 1 = serial execution
    overlap_serial_frac: float = 0.35
    # fixed per-kernel-launch overhead (dispatch + XLA prologue); passes
    # fused into an already-running launch (``fused: True`` sub-events of
    # the engine's single mixed-batch step) pay neither this nor a second
    # weight stream
    launch_overhead_s: float = 5e-6

    @property
    def stream_contention(self) -> float:
        """Cross-stream interference coefficient (alias of the historical
        ``overlap_serial_frac`` field — same physics, stream vocabulary)."""
        return self.overlap_serial_frac


V5E = Hardware()

#: The port's card: NVIDIA H100 SXM (80 GB HBM3).  Each field names its
#: source; a field no run on the card has measured says so.
H100 = Hardware(
    name="h100-sxm",
    # bf16 dense tensor-core peak, NVIDIA H100 SXM data sheet (the bound
    # PERF.md's kernel table divides by)
    peak_flops=989e12,
    # HBM3 bandwidth, the same data sheet (PERF.md's bytes bound)
    hbm_bw=3.35e12,
    # the effective rate of the activation all-reduce an event with "tp"
    # pays, at the serve driver's decode batch: a bf16 (8, 4096) all_reduce
    # over 4 cards (one a rank, NCCL) took 0.011578 ms on the card (back to
    # back, the card held while the host enqueued), 65536 bytes x 2(4-1)/4
    # over it = 8.49 GB/s (over 2 cards 0.007858 ms, 8.34 GB/s); NVIDIA H100
    # 80GB HBM3 at 700 W, chip_smoke.py's distribution4 phase (PERF.md §6,
    # "tp_matmul over NCCL").  Latency, not NVLink's 450 GB/s a way, sets
    # it at 8 rows: the same call reads 262 GB/s at 2048 rows
    ici_bw=8.49e9,
    # the split-K GEMM's time over the commit GEMM's at the serve run's
    # decode batch, M = 8, at the FFN's (4096, 14336): 0.0586 / 0.0581 ms =
    # 1.0083 on an H100 80GB HBM3 at 700 W (chip_smoke.py's online phase;
    # PERF.md §6, "H100 entry"), so no penalty: 1.0.  One ratio for compute
    # and bytes, because both GEMMs are bytes-bound there
    bi_compute_frac=1.0,
    bi_mem_frac=1.0,
    # the largest M whose commit-GEMM time stays within 10 % of its time at
    # M = 8, the same calibration: 0.0581 ms at M = 8, 0.0612 at 32, 0.0697
    # at 64 (the tile takes x's rows 32 at a time)
    sat_rows=32,
    dtype_bytes=2,
    # not measured on the card: no run has timed two streams side by side
    # there.  The v5e model's value, carried over
    overlap_serial_frac=0.35,
    # host cost of one cudaLaunchKernel in the profiled LLM42 window:
    # 243.8 ms over 45088 calls (PERF.md §5).  One "launch" here is
    # a compiled program's one launch per pass (a CUDA graph's), not the
    # eager engine's ~10^4 launches per iteration
    launch_overhead_s=243.8e-3 / 45088,
)


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """KV-cache bytes appended per token (attention layers only)."""
    total = 0
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "attn":
            total += 2 * cfg.num_kv_heads * cfg.hd * dtype_bytes
    return total


def kv_block_bytes(
    cfg: ModelConfig, block_size: int, dtype_bytes: int = 2
) -> int:
    """HBM bytes of one paged KV block (``serving.blockpool``): K + V +
    the int32 position row, across all full-attention layers."""
    total = 0
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "attn":
            total += 2 * block_size * cfg.num_kv_heads * cfg.hd * dtype_bytes
            total += 4 * block_size  # pos (int32)
    return total


def pool_hbm_bytes(
    cfg: ModelConfig, num_blocks: int, num_slots: int, block_size: int,
    dtype_bytes: int = 2,
) -> int:
    """HBM budget of a paged cache pool: ``num_blocks`` KV blocks plus the
    per-slot recurrent state rows.  The dense manager's footprint is the
    special case ``num_blocks = num_slots * ceil(capacity / block_size)`` —
    which is exactly the default pool size, so ``fig_cache`` compares
    paged vs dense at a genuinely equal budget."""
    return (
        num_blocks * kv_block_bytes(cfg, block_size, dtype_bytes)
        + num_slots * state_bytes(cfg, dtype_bytes)
    )


def dense_hbm_bytes(
    cfg: ModelConfig, num_slots: int, capacity: int, dtype_bytes: int = 2
) -> int:
    """HBM budget of the legacy dense manager: one ``capacity``-long KV
    ring per slot plus the recurrent state rows."""
    per_slot = capacity * kv_bytes_per_token(cfg, dtype_bytes)
    per_slot += 4 * capacity * sum(
        1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn"
    )  # pos rows
    return num_slots * (per_slot + state_bytes(cfg, dtype_bytes))


def memory_report(events: Iterable[Dict[str, Any]]) -> Dict[str, int]:
    """Memory-pressure + cache-hit accounting over an engine event log:
    prompt tokens served from the prefix cache (``cached`` on prefill
    events), preemption/restore counts, tokens dropped at preemption and
    tokens deterministically recomputed by restore replays."""
    out = {
        "cached_tokens": 0, "preemptions": 0, "restores": 0,
        "preempted_tokens": 0, "replayed_tokens": 0,
    }
    for ev in flatten_events(events):
        kind = ev.get("kind")
        if kind == "cache_hit":
            out["cached_tokens"] += ev.get("tokens", 0)
        elif kind == "prefill_chunk" and ev.get("replay"):
            out["replayed_tokens"] += ev.get("tokens", 0)
        elif kind == "preempt":
            out["preemptions"] += 1
            out["preempted_tokens"] += ev.get("dropped_tokens", 0)
        elif kind == "restore":
            out["restores"] += 1
        elif kind == "prefill" and ev.get("replay"):
            out["replayed_tokens"] += ev.get("tokens", 0)
    return out


def state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Recurrent state bytes per request (mamba/rwkv layers)."""
    total = 0
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind == "mamba":
            total += (cfg.d_conv - 1) * cfg.d_inner * dtype_bytes
            total += cfg.d_inner * cfg.d_state * 4
        elif kind == "rwkv":
            h = cfg.d_model // cfg.rwkv_head_dim
            total += 2 * cfg.d_model * dtype_bytes
            total += h * cfg.rwkv_head_dim**2 * 4
    return total


def flops_per_token(cfg: ModelConfig) -> float:
    """~2 * active params per token (matmul MACs x2)."""
    return 2.0 * cfg.active_param_count()


def attn_flops(cfg: ModelConfig, tokens: int, ctx: float) -> float:
    """Attention score+value FLOPs for `tokens` queries at avg context ctx."""
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn")
    if cfg.attn_kind == "sliding":
        ctx = min(ctx, cfg.window)
    return 4.0 * n_attn * tokens * ctx * cfg.num_heads * cfg.hd


def flatten_events(
    events: Iterable[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Expand composite ``overlap`` events into their leaf sub-events.

    For consumers that inspect per-pass metadata (tests, span analyses);
    time accounting must instead go through ``step_time``/``simulate``,
    which charge an overlapped pair as concurrent rather than serial.
    """
    out: List[Dict[str, Any]] = []
    for ev in events:
        if ev.get("kind") == "overlap":
            for k in ("decode", "verify", "prefill"):
                if k in ev:
                    out.append(ev[k])
            out.extend(ev.get("verifies", ()))
        else:
            out.append(ev)
    return out


def step_time(cfg: ModelConfig, ev: Dict[str, Any], hw: Hardware = V5E) -> float:
    """Simulated seconds for one engine event on one chip."""
    kind = ev["kind"]
    if kind == "overlap":
        # composite iteration, per-stream rule: decode + prefill serialize
        # on the main stream (two launches, one queue); the verify pass
        # rides the second stream concurrently, derated by the cross-
        # stream contention coefficient.  Memoryless single-event view —
        # ``simulate_streams`` carries verify tails across iterations.
        t_main, t_verify = _lane_times(cfg, ev, hw)
        return max(t_main, t_verify) + hw.stream_contention * min(
            t_main, t_verify
        )

    pbytes = cfg.active_param_count() * hw.dtype_bytes
    kvb = kv_bytes_per_token(cfg, hw.dtype_bytes)
    if kind in ("prefill", "prefill_chunk"):
        tokens = ev["padded"]
        start = ev.get("start", 0)  # chunk offset into the prompt
        ctx = start + tokens / 2
        rows, splits = tokens, 1
        invariant = False
    elif kind == "decode":
        tokens = ev["batch"]
        ctx = ev.get("ctx_sum", tokens) / max(tokens, 1)
        rows = tokens
        sched = ev.get("schedule", (1, 1, "float32", False))
        splits = sched[0]
        invariant = ev.get("invariant", False)
    elif kind == "verify":
        tokens = ev["group"] * ev["window"]
        ctx = ev.get("ctx_sum", tokens) / max(ev["group"], 1)
        rows, splits = tokens, 1
        invariant = False
    else:
        return 0.0

    flops = flops_per_token(cfg) * tokens + attn_flops(cfg, tokens, ctx)
    # memory: weights stream once per pass; KV read ~ ctx per sequence row
    if kind in ("decode", "verify"):
        kv_read = kvb * ev.get("ctx_sum", 0)
    else:
        # prefill: causal-local reads — flash-style q-chunks (Q_CHUNK=512)
        # each stream the cache written so far once, so the pass reads
        # ~avg-context bytes per q-chunk (ctx already = start + tokens/2);
        # sliding-window archs never read past the window
        read_ctx = min(ctx, cfg.window) if cfg.attn_kind == "sliding" else ctx
        n_qchunks = -(-tokens // 512)
        kv_read = kvb * read_ctx * max(n_qchunks, 1)
    # a fused follower shares the lead pass's launch: the weights are
    # already streaming and there is no second dispatch
    fused = ev.get("fused", False)
    bytes_moved = (0 if fused else pbytes) + kv_read + kvb * tokens

    # width-tp model-axis mesh: weights, KV and matmul FLOPs shard 1/tp per
    # chip; each layer's row-parallel matmuls all-reduce the
    # (tokens, d_model) activation over ICI — a ring moves 2(tp-1)/tp of
    # the data per chip, twice per layer.  The un-overlapped ICI term is
    # what makes the fig_cluster TP sweep sub-linear.
    tp = int(ev.get("tp", 1))
    t_ici = 0.0
    if tp > 1:
        flops /= tp
        bytes_moved /= tp
        t_ici = (
            2.0 * cfg.num_layers * tokens * cfg.d_model * hw.dtype_bytes
            * 2.0 * (tp - 1) / tp / hw.ici_bw
        )

    peak = hw.peak_flops
    bw = hw.hbm_bw
    util = min(1.0, (rows * max(splits, 1)) / hw.sat_rows)
    if invariant:
        peak *= hw.bi_compute_frac
        bw *= hw.bi_mem_frac
        util = min(1.0, rows / hw.sat_rows)  # no split-K allowed

    t_compute = flops / (peak * max(util, 1e-3))
    t_memory = bytes_moved / bw
    t = max(t_compute, t_memory) + t_ici
    if not fused:
        t += hw.launch_overhead_s
    return t


def _lane_times(
    cfg: ModelConfig, ev: Dict[str, Any], hw: Hardware
) -> Tuple[float, float]:
    """(main-stream seconds, verify-stream seconds) for one composite
    ``overlap`` event: decode + prefill serialize on the main stream, the
    verify sub-pass is the verify stream's work."""
    sub = {k: dict(ev[k]) for k in ("decode", "verify", "prefill") if k in ev}
    extra = [dict(v) for v in ev.get("verifies", ())]
    if ev.get("invariant"):
        for s in sub.values():
            s["invariant"] = True
        for s in extra:
            s["invariant"] = True
    if ev.get("tp", 1) > 1:
        for s in sub.values():
            s.setdefault("tp", ev["tp"])
        for s in extra:
            s.setdefault("tp", ev["tp"])
    t_main = sum(
        step_time(cfg, s, hw) for k, s in sub.items() if k != "verify"
    )
    t_verify = step_time(cfg, sub["verify"], hw) if "verify" in sub else 0.0
    # extra verify groups (multi-window iterations) serialize behind the
    # first on the verify stream
    t_verify += sum(step_time(cfg, s, hw) for s in extra)
    return t_main, t_verify


@dataclasses.dataclass
class StreamSim:
    """Two-stream replay result: ``total_s`` is the makespan, the busy
    fields are per-stream work, ``verify_occupancy`` is the verify
    stream's utilization over the makespan, ``peak_inflight`` is the
    deepest verdict queue the replay saw (> 1 only with multi-window
    pipelining, where it is the telemetry that shows whether a depth
    setting was actually exercised), and ``breakdown`` holds leaf per-kind
    device seconds (informational — their sum exceeds the makespan exactly
    when streams overlapped)."""

    total_s: float
    main_busy_s: float
    verify_busy_s: float
    verify_occupancy: float
    breakdown: Dict[str, float]
    peak_inflight: int = 0


def simulate_streams(
    cfg: ModelConfig, events: Iterable[Dict[str, Any]], hw: Hardware = V5E,
    *, invariant_mode: bool = False,
) -> StreamSim:
    """Replay an event log through genuine two-stream time accounting.

    The replay drives the SAME :class:`streams.DualClockRuntime` the
    engine's costed clock runs on — one implementation of the physics:
    main-stream passes (decode, prefill chunks — and sync verify, which
    blocks everything) serialize on the main clock; a deferred verify pass
    (``deferred: True``, or any verify sub-pass of a composite ``overlap``
    event) queues on the verify clock, its tail spilling across
    iterations, and the portion overlapping the launch iteration's
    main-stream work slows the main clock by ``stream_contention *
    overlap``.  A verify-only iteration waits out its verdict, exactly as
    the engine's event-driven skip does.  ``total_s`` is the two-stream
    makespan.  (Iterations the engine spent fully verdict-gated emit no
    events and are invisible to any log replay — when the engine itself
    ran a costed clock, ``engine.runtime.makespan`` is authoritative.)
    """
    from repro_torch.serving import streams  # local import: streams is a leaf

    breakdown: Dict[str, float] = {}

    def cost_fn(ev: Dict[str, Any]) -> float:
        e = dict(ev, invariant=True) if invariant_mode else ev
        t = step_time(cfg, e, hw)
        breakdown[ev["kind"]] = breakdown.get(ev["kind"], 0.0) + t
        return t

    rt = streams.DualClockRuntime(
        cost_fn, latency=0.0, contention=hw.stream_contention
    )
    for ev in events:
        kind = ev.get("kind")
        rt.begin_iteration()
        if kind == "overlap":
            for k in ("decode", "prefill"):
                if k in ev:
                    rt.charge(ev[k])
            if "verify" in ev:
                rt.launch_verify(ev["verify"])
            for v in ev.get("verifies", ()):
                rt.launch_verify(v)
        elif kind == "verify":
            rt.launch_verify(ev, sync=not ev.get("deferred"))
        else:
            rt.charge(ev)
        rt.end_iteration()
    total = rt.makespan
    return StreamSim(
        total_s=total,
        main_busy_s=rt.main.busy,
        verify_busy_s=rt.verify.busy,
        verify_occupancy=rt.verify.busy / total if total > 0 else 0.0,
        breakdown=breakdown,
        peak_inflight=rt.peak_outstanding,
    )


def simulate(
    cfg: ModelConfig, events: Iterable[Dict[str, Any]], hw: Hardware = V5E,
    *, invariant_mode: bool = False,
) -> Dict[str, float]:
    """Stream-accounted total time + leaf per-kind breakdown for an event
    log.  ``total_s`` is the two-stream makespan (``simulate_streams``);
    the per-kind entries are device seconds per pass kind, so their sum
    can exceed ``total_s`` when streams overlapped."""
    sim = simulate_streams(cfg, events, hw, invariant_mode=invariant_mode)
    return {
        "total_s": sim.total_s,
        "main_busy_s": sim.main_busy_s,
        "verify_busy_s": sim.verify_busy_s,
        "verify_occupancy": sim.verify_occupancy,
        "peak_inflight": sim.peak_inflight,
        **{f"{k}_s": v for k, v in sim.breakdown.items()},
    }


def throughput_tokens_per_s(
    cfg: ModelConfig, events: List[Dict[str, Any]], output_tokens: int,
    hw: Hardware = V5E, *, invariant_mode: bool = False,
) -> float:
    sim = simulate(cfg, events, hw, invariant_mode=invariant_mode)
    return output_tokens / max(sim["total_s"], 1e-12)
