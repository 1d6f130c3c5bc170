#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

Drives ``repro_torch`` (never JAX, never the JAX package) at the full width
of Llama-3-8B (``repro_torch/configs/llama3_8b.py::config``), random weights
from a seed, on both memory lanes: the paged lane (``paged_attention=True``,
the main path) and the gathered lane (``paged_attention=False``):

1. build   compile the six Hopper kernels from ``src/repro_torch/kernels/
           csrc`` (nvcc, in parallel), print ``ptxas -v``'s registers,
           shared memory and spills per kernel, and the card's name and
           power limit;
2. kernels hold each kernel against its plain PyTorch version at the main
           path's shapes (tolerance printed; the paged pair at the headline,
           serve and default-reach shapes of ``paged_shapes``, a long
           context and odd block sizes and widths; ``decode_attention`` at
           the five ``decode_shapes``, D = 64 and f32 operands; ``rmsnorm``
           at 32, 256 and 16384 rows with a bf16 and an f32 scale), plus
           row invariance across M (the commit GEMM at all five projection
           shapes and at an uneven chunk cut) and B (the commit paged
           kernel and ``decode_attention`` at kv_splits 1 for B in
           {1, 3, 8, 13} at each shape, and the same bits at a 128- and a
           2056-entry table, or a 2048- and a 32896-slot view), bitwise
           repeatability of the commit kernels, split and combine
           sensitivity of the fast kernels, the split-K kernel's TP fold
           (tp 2 and 4 x splits 1, 4 and 8 x combine bf16 and f32, pinned,
           uneven nested chunks; tp 1 and tp 4 differ) and its partials
           entry (each TP chunk's value against its plain version, their
           pinned tree bitwise the fold, a rank's K slice at d = 2 and 4
           bitwise its chunks of the whole call), which GEMM partial tile each
           operand dtype runs (bf16: tensor cores, f32: CUDA cores) and that
           an ``rmsnorm`` call is one launch (by kernel name in a profiler
           trace);
3. serve   serve requests through ``launch/serve.py``'s request builder in
           LLM42, BATCH_INVARIANT and NONDET mode on each lane, each run
           with every kernel's launch count reset just before it and read
           just after; the counts must equal what the engine's passes
           imply, and each run must reach exactly its kernels; ``rmsnorm``
           is on no serve path (its contract is not the model's norm), so
           its own path is its entry point ``kernels.ops.rmsnorm``, driven
           with counts reset the same way; every run's engine holds exactly
           the programs its events name, each captured once after one
           warm-up run (``check_programs``; the variants, families,
           modalities and hybrid runs hold it too); then a 2-layer cut's
           logits on the card against the CPU, on each lane;
3a. programs every serving step as a replay of a program captured once per
           shape class (``serving/programs.py``) against ``eager()`` (each
           body called directly), at 16 of Llama-3-8B's 32 layers, both
           lanes, all three modes, chunked prefill and two verify windows
           in flight: streams bitwise equal, launches per kernel equal,
           the programs exactly the events' keys; traffic B after traffic
           A on one engine equal to ``eager()``'s and to a fresh engine's
           deterministic streams; host wall, captures and their seconds,
           peak and reserved memory of both;
4. determinism  the divergence demo's experiment on each lane (16 of the
           serve model's 32 layers), with greedy and seeded deterministic
           requests: LLM42 and
           BATCH_INVARIANT streams must be bitwise identical alone and
           beside 3 and 6 neighbours, and the gathered lane's LLM42 streams
           equal to the paged lane's (NONDET divergence is printed); then
           paged LLM42 with the fast path at TP widths 2 and 4
           (``Engine(tp=N)``), alone and beside 3 neighbours, must commit
           the tp 1 streams, launches held to the passes (NONDET at tp 1
           against tp 4 printed);
5. profile ``torch.profiler`` over a window of 4 iterations of a paged
           LLM42 run's second traffic, on programs and under ``eager()``:
           device time by kernel, the GEMMs' and the paged kernels' share,
           the device's busy share, host wall per iteration, the host's
           graph and kernel launch calls, the programs' captures and
           capture seconds; then a short run of every lane and mode,
           whose GEMMs must all run the tensor-core tile (by kernel name);
6. online  the online runner (``serving.online.run_online``) on the H100
           cost model's clock at the serve phase's width and capacity: 16
           ShareGPT-length requests under Poisson arrivals, half of them
           deterministic (greedy and seeded); it must drain with every
           latency >= TTFT > 0 while the decode batch changes, two runs must
           give the same event log and modeled times, and each
           deterministic request must commit what it commits alone; prints
           p50/p99 latency and TTFT on the modeled clock beside the CUDA-event
           device time and host wall time, and first the GEMM calibration of
           the ``costmodel.H100`` entry (``bi_compute_frac``, ``sat_rows``);
7. analysis the determinism-contract checker (``repro_torch.analysis``) on
           CUDA tensors: the taint pass and the CUDA kernel lint, then the
           engine's verify, prefill-chunk and batch-invariant decode bodies
           recorded for all four arch classes at batches 13, 17 and 19 and
           at TP widths 1, 2 and 4, every commit kind proved invariant,
           both negative controls differing, the hazard pass clean modulo
           the allowlist and no fast kernel node on a commit kind (each
           kind's kernel nodes printed); the attention class again at
           Llama-3-8B's full width and depth (the serve phase's weights);
           a smoke verify recorded with TF32 on, which must be flagged;
           the card's canonical programs beside the CPU's from this
           process; seconds per part;
8. configs tinyllama-1.1b (22 layers), phi3-mini-3.8b (32), internlm2-20b
           (12 of 48) and command-r-35b (8 of 40) at full width: the
           attention kernels at each config's (H, KV, D) at the headline and
           serve shapes against their plain versions with rows across B,
           the commit GEMM at its LM head (vocab up to 256000) with rows
           across M, a short paged LLM42 serve whose deterministic streams
           must be identical alone and beside 3 neighbours (launches reset
           and checked as in the serve phase), command-r's forward checked
           for a copy of its tied embedding, and peak device memory;
9. variants llama4-scout-17b-a16e (4 of 48 layers; MoE, heads 40/8, G = 5)
           and its chunked8k variant (2 layers, window 8192), phi3-mini-3.8b-
           sw4k (4 of 32 layers, window 4096) at full width: the attention
           kernels and the commit GEMM at Scout's shapes (as in configs),
           ``moe_ffn`` rows bitwise across T and a ring's W == 1 rows across B
           (rings that wrapped), Scout's LLM42 and BATCH_INVARIANT streams
           alone and beside 3 neighbours on both lanes (NONDET divergence
           printed), phi3-sw4k's with 4200- and 4300-token prompts (ring-
           capped prefill chunks, decode past the wrap), chunked8k's LLM42
           stream of an 8300-token prompt beside 1 neighbour, each run's
           launches held to its passes (3 x 16 expert launches a MoE layer a
           pass; no attention kernel on a ring), then the gathered lane's
           q-chunked prefill of a 3000-token prompt at llama3-8b's width
           against the paged lane; peak device memory per config;
10. families kimi-k2-1t-a32b (2 of 61 layers: its first_k_dense head layer
           and one MoE layer of 384 experts; heads 64/8 of 112) and rwkv6-3b
           (8 of 32 layers, recurrent state) at full width: the attention
           kernels at G = 8, D = 112 (rows across B) and their times at the
           headline and serve shapes, each family's projection GEMMs, one
           kimi MoE layer timed and its rows across T, kimi's LLM42 and
           BATCH_INVARIANT streams alone and beside 3 on both lanes, rwkv's
           ``time_mix`` rows across B under the commit schedule beside
           ``einsum``'s, its streams beside 3, and its LLM42 run under
           overlap at spec_depth 2 with a verify latency equal to the pause
           run with the state pool at depth 2 (NONDET printed; launches
           held to the passes; peak memory and device time per run);
11. modalities seamless-m4t-medium (encoder-decoder: 12 encoder and 12
           decoder layers, 1024 encoder frames) and llava-next-mistral-7b
           (2880 prefix embeddings before the prompt, 8 of 32 layers) at
           full width, stub frontend embeddings from
           ``models/multimodal.py``: ``decode_attention`` at the cross shape
           (H = KV = 16, D = 64, 1024 valid keys) against its plain version
           with rows across B, timed beside ``sdpa``; seamless's head
           shapes and its LM head padded to N = 256208 (rows across M, the
           padded columns zero, timed beside ``torch.matmul``); both GEMMs
           at seamless's projections, the commit GEMM also at the encoder's
           M = 1024; one encoder build's device time and launches;
           cross-attention's W == 1 rows bitwise across B under the commit
           schedule; the paged lane's cross gather at B = 8 timed beside a
           whole decode pass; both configs' LLM42
           and BATCH_INVARIANT streams alone and beside 3 on both lanes, the
           lanes equal (NONDET printed); a preempted and restored seamless
           request (its cross cache rebuilt bitwise) committing the
           unpressured stream; llava's chunked prefill at two chunk sizes
           that cut the prefix inside a chunk committing the exclusive
           prefill's streams (launches held to the passes, peak memory per
           config);
12. hybrid  jamba-1.5-large-398b's ``mamba_layer`` at its published widths
           (d_model 8192, d_inner 16384, d_state 16, d_conv 4, dt_rank 512,
           bf16; one period of 8 layers does not fit one card) under the
           commit schedule: out and both per-position state leaves bitwise
           across B in {1, 7, 32} at W = 1 and 8, its device time at B = 8,
           W = 1 with its launches per call; then the jamba-smoke engine
           (attention and mamba layers in a block period of 2, MoE on every
           other layer): LLM42 and BATCH_INVARIANT streams alone and beside
           3 neighbours on both lanes, the lanes equal (NONDET printed),
           overlap at spec_depth 2 equal to pause, a preempted and restored
           request equal to the unpressured run (launches held to the
           passes);
13. distribution ``distributed.sharding.tp_matmul``'s fallback on a
           DeviceMesh over an NCCL group of world size 1 (d = 1: the
           logical path, no collective; NCCL at d > 1 takes a card a rank:
           the optional ``distribution4`` phase below)
           and the d = 2 and 4 rank programs run one after another through
           tp_matmul's own parts (``tp_rank_partial``: the commit GEMM's
           partials entry on the rank's K slice and its local subtree;
           ``tp_butterfly``'s adds),
           every rank bitwise the four-chunk commit GEMM at Llama-3-8B's
           widths (K, N) (4096, 4096), (4096, 1024), (4096, 14336), (4096,
           128256), (14336, 4096) x M 1, 8, 32; the un-pinned bf16 ring
           combine against tp 1 printed (negative control); the d = 4 rank
           programs' device time beside one four-chunk launch; then the
           dry run (``launch.dryrun.run_case``, the meta device) of every
           arch but kimi-k2 at decode_32k on both production meshes and at
           verify_32k while a 30 s budget lasts: no case may fail; each
           case's argument GiB a rank printed beside the card's memory
           (kimi-k2's cases: the optional ``dryrun_kimi`` phase, named in
           ``--phases`` only);
    distribution4 (optional, named in ``--phases`` only; needs four cards
           and fails on fewer) ``tp_matmul`` over NCCL with one card a
           rank: the parent builds the kernels, then starts 4 ranks
           (``torch.multiprocessing.spawn``), each bound to its card, which
           build DeviceMeshes (4, 1), (2, 2) and (1, 4) (d = 1, 2, 4); at the
           distribution phase's shapes and M every rank's result is bitwise
           the four-chunk commit GEMM on its own card and every rank holds
           the same bits; the split schedules (splits 2 and 8 x combine
           bf16 and f32, pinned) bitwise the logical split-K GEMM at every
           d; the un-pinned schedule (bf16 all-reduce) differs between
           d = 4 and d = 1 (whether two d = 4 runs agree printed); one
           partials launch per call; device times (CUDA events, the
           maximum over ranks: a local launch the median of 100, a
           collective the median of 5 rounds of 20 calls back to back) of
           the one-card commit GEMM, a rank's local partial, each butterfly
           level's exchange, the whole
           ``tp_matmul`` at d = 2 and 4 and the un-pinned all-reduce at
           M = 8, and a bf16 (tokens, 4096) all-reduce at tokens 8, 128 and
           2048 over 2 and 4 cards with its rate by the cost model's
           formula (bytes x 2(tp - 1)/tp over the time);
14. cluster replicas 1, 2 and 3 of one tinyllama-1.1b engine (11 of 22
           layers, full width, priced by the H100 clock at 22) on one card,
           sharing the weights, each with its own paged pool, behind the deterministic router (``cluster/``) on
           the ``costmodel.H100`` clock: 12 requests of a shared 2-block
           prefix at fixed modeled arrivals, half deterministic (greedy
           and seeded), ``imbalance=1``; each deterministic request commits
           its solo stream at every replica count under ``copy`` and
           ``recompute``; a repeated 3-replica run gives the same
           assignment, latencies, TTFTs and event logs; the guard diverts,
           and the blocks ``copy_blocks`` moves equal the source rows
           bitwise; each replica's launches equal its passes; the merged
           trace validates; modeled throughput, goodput (TTFT <= 1 s) and
           occupancy per replica; ``copy_blocks`` timed beside its bytes
           bound; the device memory allocated before the phase and after
           it, with everything it made dropped (at most 64 MiB more);
15. training the GEMMs' backward (``kernels.ops.GemmGrad``: dX = dY W^T
           and dW = X^T dY in the commit GEMM) against the plain version's
           autograd at tinyllama's projection shapes and LM head, at M =
           2048 and 1003, dX's rows bitwise across M, each product timed
           beside ``torch.matmul`` and its bound; then 4 AdamW steps of
           tinyllama (22 layers, full width) at 4 x 512 tokens with remat:
           launches per step held to the forward, recompute and backward
           GEMMs (no split-K), a second run bitwise equal, the loss lower
           on the first batch, remat=False gradients bitwise equal, two
           microbatches within 4 bf16 ulps, a checkpoint after step 2
           resumed bitwise into step 4; step time (CUDA events), tok/s and
           peak memory; one more step split at its gradients and its update
           (device memory held and peak in each half), and one under
           ``torch.profiler`` (device time by kernel, busy share); then 4
           AdamW steps of jamba-smoke (the hybrid family: attention and
           mamba layers, MoE) at 4 x 64 tokens, with remat twice and
           without it once, bitwise equal, launches per step held to the
           step's GEMMs, step time and peak memory; the same for one mamba
           layer at jamba-1.5-large's published widths (bf16, autograd
           through its per-position loop, AdamW on its leaves);
16. timings each kernel against its plain version and one PyTorch call,
           beside the least time the card could take (100 launches a
           reading); both GEMMs beside ``torch.matmul`` at every projection
           shape and serve-run M, their device time per forward, and the
           host time per GEMM call; the split-K library's partials entry at
           a d = 4 rank's share of the decode FFN GEMM; the timer's floor;
           the paged pair at
           each of ``paged_shapes``, B = 64 and a long context;
           ``decode_attention`` at each of ``decode_shapes`` beside
           ``scaled_dot_product_attention``; ``rmsnorm`` at 32, 256 and
           16384 rows beside ``F.rms_norm`` (the same function without a
           residual) and with a residual.

The line before the last is a JSON object describing every kernel
(``launches`` sums the serve runs, the rmsnorm entry-point run, the
cluster runs and every training pass, each as its counters measured it;
``launches_by_mode`` splits them by lane, mode and run and adds the online
run's, each config's and each variants, families and modalities run's, and
the backward products' check and the distribution phases' runs, which are
comparisons with the logical commit GEMM and so stay out of
``launches``; ``max_abs_err_by_config`` holds the configs, variants,
families and modalities phases' errors, and the commit GEMM's ``backward``
the backward products' error and times); the last line is
``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script exits non-zero without a result when no CUDA device
is visible or when it runs outside a checkout of the repository.

    python3 chip_smoke.py                 # everything, one card
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,programs,profile
    python3 chip_smoke.py --phases build,timings
    python3 chip_smoke.py --phases build,online,configs
    python3 chip_smoke.py --phases build,variants
    python3 chip_smoke.py --phases build,families
    python3 chip_smoke.py --phases build,modalities
    python3 chip_smoke.py --phases build,hybrid
    python3 chip_smoke.py --phases build,cluster,training
    python3 chip_smoke.py --phases build,distribution,training
    python3 chip_smoke.py --phases build,dryrun_kimi
    python3 chip_smoke.py --phases build,distribution4   # four cards
    python3 chip_smoke.py --phases build,analysis
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS refuses PyTorch's deterministic mode without a workspace config;
# it must be set before the first cuBLAS handle exists
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "serve", "programs", "determinism", "profile", "online",
          "analysis",
          "configs", "variants", "families", "modalities", "hybrid", "distribution",
          "cluster", "training", "timings")
#: phases outside the default run, only by name in ``--phases``
OPTIONAL_PHASES = ("dryrun_kimi", "distribution4")

#: per-request KV reach of the serve phase (128 blocks of 16).  The paged
#: kernels' cost no longer follows the reach (the timings phase times them
#: at the engine's default, max_seq_len, too), but the gathered lane copies
#: every row's whole view per pass and its dense decode kernel spans it, and
#: the pool grows with the reach, so the serve runs keep this reach
CAPACITY = 2048

#: block size of the paged shapes (the engine's default)
BLOCK = 16

#: device clock cycles the timer sleeps before each timed launch (about
#: 0.1 ms at the H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 200_000

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
#: f32 outside the tensor cores (the commit GEMM's f32 tile, MoE experts)
F32_FLOPS_PER_S = 67e12

#: the device every phase runs on
DEV = "cuda"

#: paged attention against its plain version (outputs |o| < 3): the commit
#: kernel and the f32 combine differ from their plain versions only in f32
#: summation order (3.6e-7 measured on an H100); the bf16 combine also in
#: which e values round across a bf16 boundary (2.1e-5 measured)
ATTN_TOL = 2e-6
FAST_ATTN_TOL = {"float32": 2e-6, "bfloat16": 1e-4}
#: dense decode attention (bf16 in and out) against its plain version, in
#: bf16 ulps of max|ref|: the two sum the same f32 terms in another order,
#: so an output may round one ulp apart, and with the bf16 combine a
#: running d or o may also round across a bf16 boundary (at most 0.12 ulps
#: measured on an H100, D 64 and 128, kv_splits 1 and 4)
DECODE_ULPS = {"float32": 1, "bfloat16": 2}
#: rmsnorm against its plain version, in ulps of max|ref| in the output
#: dtype: the sum of squares is taken in another order (0.25 bf16 ulps at
#: D = 4096, 2 f32 ulps at D = 300 measured on an H100)
RMSNORM_ULPS = {"bfloat16": 1, "float32": 4}
#: mean |card - CPU| of the reference logits, in bf16 ulps of max|ref|
#: (0.13 measured on an H100: 30 % of the logits agree bitwise, the rest
#: mostly one ulp apart)
REF_MEAN_ULPS = 0.25

KERNELS = {
    "gemm_batch_invariant": {
        "source": "src/repro_torch/kernels/csrc/gemm_batch_invariant.cu",
        "replaces": "src/repro/kernels/gemm_batch_invariant.py:58",
    },
    "gemm_splitk": {
        "source": "src/repro_torch/kernels/csrc/gemm_splitk.cu",
        "replaces": "src/repro/kernels/gemm_splitk.py:63",
    },
    "paged_attention": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:99",
    },
    "paged_attention_fast": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:190",
    },
    "decode_attention": {
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:76",
    },
    "rmsnorm": {
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:43",
    },
}

#: the two memory lanes the serve and determinism phases drive
LANES = {"paged": True, "gathered": False}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def timed(name, phase, *args) -> None:
    t0 = time.perf_counter()
    phase(*args)
    log(f"[time] {name} phase: {time.perf_counter() - t0:.1f} s")


def sync(torch) -> None:
    torch.cuda.synchronize()


def ulp_of(x_max: float, mant: int) -> float:
    """One ulp at magnitude ``x_max`` for a float type with ``mant``
    fraction bits (bf16 7, f32 23)."""
    return 2.0 ** (math.floor(math.log2(max(x_max, 2.0 ** -126))) - mant)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    import re

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    version = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()
    log(f"[build] {len(logs)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s -> {build.BUILD_DIR} "
        f"({version[-1] if version else 'nvcc version unknown'})")
    # ptxas -v for the GEMM partial tiles, the attention kernels (bf16,
    # D = 128 and 112) and rmsnorm (bf16 x and scale, 4 vectors a lane: D = 4096):
    # registers, static shared memory, stack and spill bytes (the rings are
    # dynamic shared memory)
    for stem, text in logs.items():
        kernel, spills = None, ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                found = re.search(r"(wgmma|fmaf)_partial_kernel", line)
                head = re.search(r"(?:bfloat16|merge_kernelI)Li4ELi(128|112)EE", line)
                if found is None and head:
                    # the attention kernels at bf16, D = 128 (the main path's)
                    # and D = 112 (kimi-k2's, lanes 28-31 masked)
                    found = re.search(
                        r"(paged_(attention|split|merge)|decode_attention)_kernel", line)
                if found is None and re.search(r"rmsnorm_kernelI13__nv_bfloat16S\w*_Li4E",
                                               line):
                    found = re.search(r"rmsnorm_kernel", line)
                kernel = found.group(0) if found else None
                if found and head:
                    kernel += f" D={head.group(1)}"
            elif kernel and "spill" in line:
                spills = line.strip()
            elif kernel and "Used" in line:
                log(f"[build] {stem} {kernel}: {line.split(':', 1)[-1].strip()}; "
                    f"{spills}")
                kernel = None
    for stem in build.ENTRY_POINTS:
        build.load(stem)


# ---------------------------------------------------------------------------
# shapes of the main path (Llama-3-8B width)
# ---------------------------------------------------------------------------


def paged_inputs(torch, cfg, B, capacity, block_size, seed, min_ctx, max_ctx):
    """Pools and tables shaped as the engine's at ``capacity``: each row
    owns a private run of blocks covering a context drawn in
    [min_ctx, max_ctx); the rest of its table is -1."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    nblk = -(-capacity // block_size)
    NB = B * nblk + 2
    KV, D, H = cfg.num_kv_heads, cfg.hd, cfg.num_heads
    dt = getattr(torch, cfg.dtype)
    k = torch.randn((NB, block_size, KV, D), generator=g, device=DEV).to(dt)
    v = torch.randn((NB, block_size, KV, D), generator=g, device=DEV).to(dt)
    pos = torch.full((NB, block_size), -1, dtype=torch.int32, device=DEV)
    tables = torch.full((B, nblk), -1, dtype=torch.int32, device=DEV)
    ctx = torch.randint(min_ctx, max_ctx, (B,), generator=g, device=DEV)
    for b in range(B):
        n = int(ctx[b])
        blocks = list(range(b * nblk, b * nblk + -(-n // block_size)))
        tables[b, : len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
        flat = torch.arange(n, dtype=torch.int32, device=DEV)
        pos.view(-1)[b * nblk * block_size: b * nblk * block_size + n] = flat
    q = torch.randn((B, H, D), generator=g, device=DEV).to(dt)
    q_pos = (ctx - 1).to(torch.int32)
    return q, k, v, pos, tables, q_pos, ctx


def widen(torch, inputs, nblk):
    """The same rows with their tables padded with -1 to ``nblk``
    entries: the same blocks at a longer table reach."""
    q, k, v, pos, tables, q_pos, ctx = inputs
    wide = torch.full((tables.shape[0], nblk), -1, dtype=torch.int32, device=DEV)
    wide[:, : tables.shape[1]] = tables
    return q, k, v, pos, wide, q_pos, ctx


def paged_shapes(torch, cfg, names=("headline", "serve", "default reach")):
    """The paged kernels' three shapes (those of ``names``), B = 8, blocks
    of 16: ``headline`` (a 128-entry table, contexts in [512, 2048), the
    kernel table's shape), ``serve`` (a 128-entry table, the serve phase's
    contexts: 32 prompt tokens and up to 16 new ones) and ``default reach``
    (the serve rows with their tables at the engine's default capacity,
    cfg.max_seq_len: a 2056-entry table)."""
    serve = paged_inputs(torch, cfg, 8, CAPACITY, BLOCK, seed=13, min_ctx=33, max_ctx=49)
    shapes = {
        "headline": lambda: paged_inputs(torch, cfg, 8, CAPACITY, BLOCK, seed=3,
                                         min_ctx=512, max_ctx=2048),
        "serve": lambda: serve,
        "default reach": lambda: widen(torch, serve, -(-cfg.max_seq_len // BLOCK)),
    }
    return {name: shapes[name]() for name in names}


def long_inputs(torch, cfg):
    """B = 8 contexts in [8192, 16384) at the default reach: a fast-kernel
    CTA holds more keys than its score buffer at any of FAST_PATH_POLICY's
    split counts, so it reads K a second time."""
    return paged_inputs(torch, cfg, 8, cfg.max_seq_len, BLOCK, seed=14,
                        min_ctx=8192, max_ctx=16384)


def wide_batch_inputs(torch, cfg):
    """B = 64 rows with the headline's contexts: the batch at which
    FAST_PATH_POLICY gives the fast kernel one split."""
    return paged_inputs(torch, cfg, 64, CAPACITY, BLOCK, seed=16, min_ctx=512,
                        max_ctx=2048)


def decode_inputs(torch, B, S, H, KV, D, seed, min_len, max_len, dt=None):
    """q (B,H,D), dense k/v (B,S,KV,D) and lengths in [min_len, max_len)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    dt = dt or torch.bfloat16
    q = torch.randn((B, H, D), generator=g, device=DEV).to(dt)
    k = torch.randn((B, S, KV, D), generator=g, device=DEV).to(dt)
    v = torch.randn((B, S, KV, D), generator=g, device=DEV).to(dt)
    lengths = torch.randint(min_len, max_len, (B,), generator=g, device=DEV,
                            dtype=torch.int32)
    return q, k, v, lengths


DECODE_SHAPES = ("headline", "serve", "default reach", "B=64", "long")


def decode_shapes(torch, cfg, names=DECODE_SHAPES):
    """The dense decode kernel's five shapes (those of ``names``) at the
    config's heads (Llama-3-8B's in the kernels phase), bf16, mirroring
    ``paged_shapes``: ``headline`` (B = 8 over a 2048-slot view,
    lengths in [512, 2048)), ``serve`` (the serve phase's lengths: 32 prompt
    tokens plus up to 16 committed and 7 speculated), ``default reach`` (the
    serve rows in a view of cfg.max_seq_len slots, the engine's default
    capacity; the slots past 2048 hold other random keys, which no valid
    length reaches), ``B=64`` (the headline's lengths) and ``long`` (B = 8
    over 16384 slots, lengths in [8192, 16384)); on request (not in
    DECODE_SHAPES) ``cross``: an encoder-decoder config's cross-attention,
    B = 8 over its encoder_seq_len frames, every key valid."""
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    serve = decode_inputs(torch, 8, 2048, H, KV, D, seed=8, min_len=33, max_len=56)

    def default_reach():
        q, k, v, lens = serve
        g = torch.Generator(device=DEV).manual_seed(17)
        wide = [torch.randn((8, cfg.max_seq_len, KV, D), generator=g,
                            device=DEV).to(k.dtype) for _ in range(2)]
        for w, t in zip(wide, (k, v)):
            w[:, : t.shape[1]] = t
        return q, wide[0], wide[1], lens

    shapes = {
        "headline": lambda: decode_inputs(torch, 8, 2048, H, KV, D, seed=3,
                                          min_len=512, max_len=2048),
        "serve": lambda: serve,
        "default reach": default_reach,
        "B=64": lambda: decode_inputs(torch, 64, 2048, H, KV, D, seed=16,
                                      min_len=512, max_len=2048),
        "long": lambda: decode_inputs(torch, 8, 16384, H, KV, D, seed=14,
                                      min_len=8192, max_len=16384),
        "cross": lambda: decode_inputs(torch, 8, cfg.encoder_seq_len, H, KV, D, seed=20,
                                       min_len=cfg.encoder_seq_len,
                                       max_len=cfg.encoder_seq_len + 1),
    }
    return {name: shapes[name]() for name in names}


def decode_bound(q, k, lengths):
    """Bytes a dense decode must move: q, every valid key and value row, the
    lengths, the output in q's dtype."""
    B, H, D = q.shape
    KV, elt = k.shape[2], k.element_size()
    n_valid = int(lengths.clamp(0, k.shape[1]).sum())
    nbytes = 2 * q.numel() * elt + n_valid * KV * D * elt * 2 + B * 4
    return bound(nbytes, 4.0 * n_valid * H * D)


def gemm_bound(M, K, N, elt=2):
    nbytes = (M * K + K * N + M * N) * elt
    flops = 2.0 * M * N * K
    return bound(nbytes, flops)


def bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(cfg, q, ctx, block_size, tables):
    """Bytes a paged decode must move: q, every valid key and value row,
    the positions of the blocks it reads, the tables and q_pos, the f32
    output."""
    B, H, D = q.shape
    KV = cfg.num_kv_heads
    n_valid = int(ctx.sum())
    n_blocks = int(sum(-(-int(c) // block_size) for c in ctx))
    nbytes = (q.numel() * 2 + n_valid * KV * D * 2 * 2
              + n_blocks * block_size * 4 + tables.numel() * 4 + B * 4
              + q.numel() * 4)
    flops = 4.0 * n_valid * H * D
    return bound(nbytes, flops)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(torch, cfg, results) -> None:
    from repro_torch.core.determinism import CANONICAL_TP_SHARDS
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEV).manual_seed(0)
    bf = torch.bfloat16
    D, F = cfg.d_model, cfg.d_ff

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEV) * scale).to(bf)

    def bf16_tol(ref_out, ulps):
        return float(ref_out.float().abs().max()) * 2.0 ** -8 * ulps

    # -- kernel 1: commit GEMM, every projection shape of a verify pass (M=32);
    # at each, a row's bits must not depend on M, and a call must repeat
    worst = 0.0
    for K, N in projections(cfg):
        x, w = rnd(32, K), rnd(K, N, scale=K ** -0.5)
        out = gemm_batch_invariant(x, w, chunks=CANONICAL_TP_SHARDS)
        want = ref.gemm_batch_invariant(x, w, chunks=CANONICAL_TP_SHARDS)
        sync(torch)
        err = float((out.float() - want.float()).abs().max())
        tol = bf16_tol(want, 2)
        log(f"[kernels] gemm_batch_invariant (32,{K})@({K},{N}) chunks=4: "
            f"max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps of max|ref|)")
        require(err <= tol, "gemm_batch_invariant disagrees with its plain version")
        worst = max(worst, err)
        commit_rows_invariant(torch, gemm_batch_invariant, rnd(200, K), w,
                              CANONICAL_TP_SHARDS)
        del x, w, out, want
    log(f"[kernels] gemm_batch_invariant rows bitwise identical for M in "
        f"{ROW_MS} at all {len(projections(cfg))} projection shapes; repeatable")
    # uneven chunks that are not multiples of the 64-column K step
    # (4096 = 1366 + 1365 + 1365): steps that cross a chunk bound
    x, w = rnd(200, D), rnd(D, 1024, scale=D ** -0.5)
    out = gemm_batch_invariant(x, w, chunks=3)
    want = ref.gemm_batch_invariant(x, w, chunks=3)
    err = float((out.float() - want.float()).abs().max())
    log(f"[kernels] gemm_batch_invariant (200,{D})@({D},1024) chunks=3 (uneven): "
        f"max_abs_err {err:.3e} (tol {bf16_tol(want, 2):.3e})")
    require(err <= bf16_tol(want, 2), "gemm_batch_invariant disagrees at an uneven cut")
    worst = max(worst, err)
    commit_rows_invariant(torch, gemm_batch_invariant, x, w, 3)
    log(f"[kernels] gemm_batch_invariant chunks=3: rows bitwise identical for M in "
        f"{ROW_MS}")
    # f32 operands: the kernel's arithmetic without the output rounding
    x, w = rnd(13, D).float(), rnd(D, 1024, scale=D ** -0.5).float()
    err32 = float((gemm_batch_invariant(x, w, chunks=4)
                   - ref.gemm_batch_invariant(x, w, chunks=4)).abs().max())
    log(f"[kernels] gemm_batch_invariant f32 (13,{D})@({D},1024): "
        f"max_abs_err {err32:.3e} (tol 1e-4)")
    require(err32 <= 1e-4, "gemm_batch_invariant f32 disagrees")
    results["gemm_batch_invariant"]["max_abs_err"] = worst
    check_gemm_tiles(torch, rnd, D)

    # -- kernel 2: fast split-K GEMM at the decode batch, every projection
    # shape a fast decode pass gives it, at FAST_PATH_POLICY's splits
    worst = 0.0
    for K, N in projections(cfg):
        w = rnd(K, N, scale=K ** -0.5)
        for M, splits in ((1, 8), (4, 4), (8, 4)):
            x = rnd(M, K)
            out = gemm_splitk(x, w, splits=splits, combine_dtype="bfloat16")
            want = ref.gemm_splitk(x, w, splits, "bfloat16")
            sync(torch)
            err = float((out.float() - want.float()).abs().max())
            tol = bf16_tol(want, 4)
            log(f"[kernels] gemm_splitk ({M},{K})@({K},{N}) splits={splits} bf16 "
                f"combine: max_abs_err {err:.3e} (tol {tol:.3e}, 4 bf16 ulps of max|ref|)")
            require(err <= tol, f"gemm_splitk disagrees at M={M} K={K} N={N}")
            worst = max(worst, err)
        del w, x, out, want
    # uneven splits that are not multiples of the K step (14336 = 4779 +
    # 4779 + 4778)
    x, w = rnd(4, F), rnd(F, 1024, scale=F ** -0.5)
    out = gemm_splitk(x, w, splits=3, combine_dtype="bfloat16")
    want = ref.gemm_splitk(x, w, 3, "bfloat16")
    err = float((out.float() - want.float()).abs().max())
    log(f"[kernels] gemm_splitk (4,{F})@({F},1024) splits=3 (uneven), bf16 combine: "
        f"max_abs_err {err:.3e} (tol {bf16_tol(want, 4):.3e})")
    require(err <= bf16_tol(want, 4), "gemm_splitk disagrees at an uneven cut")
    worst = max(worst, err)
    x, w = rnd(3, F).float(), rnd(F, 1000, scale=F ** -0.5).float()  # uneven K cut
    for splits in (1, 3, 8):
        err32 = float((gemm_splitk(x, w, splits=splits) - ref.gemm_splitk(x, w, splits)).abs().max())
        require(err32 <= 1e-4, f"gemm_splitk f32 disagrees at splits={splits}")
    log("[kernels] gemm_splitk f32, K=14336 over splits {1,3,8}: within 1e-4")
    results["gemm_splitk"]["max_abs_err"] = worst
    x, w = rnd(4, D), rnd(D, D, scale=D ** -0.5)
    one = gemm_splitk(x, w, splits=1, combine_dtype="bfloat16")
    eight = gemm_splitk(x, w, splits=8, combine_dtype="bfloat16")
    require(not torch.equal(one, eight), "gemm_splitk: splits 1 and 8 agree bitwise")
    log(f"[kernels] gemm_splitk splits 1 vs 8 (bf16 combine) differ at "
        f"{int((one != eight).sum())} of {one.numel()} outputs")
    check_tp_fold(torch, cfg, results, rnd, bf16_tol)

    check_paged_attention(torch, cfg, results)
    check_decode_attention(torch, cfg, results)
    check_rmsnorm(torch, cfg, results)


#: the TP fold's un-pinned cases at the headline shape: tp x splits x combine
TP_FOLD_CASES = tuple((tp, splits, cd, False) for tp in (2, 4) for splits in (1, 4, 8)
                      for cd in ("bfloat16", "float32"))
#: K of the uneven cases: tinyllama's d_ff (5632: tp 4 x splits 8 cuts
#: 176-column sub-chunks, off the 64-column K grid) and 4104 (tp 4 x splits
#: 8 cuts 1026-column chunks into 129 and 128 columns)
TP_FOLD_UNEVEN_K = (5632, 4104)


def check_tp_fold(torch, cfg, results, rnd, bf16_tol) -> None:
    """The split-K kernel's two-level TP fold (``tp_shards`` K chunks, each
    under the split schedule) against its plain version at the decode
    batch's FFN down projection, (8, d_ff) @ (d_ff, d_model): un-pinned at
    tp 2 and 4 x splits 1, 4 and 8 x combine bf16 and f32, pinned (the
    balanced f32 tree) at tp 4 x splits 4 and tp 2 x splits 8; uneven nested
    chunks at ``TP_FOLD_UNEVEN_K`` and f32 operands; within 4 bf16 ulps of
    max|ref| (1e-4 for f32 operands).  Negative control: the tp 1 and tp 4
    results differ."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_splitk import gemm_splitk

    D, F = cfg.d_model, cfg.d_ff

    def case(x, w, tp, splits, cd, pinned, tol_ulps=4):
        out = gemm_splitk(x, w, splits=splits, combine_dtype=cd, tp_shards=tp,
                          tp_pinned=pinned)
        want = ref.gemm_splitk(x, w, splits, cd, tp_shards=tp, tp_pinned=pinned)
        sync(torch)
        err = float((out.float() - want.float()).abs().max())
        tol = bf16_tol(want, tol_ulps) if x.dtype == torch.bfloat16 else 1e-4
        M, K = x.shape
        log(f"[kernels] gemm_splitk TP fold ({M},{K})@({K},{w.shape[1]}) tp={tp} "
            f"splits={splits} {cd} combine{' pinned' if pinned else ''}: max_abs_err "
            f"{err:.3e} (tol {tol:.3e})")
        require(err <= tol, f"gemm_splitk TP fold disagrees at K={K} tp={tp} "
                f"splits={splits} {cd} pinned={pinned}")
        return err, out

    x, w = rnd(8, F), rnd(F, D, scale=F ** -0.5)
    worst = 0.0
    for tp, splits, cd, pinned in TP_FOLD_CASES + ((4, 4, "bfloat16", True),
                                                   (2, 8, "float32", True)):
        worst = max(worst, case(x, w, tp, splits, cd, pinned)[0])
    for K in TP_FOLD_UNEVEN_K:
        xu, wu = rnd(8, K), rnd(K, 2048, scale=K ** -0.5)
        for tp, splits, cd in ((4, 8, "bfloat16"), (2, 4, "float32")):
            worst = max(worst, case(xu, wu, tp, splits, cd, False)[0])
    xf, wf = rnd(5, F).float(), rnd(F, 1000, scale=F ** -0.5).float()
    case(xf, wf, 4, 8, "bfloat16", False)
    case(xf, wf, 4, 1, "float32", True)
    pworst = check_splitk_partials(torch, x, w)
    tp1 = gemm_splitk(x, w, splits=4, combine_dtype="bfloat16", tp_shards=1)
    tp4 = gemm_splitk(x, w, splits=4, combine_dtype="bfloat16", tp_shards=4)
    require(not torch.equal(tp1, tp4), "gemm_splitk: tp 1 and tp 4 agree bitwise")
    log(f"[kernels] gemm_splitk TP fold: {len(TP_FOLD_CASES) + 2} cases at the headline "
        f"shape and uneven nested chunks at K in {TP_FOLD_UNEVEN_K} within 4 bf16 ulps "
        f"(worst {worst:.3e}); tp 1 vs tp 4 (splits 4, bf16 combine) differ at "
        f"{int((tp1 != tp4).sum())} of {tp1.numel()} outputs")
    results["gemm_splitk"]["tp_fold"] = {"max_abs_err": worst,
                                         "partials_max_abs_err": pworst}


#: the partials entry's cases: (tp_shards, splits, combine); the rank
#: slices of each are cut at d = 2 and 4
PARTIALS_CASES = ((4, 8, "bfloat16"), (4, 2, "float32"), (4, 1, "bfloat16"))


def check_splitk_partials(torch, x, w) -> float:
    """The split-K library's partials entry (``gemm_splitk_partials``, the
    TP chunk values before the cross-chunk fold) at ``PARTIALS_CASES`` on
    x (M, K) @ w (K, N): each chunk within 4 bf16 ulps of max|chunk| of
    its plain version (f32 sums of bf16 partials: 1e-4 with the f32
    combine); the pinned tree of the chunks bitwise the split-K kernel's
    pinned fold; and a rank's K slice (``tp_rank_partial``'s operands at
    d = 2 and 4) gives that rank's chunks of the whole call bit for bit.
    Returns the worst error."""
    from repro_torch.core.determinism import tree_combine
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_splitk import gemm_splitk, gemm_splitk_partials

    worst = 0.0
    K = x.shape[1]
    for tp, splits, cd in PARTIALS_CASES:
        vals = gemm_splitk_partials(x, w, splits=splits, combine_dtype=cd, tp_shards=tp)
        want = ref.gemm_splitk_partials(x, w, splits, cd, tp_shards=tp)
        for got, exp in zip(vals.unbind(0), want):
            err = float((got - exp).abs().max())
            tol = (float(exp.abs().max()) * 2.0 ** -8 * 4 if cd == "bfloat16" and splits > 1
                   else 1e-4)
            require(err <= tol, f"gemm_splitk_partials tp={tp} splits={splits} {cd}: "
                    f"{err:.3e} > {tol:.3e}")
            worst = max(worst, err)
        fold = gemm_splitk(x, w, splits=splits, combine_dtype=cd, tp_shards=tp,
                           tp_pinned=True)
        require(torch.equal(tree_combine(list(vals.unbind(0))).to(x.dtype), fold),
                f"gemm_splitk_partials tp={tp} splits={splits} {cd}: the pinned tree "
                "of the chunks is not the kernel's pinned fold")
        for d in (2, 4):
            span = K // d
            for r in range(d):
                part = gemm_splitk_partials(
                    x[:, r * span:(r + 1) * span], w[r * span:(r + 1) * span],
                    splits=splits, combine_dtype=cd, tp_shards=tp // d)
                require(torch.equal(part, vals[r * (tp // d):(r + 1) * (tp // d)]),
                        f"gemm_splitk_partials: rank {r} of d={d}'s K slice differs "
                        f"from its chunks of the whole call (splits={splits} {cd})")
    sync(torch)
    log(f"[kernels] gemm_splitk_partials {tuple(x.shape)}@{tuple(w.shape)} at "
        f"(tp, splits, combine) in {PARTIALS_CASES}: chunks within tolerance of the "
        f"plain version (worst {worst:.3e}), their pinned tree bitwise the kernel's "
        f"pinned fold, every rank's K slice at d = 2 and 4 bitwise its chunks")
    return worst


#: rows of the 8 at which the commit paged kernel's rows must keep their
#: bits: B = 1, 3 and 13 (the 8, then rows 0-4 again with their own tables
#: and q)
PAGED_ROWS = ((5,), (5, 1, 6), tuple(range(8)) + (0, 1, 2, 3, 4))

#: the fast paged kernel's (kv_splits, combine) cases at every shape
FAST_CASES = ((4, "bfloat16"), (8, "bfloat16"), (4, "float32"))


def paged_commit_case(torch, label, inp, phase="kernels"):
    """The commit paged kernel against its plain version on ``inp``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    q, k, v, pos, tab, qp, ctx = inp
    out = paged_attention(q, k, v, pos, tab, qp)
    want = ref.paged_attention(q, k, v, pos, tab, qp)
    err = float((out - want).abs().max())
    log(f"[{phase}] paged_attention {label}: B={q.shape[0]} nblk={tab.shape[1]} "
        f"bs={k.shape[1]} H={q.shape[1]} KV={k.shape[2]} D={q.shape[2]} "
        f"{str(q.dtype)[6:]}, {int(ctx.sum())} keys: max_abs_err {err:.3e} "
        f"(tol {ATTN_TOL:g})")
    require(err <= ATTN_TOL, f"paged_attention disagrees with its plain version ({label})")
    return out, err


def paged_fast_case(torch, label, inp, splits, cd, phase="kernels"):
    """The fast paged kernel against its plain version on ``inp``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_fast

    out = paged_attention_fast(*inp[:6], kv_splits=splits, combine_dtype=cd)
    want = ref.paged_attention_fast(*inp[:6], kv_splits=splits, combine_dtype=cd)
    err = float((out - want).abs().max())
    tol = FAST_ATTN_TOL[cd]
    log(f"[{phase}] paged_attention_fast {label} kv_splits={splits} {cd}: "
        f"max_abs_err {err:.3e} (tol {tol:g})")
    require(err <= tol, f"paged_attention_fast disagrees with its plain version ({label})")
    return out, want, err


def paged_rows_invariant(torch, label, inp, out, phase="kernels"):
    """The commit paged kernel's rows of ``out`` keep their bits at B in
    {1, 3, 13} (PAGED_ROWS), and a launch repeats bitwise."""
    from repro_torch.kernels.paged_attention import paged_attention

    q, k, v, pos, tab, qp, _ = inp
    for rows in PAGED_ROWS:
        sel = torch.tensor(rows, device=DEV)
        part = paged_attention(q[sel].contiguous(), k, v, pos, tab[sel].contiguous(),
                               qp[sel].contiguous())
        require(torch.equal(part, out[sel]),
                f"paged_attention rows change at B={len(rows)} ({label})")
    require(torch.equal(out, paged_attention(q, k, v, pos, tab, qp)),
            f"paged_attention is not repeatable ({label})")
    log(f"[{phase}] paged_attention {label}: rows bitwise identical for B in "
        f"{{1,3,8,13}}; repeatable")


def check_paged_attention(torch, cfg, results) -> None:
    """Kernels 3 and 4 at each of ``paged_shapes``, a long context and odd
    block sizes, widths and head groups, against their plain versions; the
    commit kernel's rows bitwise identical for B in {1, 3, 8, 13}, across
    launches, and at a 128- and a 2056-entry table; the fast kernel's split
    and combine sensitivity at the headline shape."""
    worst = worst_fast = 0.0
    shapes = paged_shapes(torch, cfg)
    commit_out = {}
    for label, inp in shapes.items():
        out, err = paged_commit_case(torch, label, inp)
        worst = max(worst, err)
        commit_out[label] = out
        paged_rows_invariant(torch, label, inp, out)
        for splits, cd in FAST_CASES:
            worst_fast = max(worst_fast, paged_fast_case(torch, label, inp, splits, cd)[2])
    require(torch.equal(commit_out["serve"], commit_out["default reach"]),
            "paged_attention rows change with the table reach")
    log("[kernels] paged_attention serve rows bitwise identical at a 128- and a "
        "2056-entry table")

    # split and combine sensitivity at the headline shape, and one split
    # (the B >= 64 case)
    head = shapes["headline"]
    outs, wants = {}, {}
    for splits, cd in FAST_CASES + ((1, "bfloat16"), (1, "float32")):
        outs[splits, cd], wants[splits, cd], err = paged_fast_case(
            torch, "headline", head, splits, cd)
        worst_fast = max(worst_fast, err)
    # the bf16 rounding of e is the TPU kernel's defining rounding point: in
    # every row the kernel's bf16-combine output must sit far closer to the
    # plain bf16 version than the plain bf16 and f32 versions sit apart
    rows = (1, 2)
    err_row = (outs[4, "bfloat16"] - wants[4, "bfloat16"]).abs().amax(dim=rows)
    gap_row = (wants[4, "bfloat16"] - wants[4, "float32"]).abs().amax(dim=rows)
    require(not torch.equal(outs[4, "bfloat16"], outs[4, "float32"]),
            "paged_attention_fast: bf16 and f32 combine agree bitwise")
    keep = gap_row > 0  # a one-key row has e == 1 in either dtype
    require(int(keep.sum()) >= len(keep) - 1, "too few rows tell bf16 from f32")
    ratio = float((err_row[keep] / gap_row[keep]).max())
    log(f"[kernels] paged_attention_fast kv_splits=4 bf16 vs f32 combine: plain "
        f"versions {float(gap_row.min()):.3e}..{float(gap_row.max()):.3e} apart "
        f"per row; kernel-to-plain error at most {ratio:.3f} of that gap (limit 0.25)")
    require(ratio <= 0.25, "paged_attention_fast does not round e to the combine dtype")
    one, four = outs[1, "bfloat16"], outs[4, "bfloat16"]
    require(not torch.equal(one, four), "paged_attention_fast: kv_splits 1 and 4 agree")
    log(f"[kernels] paged_attention_fast kv_splits 1 vs 4 (bf16 combine) differ "
        f"at {int((one != four).sum())} of {one.numel()} outputs")
    del shapes, head, outs, wants, commit_out

    # a long context: a fast-kernel CTA's keys exceed its score buffer (K
    # read twice)
    inp = long_inputs(torch, cfg)
    worst = max(worst, paged_commit_case(torch, "long", inp)[1])
    for splits, cd in ((1, "bfloat16"), (1, "float32"), (4, "bfloat16")):
        worst_fast = max(worst_fast, paged_fast_case(torch, "long", inp, splits, cd)[2])
    del inp

    # odd shapes: one-key blocks (a table slice of several compaction
    # windows, f32 pools, D = 64, G = 4), and 24-key blocks (a block of two
    # tiles, the second partial; bf16, D = 96, G = 6)
    for label, sub, B, cap, bs, lo, hi, splits in (
            ("bs=1", dict(num_heads=8, num_kv_heads=2, head_dim=64, dtype="float32"),
             2, 12000, 1, 2000, 12000, 2),
            ("bs=24", dict(num_heads=24, num_kv_heads=4, head_dim=96), 3, 600, 24, 1, 600, 5)):
        small = dataclasses.replace(cfg, **sub)
        inp = paged_inputs(torch, small, B, cap, bs, seed=15, min_ctx=lo, max_ctx=hi)
        worst = max(worst, paged_commit_case(torch, label, inp)[1])
        for sp, cd in ((1, "bfloat16"), (splits, "bfloat16"), (splits, "float32")):
            worst_fast = max(worst_fast, paged_fast_case(torch, label, inp, sp, cd)[2])
        del inp
    results["paged_attention"]["max_abs_err"] = worst
    results["paged_attention_fast"]["max_abs_err"] = worst_fast


#: batch sizes at which the commit GEMM's rows must keep their bits
ROW_MS = (1, 7, 13, 32, 128, 200)


def projections(cfg):
    """(K, N) of every matmul of a forward: wq and wo, wk and wv, the FFN's
    gate and up, its down projection, the unembedding."""
    D, F = cfg.d_model, cfg.d_ff
    return ((D, D), (D, cfg.num_kv_heads * cfg.hd), (D, F), (F, D),
            (D, cfg.vocab_size))


def commit_rows_invariant(torch, gemm, xb, w, chunks) -> None:
    """The first M rows of ``xb`` (200 rows or more) alone give the bits
    they give in the whole batch, for every M in ROW_MS; the call repeats
    bitwise."""
    full = gemm(xb, w, chunks=chunks)
    for M in ROW_MS:
        part = gemm(xb[:M].contiguous(), w, chunks=chunks)
        require(torch.equal(part, full[:M]),
                f"gemm_batch_invariant rows change at M={M}, K={w.shape[0]}, "
                f"N={w.shape[1]}, chunks={chunks}")
    require(torch.equal(full, gemm(xb, w, chunks=chunks)),
            "gemm_batch_invariant is not repeatable")


#: the GEMMs' partial tiles by kernel name: tensor cores (bf16 operands),
#: CUDA cores (f32 operands)
TENSOR_CORE_TILE, CUDA_CORE_TILE = "wgmma_partial_kernel", "fmaf_partial_kernel"


def trace_kernels(torch, fn, calls=1):
    """{name: launches} of every kernel that ``calls`` calls of ``fn()``
    launched, from a ``torch.profiler`` trace of the card's activity alone
    (no host ops, so a short serve run's trace sums in seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a trace now and then holds no activity at all
        sync(torch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            sync(torch)
        # the trace also holds the runtime's host calls (cudaLaunchKernelExC...)
        names = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if names:
            return names
    raise AssertionError("three profiler traces saw no activity on the card")


def gemm_tiles_run(torch, fn, calls=1):
    """The GEMM partial tiles that ``calls`` calls of ``fn()`` launched, by
    kernel name in a profiler trace, and the names of every kernel the
    trace holds."""
    names = sorted(trace_kernels(torch, fn, calls))
    return {tile for tile in (TENSOR_CORE_TILE, CUDA_CORE_TILE)
            if any(tile in name for name in names)}, names


def check_gemm_tiles(torch, rnd, D) -> None:
    """bf16 operands launch the tensor-core tile, f32 operands the CUDA-core
    tile, in both GEMMs."""
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk

    for dt, tile in ((torch.bfloat16, TENSOR_CORE_TILE), (torch.float32, CUDA_CORE_TILE)):
        x, w = rnd(8, D).to(dt), rnd(D, 1024).to(dt)
        for name, fn in (("gemm_batch_invariant", lambda: gemm_batch_invariant(x, w, chunks=4)),
                         ("gemm_splitk", lambda: gemm_splitk(x, w, splits=4))):
            # three calls: one trace of a single f32 call once held no
            # partial tile at all (the trace, not the GEMM, missed it)
            ran, names = gemm_tiles_run(torch, fn, calls=3)
            log(f"[kernels] {name}, {str(dt)[6:]} operands: partial tiles run {sorted(ran)}")
            require(ran == {tile}, f"{name}: {str(dt)[6:]} operands did not run only "
                                   f"{tile}; the trace holds {names}")


def rows_invariant(torch, fn, inputs, name):
    """Row 0 of ``inputs`` (each (N, ...), N = 200) alone, then at position
    p of batches of n rows drawn from the others: its output bits must not
    change."""
    alone = fn(*(t[:1].contiguous() for t in inputs))[0]
    for n, p in ((1, 0), (7, 5), (32, 17), (200, 199)):
        idx = list(range(1, n))
        idx.insert(p, 0)
        sel = torch.tensor(idx, device=DEV)
        out = fn(*(t.index_select(0, sel).contiguous() for t in inputs))
        require(torch.equal(out[p], alone), f"{name}: row bits change at B={n}, place {p}")
    log(f"[kernels] {name}: a row's bits identical alone and at places 5/17/199 "
        f"of batches of 7/32/200")


#: the dense decode kernel's schedules at every shape: FAST_PATH_POLICY at
#: B = 8 (kv_splits 4, bf16 combine) and the commit schedule (one split,
#: f32 combine)
DECODE_CASES = ((4, "bfloat16"), (1, "float32"))


def decode_case(torch, label, inp, splits, cd, phase="kernels"):
    """The dense decode kernel against its plain version on ``inp``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    q, k, v, lens = inp
    out = decode_attention(q, k, v, lens, kv_splits=splits, combine_dtype=cd)
    want = ref.decode_attention(q, k, v, lens, splits, cd)
    sync(torch)
    err = float((out.float() - want.float()).abs().max())
    ulp = ulp_of(float(want.float().abs().max()), 7)
    B, S, KV, D = k.shape
    log(f"[{phase}] decode_attention {label}: B={B} S={S} H={q.shape[1]} KV={KV} "
        f"D={D} {str(q.dtype)[6:]}, {int(lens.clamp(0, S).sum())} keys, "
        f"kv_splits={splits} {cd}: max_abs_err {err:.3e} = {err / ulp:.2f} bf16 "
        f"ulps (tol {DECODE_ULPS[cd]})")
    require(err <= DECODE_ULPS[cd] * ulp,
            f"decode_attention disagrees with its plain version ({label})")
    if bool((lens <= 0).any()):
        require(not bool(out[lens <= 0].float().abs().max()), "length 0 must give 0")
    return out, err


def decode_rows_invariant(torch, label, inp, out, phase="kernels"):
    """At kv_splits 1 the rows of ``out`` keep their bits at B in {1, 3,
    13} (PAGED_ROWS), and a launch repeats bitwise."""
    from repro_torch.kernels.decode_attention import decode_attention

    q, k, v, lens = inp
    for rows in PAGED_ROWS:
        sel = torch.tensor(rows, device=DEV)
        part = decode_attention(q[sel].contiguous(), k[sel].contiguous(),
                                v[sel].contiguous(), lens[sel].contiguous())
        require(torch.equal(part, out[sel]),
                f"decode_attention rows change at B={len(rows)} ({label})")
    require(torch.equal(out, decode_attention(q, k, v, lens)),
            f"decode_attention is not repeatable ({label})")
    log(f"[{phase}] decode_attention {label} kv_splits=1: rows bitwise identical "
        f"for B in {{1,3,8,13}}; repeatable")


def check_decode_attention(torch, cfg, results) -> None:
    """Kernel 5, the gathered lane's W == 1 attention, at each of
    ``decode_shapes`` and at D = 64, against its plain version; at kv_splits
    1 a row's bits identical for B in {1, 3, 8, 13} and across launches at
    every shape, and at a 2048- and a 32896-slot view; the combine rounding
    with f32 operands; a row's bits at places 5/17/199 of a batch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    worst = 0.0
    commit_out = {}
    for label, inp in decode_shapes(torch, cfg).items():
        for splits, cd in DECODE_CASES:
            out, err = decode_case(torch, label, inp, splits, cd)
            worst = max(worst, err)
        commit_out[label] = out  # kv_splits 1, f32 combine
        decode_rows_invariant(torch, label, inp, out)
        del inp
    require(torch.equal(commit_out["serve"], commit_out["default reach"]),
            "decode_attention rows change with the view length S")
    log("[kernels] decode_attention serve rows bitwise identical in a 2048- and a "
        "32896-slot view at kv_splits=1")
    del commit_out
    # D = 64, G = 4, lengths 0 and S included, uneven chunks (kv_splits 3)
    q, k, v, lens = decode_inputs(torch, 8, 2048, 16, 4, 64, seed=4,
                                  min_len=1, max_len=2048)
    lens[0], lens[1] = 0, 2048
    for splits in (1, 3, 4):
        for cd in ("float32", "bfloat16"):
            worst = max(worst, decode_case(torch, "D=64", (q, k, v, lens), splits, cd)[1])
    results["decode_attention"]["max_abs_err"] = worst
    # f32 operands: the combine rounding is the kernel's only bf16 step, so
    # its bf16-combine output must sit far closer to the plain bf16
    # version than the plain bf16 and f32 versions sit apart (means per
    # row: a reordered f32 sum may flip the odd rounding of d or o)
    q, k, v, lens = decode_inputs(torch, 8, 2048, cfg.num_heads, cfg.num_kv_heads,
                                  cfg.hd, seed=5, min_len=600, max_len=2048,
                                  dt=torch.float32)
    out = decode_attention(q, k, v, lens, kv_splits=4, combine_dtype="bfloat16")
    want = ref.decode_attention(q, k, v, lens, 4, "bfloat16")
    want32 = ref.decode_attention(q, k, v, lens, 4, "float32")
    err_row = (out - want).abs().mean(dim=(1, 2))
    gap_row = (want - want32).abs().mean(dim=(1, 2))
    ratio = float((err_row / gap_row.clamp_min(1e-30)).max())
    log(f"[kernels] decode_attention f32 operands, kv_splits=4: plain bf16 and "
        f"f32 combine {float(gap_row.min()):.3e}..{float(gap_row.max()):.3e} "
        f"apart per row (mean |diff|); kernel-to-plain mean error at most "
        f"{ratio:.3f} of that gap (limit 0.25)")
    require(bool((gap_row > 0).all()) and ratio <= 0.25,
            "decode_attention does not round d and o through the combine dtype")
    one = decode_attention(q, k, v, lens, kv_splits=1, combine_dtype="bfloat16")
    require(not torch.equal(one, out), "decode_attention: kv_splits 1 and 4 agree")
    # the commit-grade single pass is batch-invariant
    q, k, v, lens = decode_inputs(torch, 200, 512, cfg.num_heads, cfg.num_kv_heads,
                                  cfg.hd, seed=6, min_len=1, max_len=513)
    rows_invariant(torch, lambda *t: decode_attention(*t, kv_splits=1),
                   (q, k, v, lens), "decode_attention kv_splits=1")


#: the fused norm's rows at the model's width: a decode batch, a verify
#: pass's 256 rows, and a large batch whose bytes bound it
RMSNORM_ROWS = (32, 256, 16384)


def check_rmsnorm(torch, cfg, results) -> None:
    """Kernel 6: the fused norm through its entry point, at the model's
    width in bf16 for each of RMSNORM_ROWS, at D = 300 in f32 (the JAX
    test's odd width) and at D = 16384 (a row over a cluster of CTAs), each
    with a scale in x's dtype and in the other one, with and without a
    residual; a row's bits across batches; and one launch a call (by kernel
    name in a profiler trace)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import rmsnorm

    g = torch.Generator(device=DEV).manual_seed(7)
    worst = 0.0
    cases = [(M, cfg.d_model, torch.bfloat16, 7) for M in RMSNORM_ROWS]
    # rows too wide for one CTA: a 2-CTA (bf16) and a 4-CTA (f32) cluster
    wide = [(64, 16384, torch.bfloat16, 7), (16, 16384, torch.float32, 23)]
    for M, D, dt, mant in cases + [(32, 300, torch.float32, 23)] + wide:
        x = torch.randn((M, D), generator=g, device=DEV).to(dt)
        r = torch.randn((M, D), generator=g, device=DEV).to(dt)
        sc32 = 1 + 0.1 * torch.randn((D,), generator=g, device=DEV)
        for sc in (sc32.to(dt), sc32.to(torch.float32 if dt == torch.bfloat16
                                        else torch.bfloat16)):
            for res in (None, r):
                out = ops.rmsnorm(x, sc, res, eps=cfg.norm_eps)
                want = ref.rmsnorm(x, sc, cfg.norm_eps, res)
                sync(torch)
                err = float((out.float() - want.float()).abs().max())
                ulp = ulp_of(float(want.float().abs().max()), mant)
                tol = RMSNORM_ULPS[str(dt)[6:]]
                log(f"[kernels] rmsnorm ({M},{D}) {str(dt)[6:]}, scale "
                    f"{str(sc.dtype)[6:]}, {'with' if res is not None else 'without'} "
                    f"residual: max_abs_err {err:.3e} = {err / ulp:.2f} ulps (tol "
                    f"{tol}); {int((out != want).sum())} of {out.numel()} outputs differ")
                require(err <= tol * ulp, "rmsnorm disagrees with its plain version")
                worst = max(worst, err)
        del x, r
    results["rmsnorm"]["max_abs_err"] = worst
    x = torch.randn((200, cfg.d_model), generator=g, device=DEV).to(torch.bfloat16)
    r = torch.randn((200, cfg.d_model), generator=g, device=DEV).to(torch.bfloat16)
    sc = torch.randn((1, cfg.d_model), generator=g, device=DEV).to(torch.bfloat16)
    rows_invariant(torch, lambda x, r, sc: rmsnorm(x, sc[0], r, eps=cfg.norm_eps),
                   (x, r, sc.expand(200, -1)), "rmsnorm with residual")
    # the timed call (bf16 x and scale) is one launch of the norm kernel;
    # three calls a trace (a trace of one call now and then holds nothing)
    for scale in (sc[0], sc[0].float()):
        names = trace_kernels(torch, lambda: rmsnorm(x, scale, eps=cfg.norm_eps), calls=3)
        log(f"[kernels] rmsnorm, {str(scale.dtype)[6:]} scale: 3 calls launched {names}")
        require(len(names) == 1 and "rmsnorm_kernel" in next(iter(names))
                and next(iter(names.values())) == 3,
                "rmsnorm: a call is not one launch of the norm kernel")


# ---------------------------------------------------------------------------
# phases 3 and 4: serve, determinism
# ---------------------------------------------------------------------------


def reset_launches():
    from repro_torch.kernels import (
        decode_attention, gemm_batch_invariant, gemm_splitk, paged_attention, rmsnorm,
    )

    fns = {
        "gemm_batch_invariant": gemm_batch_invariant.gemm_batch_invariant,
        "gemm_splitk": gemm_splitk.gemm_splitk,
        "paged_attention": paged_attention.paged_attention,
        "paged_attention_fast": paged_attention.paged_attention_fast,
        "decode_attention": decode_attention.decode_attention,
        "rmsnorm": rmsnorm.rmsnorm,
    }
    for fn in fns.values():
        fn.launches = 0
    return fns


def launch_counts(fns):
    return {k: f.launches for k, f in fns.items()}


def record_launches(results, run, counts, main_path=True) -> None:
    """Adds a run's measured launch counts to the kernels line: to
    ``launches_by_mode[run]``, and, for a run of the main path (not one made
    to compare a kernel with its plain version), to ``launches``."""
    for k, c in counts.items():
        by_mode = results[k]["launches_by_mode"]
        by_mode[run] = by_mode.get(run, 0) + c
        if main_path:
            results[k]["launches"] += c


def phase_serve(torch, cfg, params, capacity, results, summary) -> None:
    from repro_torch.core.determinism import Mode
    from repro_torch.launch.serve import build_requests, serve
    from repro_torch.serving.engine import Engine

    n_req, max_new = 8, 16
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; capacity {capacity}; {n_req} requests "
        f"x {max_new} new tokens, window 8, group 4, max_batch 8")
    # a short warm-up run per lane first: the first run in a process pays
    # lazy CUDA module loading and allocator growth, which the timed runs
    # should not
    for paged in LANES.values():
        serve(Engine(cfg, params, mode=Mode.LLM42, capacity=capacity,
                     paged_attention=paged),
              build_requests(cfg, 2, det_ratio=1.0, max_out=8, seed=1))
    for lane, paged in LANES.items():
        for mode in (Mode.LLM42, Mode.BATCH_INVARIANT, Mode.NONDET):
            run = f"{lane}/{mode.value}"
            gc.collect()  # a guard: a dropped engine frees its pool at once
            eng = Engine(cfg, params, mode=mode, capacity=capacity,
                         paged_attention=paged)
            reqs = build_requests(cfg, n_req, det_ratio=0.5, max_out=max_new, seed=0)
            sync(torch)
            torch.cuda.reset_peak_memory_stats()
            fns = reset_launches()
            res = serve(eng, reqs)
            counts = {name: fn.launches for name, fn in fns.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            progs = check_programs(eng, run)
            want = expected_launches(cfg, eng, paged)
            log(f"[serve] {run}: kernel launches {counts}; from the engine's "
                f"passes {want}")
            require(counts == want, f"{run}: launches do not match the passes run")
            for name, n in counts.items():
                on_path = name in PATH_KERNELS[lane, mode.value]
                require((n > 0) == on_path, f"{run}: {name} launched {n} times")
            for name, n in counts.items():
                results[name]["launches_by_mode"][run] = n
                results[name]["launches"] += n
            require(res["finished"] == n_req, f"{run}: {res['finished']} finished")
            for r in res["done"]:
                require(len(r.committed) == max_new, f"{run}: rid {r.rid} short")
                require(all(0 <= t < cfg.vocab_size for t in r.committed),
                        f"{run}: token out of range")
            tps = res["committed"] / res["device_s"]
            summary[run] = dict(
                committed=res["committed"], rollbacks=res["rollbacks"],
                recomputed=res["recomputed"], iterations=res["iterations"],
                device_s=res["device_s"], committed_tok_per_s=tps,
                peak_mem_gib=peak, launches=counts, programs=progs)
            log(f"[serve] {run}: {res['committed']} tokens committed in "
                f"{res['iterations']} iterations, rollbacks {res['rollbacks']}, "
                f"recomputed {res['recomputed']}, device time {res['device_s']} s "
                f"-> {tps} committed tok/s; peak device memory {peak:.3f} GiB; "
                f"{progs['programs']} programs, each captured once after one "
                f"warm-up run, {progs['replays']} replays, capture "
                f"{progs['capture_s']:.3f} s")
            del eng
    run_rmsnorm_entry_point(torch, cfg, params, results)
    for name, r in results.items():
        require(r["launches"] > 0, f"{name} was never launched on its path")


def run_rmsnorm_entry_point(torch, cfg, params, results) -> None:
    """rmsnorm's own path, as in the JAX package: its entry point
    ``kernels.ops.rmsnorm``, here over a decode pass's 8 and a verify
    pass's 32 rows of hidden states with a residual, scaled by the served
    weights' final-norm scale.  Counters reset just before, read just
    after."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=DEV).manual_seed(10)
    fns = reset_launches()
    for M in (8, 32):
        x = torch.randn((M, cfg.d_model), generator=g, device=DEV).to(torch.bfloat16)
        r = torch.randn((M, cfg.d_model), generator=g, device=DEV).to(torch.bfloat16)
        out = ops.rmsnorm(x, params["final_norm"], r, eps=cfg.norm_eps)
        require(out.shape == x.shape and bool(torch.isfinite(out.float()).all()),
                "rmsnorm entry point: bad shape or non-finite output")
    counts = {name: fn.launches for name, fn in fns.items()}
    want = {name: 2 if name == "rmsnorm" else 0 for name in counts}
    log(f"[serve] ops/rmsnorm (the entry point, 8 and 32 rows): kernel "
        f"launches {counts}")
    require(counts == want, "rmsnorm entry point: launches do not match its calls")
    for name, n in counts.items():
        results[name]["launches_by_mode"]["ops/rmsnorm"] = n
        results[name]["launches"] += n


#: the kernels each (lane, mode) serve run must reach at the serve phase's
#: capacity.  Paged lane: its 128-block tables divide every kv_splits of
#: FAST_PATH_POLICY, so only BATCH_INVARIANT decode takes the commit
#: attention kernel.  Gathered lane: every W == 1 pass takes the dense
#: decode kernel (kv_splits 1 under the commit schedule).  Prefill and
#: verify run the commit GEMM in every mode.  rmsnorm is on no serve path
#: (``run_rmsnorm_entry_point`` drives it).
_FAST = ("gemm_batch_invariant", "gemm_splitk")
PATH_KERNELS = {
    ("paged", "llm42"): _FAST + ("paged_attention_fast",),
    ("paged", "batch_invariant"): ("gemm_batch_invariant", "paged_attention"),
    ("paged", "nondet"): _FAST + ("paged_attention_fast",),
    ("gathered", "llm42"): _FAST + ("decode_attention",),
    ("gathered", "batch_invariant"): ("gemm_batch_invariant", "decode_attention"),
    ("gathered", "nondet"): _FAST + ("decode_attention",),
}


def forward_gemms(cfg):
    """GEMM launches of one forward: ``(in the schedule's GEMM, in the
    commit GEMM whatever the schedule)``.  Per attention layer 4 projections
    (a mamba layer's 4 too: in, x, dt and out) plus the dense FFN's 3 or a
    MoE layer's router in the schedule's GEMM (a ``first_k_dense`` head
    layer is dense); per rwkv layer 10 (time mixing: r, k, v, g, the decay
    LoRA's two, the output; channel mixing: 3); plus the unembedding; a MoE
    layer's 3 contractions per expert (every expert, on its capacity
    bucket) in the commit GEMM with one chunk; an encoder-decoder decoder
    layer adds its cross-attention's wq and wo."""
    sched, experts = 1, 0
    if cfg.family == "encdec":
        sched += 2 * cfg.num_layers
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "rwkv":
            sched += 10
        elif cfg.ffn_kind(i) == "moe":
            sched += 4 + 1
            experts += 3 * cfg.num_experts
        else:
            sched += 4 + 3
    return sched, experts


def splitk_schedule(s) -> bool:
    """Whether ``kernels.ops.matmul`` sends a schedule's GEMMs to the split-K
    kernel: every schedule but the one-split ones without TP chunks or with
    pinned ones (the commit GEMM's)."""
    return not (s.splits <= 1 and (s.tp_shards <= 1 or s.tp_pinned))


def encoder_gemms(cfg):
    """Commit-GEMM launches of one encoder build (``build_cross_cache``):
    per encoder layer 4 projections and the FFN's 3, per decoder layer the
    cross-attention's wk and wv."""
    return 7 * cfg.num_encoder_layers + 2 * cfg.num_layers


def expected_launches(cfg, eng, paged):
    """Kernel launches implied by the passes the engine reports: every
    forward runs ``forward_gemms``' launches, and every single-token forward
    (a decode pass, or a one-token prefill chunk) of a full-attention config
    one attention launch per layer: on the paged lane the fast paged kernel
    where its kv_splits divides the table reach, else the commit one; on
    the gathered lane the dense decode kernel.  A sliding config's ring
    passes and an rwkv or mamba layer launch no attention kernel.  A ``prefill`` event covers
    ``padded`` over the engine's ring-pass cap passes (one, but for a
    sliding prompt longer than the cap).  An encoder-decoder config's
    single-token forwards also run the dense decode kernel once a layer
    (cross-attention, on both lanes), and each encoder build
    (``eng.num_cross_builds``) ``encoder_gemms`` commit GEMMs."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE, Schedule

    gemms, experts = forward_gemms(cfg)
    n_attn = 0 if cfg.attn_kind == "sliding" else sum(
        cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    n_cross = cfg.num_layers if cfg.family == "encdec" else 0
    nblk = eng.pool.layout.blocks_per_table
    commit = VERIFY_SCHEDULE  # every mode's prefill (INVARIANT_SCHEDULE is the same)
    want = dict.fromkeys(KERNELS, 0)
    if n_cross:
        want["gemm_batch_invariant"] += eng.num_cross_builds * encoder_gemms(cfg)
    for ev in engine_events(eng):
        passes = 1
        if ev["kind"] == "prefill":
            passes = ev["padded"] // eng._ring_pass_cap(ev["padded"])
        if ev["kind"] in ("prefill", "prefill_chunk", "verify"):
            want["gemm_batch_invariant"] += (gemms + experts) * passes
            if ev["kind"] == "verify" or ev["padded"] > 1:
                continue
            s = commit
        elif ev["kind"] == "decode":
            s = Schedule(*ev["schedule"])
            want["gemm_splitk" if splitk_schedule(s) else "gemm_batch_invariant"] += gemms
            want["gemm_batch_invariant"] += experts
        else:
            continue
        want["decode_attention"] += n_cross
        if not n_attn:
            continue
        if not paged:
            want["decode_attention"] += n_attn
        else:
            fast = s.kv_splits > 1 and nblk % s.kv_splits == 0
            want["paged_attention_fast" if fast else "paged_attention"] += n_attn
    return want


# ---------------------------------------------------------------------------
# programs: one captured program per shape class (serving/programs.py)
# ---------------------------------------------------------------------------


def _norm_key(key):
    """A program key with its schedule as a plain tuple."""
    return tuple(tuple(x) if isinstance(x, tuple) else x for x in key)


def program_keys(eng):
    """The program keys an engine's events name, as the reference keys its
    ``_fns`` (``serving/programs.py``): an iteration whose sub-passes carry
    ``fused`` ran ``("fused", C, B, schedule, n_groups)``, every other pass
    its own lane's program (a ``prefill`` event with ``cached`` is a tail
    run of ``prefill_chunk`` passes), plus ``("cross", Se)`` when an encoder
    ran."""
    from repro_torch.core.determinism import Schedule
    from repro_torch.serving.engine import _bucket

    chunk = "prefill_chunk_rec" if eng.has_recurrent_state else "prefill_chunk"
    keys = set()
    if eng.num_cross_builds:
        keys.add(("cross", eng.cfg.encoder_seq_len))

    def single(ev):
        if ev["kind"] == "prefill" and "cached" in ev:
            keys.add((chunk, eng._ring_pass_cap(_bucket(max(ev["tokens"], 1)))))
        elif ev["kind"] == "prefill":
            keys.add(("prefill", ev["padded"] - eng.cfg.num_prefix_embeds))
        elif ev["kind"] == "prefill_chunk":
            keys.add((chunk, ev["padded"]))
        elif ev["kind"] == "decode":
            keys.add(("decode", ev["batch"], Schedule(*ev["schedule"])))
        elif ev["kind"] == "verify":
            keys.add(("verify", eng.group, ev["window"]))

    for ev in eng.events:
        if ev["kind"] != "overlap":
            single(ev)
            continue
        parts = [ev[k] for k in ("prefill", "decode", "verify") if k in ev]
        parts += ev.get("verifies", [])
        if not any(p.get("fused") for p in parts):
            for p in parts:
                single(p)
            continue
        B = ev["decode"]["batch"] if "decode" in ev else 0
        keys.add(("fused", ev["prefill"]["padded"] if "prefill" in ev else None, B,
                  eng._decode_schedule(B), sum(p["kind"] == "verify" for p in parts)))
    return keys


def check_programs(eng, run):
    """On the card: the engine holds exactly the programs its events name,
    each captured once after one warm-up run of its body (its key's first
    step) and replayed after that, so no body ran outside a capture once
    its key was captured.  Returns the counts."""
    got = {_norm_key(k) for k in eng._programs}
    want = {_norm_key(k) for k in program_keys(eng)}
    require(got == want, f"{run}: programs {sorted(map(str, got))} are not the keys "
            f"the events name {sorted(map(str, want))}")
    for key, p in eng._programs.items():
        require(p.captures == 1 and p.runs == 1,
                f"{run}: program {key} captured {p.captures} times, its body run "
                f"{p.runs} times outside a capture")
    progs = list(eng._programs.values())
    return dict(programs=len(progs), captures=sum(p.captures for p in progs),
                replays=sum(p.replays for p in progs),
                capture_s=sum(p.capture_s for p in progs))


#: the programs phase's depth: the serve phase's first 16 of llama3-8b's 32
#: layers at full width (its weights, as views)
PROGRAMS_DEPTH = 16
#: its engines: chunked prefill and two verify windows in flight, so that
#: the runs take every key kind the LLM42 engine has (exclusive prefill of
#: the shorter prompts, prefill chunks, decode, verify, fused iterations)
PROGRAMS_CHUNK = 64


def programs_traffic(cfg, seed):
    """8 requests of 40 to 180 prompt tokens and 16 new tokens, half
    deterministic, odd rids seeded at temperature 0.8 with top-k 50."""
    import numpy as np

    from repro_torch.serving.request import Request, SamplingParams

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(8):
        kw = dict(seed=100 * seed + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=50)
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(40, 181))).tolist(),
            sampling=SamplingParams(max_new_tokens=16, is_deterministic=i % 4 < 2, **kw)))
    return reqs


def phase_programs(torch, cfg, params, results, summary) -> None:
    """Every engine step as a replay of a program captured once per shape
    class, against the same run under ``programs.eager()`` (each body
    called directly), at PROGRAMS_DEPTH layers of Llama-3-8B's full width,
    on both lanes in all three modes: committed streams bitwise equal (the
    same kernels at the same shapes, NONDET included), launches per kernel
    equal and equal to the passes, the programs exactly the keys the
    events name, each captured once; then an engine that serves traffic A
    and then traffic B commits for B what the same engine commits under
    ``eager()`` (no stale input or output buffer) and a fresh engine's
    deterministic streams of B (its non-deterministic ones follow the
    batches, which an engine's history may change: printed).  Prints host
    wall, captures, capture seconds and peak device memory of both."""
    import contextlib

    from repro_torch.core.determinism import Mode
    from repro_torch.serving import programs
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import OverlapPolicy

    full = cfg.num_layers
    cfg, params = cut_layers(cfg, params, PROGRAMS_DEPTH)
    log(f"[programs] {cfg.name}: {cfg.num_layers} of {full} layers (the serve "
        f"phase's weights), capacity {CAPACITY}, prefill chunk {PROGRAMS_CHUNK}, "
        f"spec_depth 2, overlap; 8 requests x 16 new tokens")

    def engine(mode, paged):
        return Engine(cfg, params, mode=mode, capacity=CAPACITY, paged_attention=paged,
                      prefill_chunk=PROGRAMS_CHUNK, spec_depth=2, scheduler=OverlapPolicy())

    def run(eng, reqs):
        gc.collect()
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        fns = reset_launches()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        sync(torch)
        wall = time.perf_counter() - t0
        return ({r.rid: list(r.committed) for r in done}, launch_counts(fns), wall,
                torch.cuda.max_memory_allocated() / 2 ** 30)

    seen = {}
    for lane, paged in LANES.items():
        for mode in (Mode.LLM42, Mode.BATCH_INVARIANT, Mode.NONDET):
            name = f"programs/{lane}/{mode.value}"
            eng = engine(mode, paged)
            got, counts, wall, peak = run(eng, programs_traffic(cfg, 0))
            progs = check_programs(eng, name)
            want = expected_launches(cfg, eng, paged)
            del eng
            with programs.eager():
                eng = engine(mode, paged)
                ref, ref_counts, ref_wall, ref_peak = run(eng, programs_traffic(cfg, 0))
                direct = sum(p.runs for p in eng._programs.values())
                del eng
            require(got == ref, f"{name}: streams differ from eager()'s")
            require(counts == ref_counts == want,
                    f"{name}: launches {counts}, under eager() {ref_counts}, passes {want}")
            record_launches(results, name, counts)
            seen[f"{lane}/{mode.value}"] = dict(
                **progs, wall_s=wall, eager_wall_s=ref_wall, peak_gib=peak,
                eager_peak_gib=ref_peak, eager_body_calls=direct)
            reserved = torch.cuda.memory_reserved() / 2 ** 30
            seen[f"{lane}/{mode.value}"]["reserved_gib"] = reserved
            log(f"[programs] {lane}/{mode.value}: streams bitwise eager()'s "
                f"({sum(map(len, got.values()))} tokens), launches equal {counts}; "
                f"{progs['programs']} programs ({progs['captures']} captures in "
                f"{progs['capture_s']:.3f} s, {progs['replays']} replays) vs "
                f"{direct} direct body calls; host wall {wall:.3f} s vs {ref_wall:.3f} s "
                f"eager; peak memory {peak:.3f} GiB vs {ref_peak:.3f} GiB eager; "
                f"{reserved:.3f} GiB reserved after both")
    for lane, paged in LANES.items():
        b_after_a = {}
        for ctx in (contextlib.nullcontext, programs.eager):
            with ctx():
                eng = engine(Mode.LLM42, paged)
                run(eng, programs_traffic(cfg, 1))
                before = {k: p.replays + p.runs for k, p in eng._programs.items()}
                b_after_a[ctx], _, _, _ = run(eng, programs_traffic(cfg, 2))
                reused = sum(eng._programs[k].replays + eng._programs[k].runs - n
                             for k, n in before.items())
                del eng
            require(reused > 0, f"{lane}: traffic B called none of A's programs")
        fresh, _, _, _ = run(engine(Mode.LLM42, paged), programs_traffic(cfg, 2))
        det = [r.rid for r in programs_traffic(cfg, 2) if r.sampling.is_deterministic]
        got = b_after_a[contextlib.nullcontext]
        require(got == b_after_a[programs.eager], f"{lane}: traffic B after A differs "
                "between programs and eager() (a stale buffer)")
        require(all(got[r] == fresh[r] for r in det), f"{lane}: deterministic streams "
                "of traffic B after A differ from a fresh engine's")
        same = sorted(r for r in got if got[r] == fresh[r])
        seen[f"{lane}/a_then_b"] = dict(calls_of_a=reused, equal_to_fresh=same)
        log(f"[programs] {lane} llm42: traffic B after traffic A on one engine ({reused} "
            f"calls of programs A made) commits the streams it commits under "
            f"eager(), and a fresh engine's deterministic streams of B (rids {det}); "
            f"rids equal to the fresh engine's, all streams: {same}")
    summary["programs"] = seen


def phase_reference(torch, cfg, params) -> None:
    """Logits of a 2-layer cut of the served weights, on the card (kernels)
    against the CPU (plain versions): a 16-token prefill and one decode
    token after it, on each lane (the decode token runs the paged commit
    kernel on the paged lane and the dense decode kernel on the gathered
    one)."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE
    from repro_torch.models.layers import PagedView
    from repro_torch.models.transformer import forward

    small = dataclasses.replace(cfg, num_layers=2)

    def cut(tree, dev):
        if isinstance(tree, dict):
            return {k: cut(v, dev) for k, v in tree.items()}
        return tree[:2].to(dev) if tree.dim() >= 2 and tree.shape[0] == cfg.num_layers \
            else tree.to(dev)

    def run(dev, paged):
        p = {k: (cut(v, dev) if k == "blocks" else v.to(dev)) for k, v in params.items()}
        kv = (2, 4, 16) if paged else (2, 1, 32)  # (layers, blocks, 16) or (layers, B, C)
        dt = p["embed"].dtype
        pool = {"blocks": {"0": {
            "k": torch.zeros(kv + (cfg.num_kv_heads, cfg.hd), dtype=dt, device=dev),
            "v": torch.zeros(kv + (cfg.num_kv_heads, cfg.hd), dtype=dt, device=dev),
            "pos": torch.full(kv, -1, dtype=torch.int32, device=dev)}}}
        where = dict(tables=torch.tensor([[0, 1]], dtype=torch.int32, device=dev),
                     paged=PagedView(16, 2, 3)) if paged else {}
        toks = torch.arange(1, 18, dtype=torch.int32, device=dev)[None] * 997 % cfg.vocab_size
        logits, _, _ = forward(p, small, toks[:, :16], cache=pool,
                               start_pos=torch.zeros(1, dtype=torch.int32, device=dev),
                               schedule=VERIFY_SCHEDULE, **where)
        step, _, _ = forward(p, small, toks[:, 16:], cache=pool,
                             start_pos=torch.full((1,), 16, dtype=torch.int32, device=dev),
                             schedule=VERIFY_SCHEDULE, **where)
        return torch.cat([logits, step], dim=1).float().cpu()

    for lane, paged in LANES.items():
        got, want = run(DEV, paged), run("cpu", paged)
        require(got.shape == (1, 17, cfg.vocab_size) and bool(torch.isfinite(got).all()),
                "reference forward: bad shape or non-finite logits")
        diff = (got - want).abs()
        err, mean_err = float(diff.max()), float(diff.mean())
        # the logits are bf16: both sides' f32 sums differ in order only, so
        # a logit may round one bf16 ulp apart (one ulp of max|ref| measured)
        ulp = ulp_of(float(want.abs().max()), 7)
        tol, mean_tol = 2 * ulp, REF_MEAN_ULPS * ulp
        top2 = want.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol  # no error within tol flips these
        agree = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
        step_err = float(diff[0, 16].max())
        log(f"[serve] reference ({lane} lane): 2-layer cut, 16-token prompt + 1 "
            f"decode token, card vs CPU plain versions: logits max_abs_err "
            f"{err:.3e} (tol {tol:.3e} = 2 bf16 ulps of max|ref|), decode token "
            f"{step_err:.3e}, mean_abs_err {mean_err:.3e} (tol {mean_tol:.3e}), "
            f"{float((diff == 0).float().mean()):.4f} of logits bitwise equal; "
            f"argmax equal at all {int(clear.sum())}/17 positions whose top-2 "
            f"margin exceeds 2 tol: {agree}")
        require(err <= tol and mean_err <= mean_tol,
                f"{lane}: card logits disagree with the CPU reference")
        # 6 of the 16 prefill positions are clear of near-ties with the
        # seed-0 weights
        require(agree and int(clear.sum()) >= 4,
                f"{lane}: card argmax disagrees with the CPU reference")


#: the determinism phase's depth: the serve phase's first 16 of llama3-8b's
#: 32 layers at full width (its weights, as views), since the distribution
#: phase came: the default run did not fit 1200 s on a slow host at 32
DETERMINISM_DEPTH = 16


def cut_layers(cfg, params, depth):
    """``cfg`` at ``depth`` layers and its first ``depth`` layers' weights,
    views of ``params`` (a stacked block leaf's leading axis is the layer;
    a config of block period 1 without head layers)."""
    assert cfg.block_period() == 1 and not cfg.first_k_dense

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:depth]

    return (dataclasses.replace(cfg, num_layers=depth),
            {k: (cut(v) if k == "blocks" else v) for k, v in params.items()})


def phase_determinism(torch, cfg, params, results, summary) -> None:
    """The divergence demo's experiment (examples/dvr_divergence_demo.py)
    on each lane, at DETERMINISM_DEPTH layers, with three tracked requests
    (one greedy, two seeded at temperature 0.8 with top-k 0 and 50) beside
    0, 3 and 6 greedy neighbours; then the paged LLM42 runs at TP widths 2
    and 4 (``determinism_tp``)."""
    from repro_torch.core.determinism import Mode, ReductionPolicy
    from repro_torch.core.spans import consistent_spans
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, SamplingParams

    full = cfg.num_layers
    cfg, params = cut_layers(cfg, params, DETERMINISM_DEPTH)
    log(f"[determinism] {cfg.name}: {cfg.num_layers} of {full} layers (the serve "
        f"phase's weights), d_model {cfg.d_model}")

    policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                             combine_dtype="bfloat16")
    max_new = 32
    tracked = {0: dict(seed=7), 1: dict(seed=8, temperature=0.8),
               2: dict(seed=9, temperature=0.8, top_k=50)}

    def run(lane, mode, n_neighbours, tp=1, engine=None):
        eng = Engine(cfg, params, mode=mode, policy=policy, window=6, group=2,
                     max_batch=12, capacity=256, paged_attention=LANES[lane], tp=tp)
        for rid, kw in tracked.items():
            eng.submit(Request(rid=rid, prompt=[rid * 11 + k for k in range(1, 11)],
                               sampling=SamplingParams(
                                   max_new_tokens=max_new,
                                   is_deterministic=mode != Mode.NONDET, **kw)))
        for i in range(n_neighbours):
            eng.submit(Request(rid=10 + i, prompt=[3 * i + k for k in range(6)],
                               sampling=SamplingParams(max_new_tokens=max_new)))
        if engine is not None:
            engine.append(eng)
        done = {r.rid: r for r in eng.run()}
        return {rid: done[rid] for rid in tracked}

    summary["determinism"] = {}
    streams = {}
    for lane in LANES:
        seen = {}
        alone = run(lane, Mode.NONDET, 0)
        for n in (3, 6):
            other = run(lane, Mode.NONDET, n)
            s = consistent_spans(alone[0].committed, other[0].committed)
            diverged = [rid for rid in tracked if alone[rid].committed != other[rid].committed]
            seen[f"nondet_{n}"] = {"diverged": diverged, "first_span_rid0": s.first_span}
            log(f"[determinism] {lane} NONDET vs {n} neighbours: rid 0 first "
                f"consistent span {s.first_span}/{s.total}; diverged rids {diverged}")
        # both deterministic modes must commit the same streams whatever the
        # decode batch: LLM42 by verification, BATCH_INVARIANT by running
        # every pass under the commit schedule
        for mode in (Mode.LLM42, Mode.BATCH_INVARIANT):
            a = run(lane, mode, 0)
            streams[lane, mode] = {rid: r.committed for rid, r in a.items()}
            for n in (3, 6):
                b = run(lane, mode, n)
                same = all(a[rid].committed == b[rid].committed for rid in tracked)
                rb = sum(r.num_rollbacks for r in b.values())
                seen[f"{mode.value}_{n}"] = {"identical": same, "rollbacks": rb}
                log(f"[determinism] {lane} {mode.value} vs {n} neighbours: "
                    f"identical={same} (greedy + 2 seeded) rollbacks={rb} "
                    f"recomputed={sum(r.num_recomputed_tokens for r in b.values())}")
                require(same, f"{lane} {mode.value} streams changed beside {n} neighbours")
        summary["determinism"][lane] = seen
    same = streams["gathered", Mode.LLM42] == streams["paged", Mode.LLM42]
    log(f"[determinism] LLM42 streams of the gathered lane equal the paged "
        f"lane's: {same}")
    require(same, "LLM42 streams differ between the gathered and paged lanes")
    determinism_tp(torch, cfg, run, streams["paged", Mode.LLM42], results, summary)


#: the fast path's logical TP widths the determinism phase serves at
DETERMINISM_TP = (2, 4)


def determinism_tp(torch, cfg, run, base, results, summary) -> None:
    """Paged LLM42 with the fast path at TP widths 2 and 4 (decode GEMMs
    fold tp K chunks un-pinned, in the split-K kernel): the tracked greedy
    and seeded requests, alone and beside 3 neighbours, must commit the tp 1
    streams ``base``; each run's launches equal its passes.  NONDET at tp 1
    against tp 4 is printed."""
    from repro_torch.core.determinism import Mode

    seen = {}
    for tp in DETERMINISM_TP:
        for n in (0, 3):
            engines = []
            fns = reset_launches()
            got = run("paged", Mode.LLM42, n, tp=tp, engine=engines)
            sync(torch)
            counts = launch_counts(fns)
            want = expected_launches(cfg, engines[0], True)
            require(counts == want, f"determinism tp={tp} beside {n}: launches {counts} "
                    f"do not match the passes {want}")
            name = f"determinism/paged/llm42/tp{tp}/{n}"
            record_launches(results, name, counts)
            same = {rid: r.committed for rid, r in got.items()} == base
            rb = sum(r.num_rollbacks for r in got.values())
            seen[f"tp{tp}_{n}"] = {"identical": same, "rollbacks": rb}
            log(f"[determinism] paged llm42 at tp={tp} beside {n} neighbours: streams "
                f"equal tp 1's={same} (greedy + 2 seeded) rollbacks={rb}; launches "
                f"{counts} (= the passes)")
            require(same, f"paged LLM42 streams at tp={tp} beside {n} differ from tp 1's")
            del engines
    nd = {tp: run("paged", Mode.NONDET, 0, tp=tp) for tp in (1, 4)}
    diverged = [rid for rid in nd[1] if nd[1][rid].committed != nd[4][rid].committed]
    seen["nondet_tp1_vs_tp4"] = {"diverged": diverged}
    log(f"[determinism] paged NONDET alone at tp 1 vs tp 4: diverged rids {diverged}")
    summary["determinism"]["tp"] = seen


def profile_window(torch, cfg, params, capacity, warm, active):
    """A paged LLM42 engine at ``capacity`` serves the serve phase's 8
    requests once (on programs, every key it meets is captured then), then
    8 more (another seed: no prefix in common); ``torch.profiler`` traces
    ``active`` of the second traffic's iterations after ``warm`` unprofiled
    ones.  Returns ``(engine, key_averages, window wall, first iteration,
    captures before the window, captures in it)``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.determinism import Mode
    from repro_torch.launch.serve import build_requests
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, mode=Mode.LLM42, capacity=capacity)
    for seed in (0, 1):
        for r in build_requests(cfg, 8, det_ratio=0.5, max_out=16, seed=seed):
            r.rid += 100 * seed
            eng.submit(r)
        if seed == 0:
            eng.run()
            captured = sum(p.captures for p in eng._programs.values())
    for _ in range(warm):
        eng.step()
    first = eng._now + 1
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(active):
            eng.step()
        sync(torch)
        wall = time.perf_counter() - t0
    inside = sum(p.captures for p in eng._programs.values()) - captured
    eng.run()
    return eng, prof.key_averages(), wall, first, captured, inside


#: host runtime calls the profile phase counts in its windows
RUNTIME_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaMemcpyAsync")


def phase_profile(torch, cfg, params, capacity, summary, warm=4, active=4) -> None:
    """Where an LLM42 serve run's time goes, on programs and under
    ``programs.eager()`` in turn (``profile_window``): device time by
    kernel and the device's busy share of the window (sum of kernel times
    over the window's wall time), host wall per iteration, the host's
    ``cudaGraphLaunch`` and kernel-launch calls, and the programs' captures
    and capture seconds; each window's iterations hold decode passes and a
    grouped verify; summing a trace costs about 5 s an iteration, which
    bounds the window.  Then a short run of every lane and mode under a
    trace of the card alone, whose GEMMs must all run the tensor-core
    tile."""
    import contextlib
    import re

    from repro_torch.core.determinism import Mode
    from repro_torch.launch.serve import build_requests
    from repro_torch.serving import programs
    from repro_torch.serving.engine import Engine

    summary["profile"] = {}
    for label, ctx in (("programs", contextlib.nullcontext), ("eager", programs.eager)):
        with ctx():
            eng, averages, wall, first, captured, inside = profile_window(
                torch, cfg, params, capacity, warm, active)
        t0 = time.perf_counter()
        rows = sorted((e for e in averages if e.device_time_total > 0),
                      key=lambda e: e.device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in kernel_events(averages)) / 1e6
        calls = {k: 0 for k in RUNTIME_CALLS}
        for e in averages:
            if e.key in calls:
                calls[e.key] += e.count
        capture_s = sum(p.capture_s for p in eng._programs.values())
        log(f"[profile] {label}: llm42 iterations {first}..{first + active - 1} of the "
            f"second traffic: host wall {wall:.3f} s under the profiler "
            f"({wall / active * 1e3:.1f} ms an iteration), device busy {busy:.3f} s "
            f"({100 * busy / wall:.1f}%); host calls {calls}; programs "
            f"{len(eng._programs)}, {captured} captured by the first traffic in "
            f"{capture_s:.3f} s, {inside} captured inside the window; trace "
            f"summed in {time.perf_counter() - t0:.1f} s")
        # the GEMMs' device time, and proof by kernel name that bf16 GEMMs ran
        # on the tensor-core tile only
        gemm = {}
        for e in averages:
            for part in ("wgmma_partial_kernel", "fmaf_partial_kernel",
                         "tree_combine_kernel", "ordered_fold_kernel"):
                if part in e.key and e.self_device_time_total > 0:
                    ms, n = gemm.get(part, (0.0, 0))
                    gemm[part] = (ms + e.self_device_time_total / 1e3, n + e.count)
        gemm_ms = sum(ms for ms, _ in gemm.values())
        log(f"[profile] {label}: GEMM device time in the window {gemm_ms:.1f} ms of "
            f"{busy * 1e3:.1f} ms busy: " + ", ".join(
                f"{k} {ms:.1f} ms / {n} launches" for k, (ms, n) in gemm.items()))
        require("wgmma_partial_kernel" in gemm and "fmaf_partial_kernel" not in gemm,
                f"{label}: the profiled window's bf16 GEMMs did not run only the "
                "tensor-core tile")
        # the paged attention kernels' device time, by kernel name
        paged = {}
        for e in averages:
            found = re.search(r"paged_(attention|split|merge)_kernel", e.key)
            if found and e.self_device_time_total > 0:
                ms, n = paged.get(found.group(0), (0.0, 0))
                paged[found.group(0)] = (ms + e.self_device_time_total / 1e3, n + e.count)
        paged_ms = sum(ms for ms, _ in paged.values())
        log(f"[profile] {label}: paged attention device time in the window "
            f"{paged_ms:.2f} ms: " + ", ".join(
                f"{k} {ms:.2f} ms / {n} launches ({1e3 * ms / n:.1f} us each)"
                for k, (ms, n) in sorted(paged.items())))
        for e in rows[:20]:
            log(f"[profile] {label}: {e.device_time_total / 1e3:10.1f} ms device "
                f"{e.cpu_time_total / 1e3:10.1f} ms cpu {e.count:7d}x  {e.key[:80]}")
        top_cpu = sorted(averages, key=lambda e: e.self_cpu_time_total, reverse=True)
        for e in top_cpu[:8]:
            log(f"[profile] {label}: host self {e.self_cpu_time_total / 1e3:10.1f} ms "
                f"{e.count:7d}x  {e.key[:80]}")
        events = [ev for ev in engine_events(eng) if first <= ev["iter"] < first + active]
        for kind in ("prefill_chunk", "prefill", "decode", "verify"):
            walls = [ev["wall"] for ev in events if ev["kind"] == kind]
            log(f"[profile] {label}: engine {kind}: {len(walls)} passes, "
                f"{sum(walls):.3f} s wall")
        summary["profile"][label] = {
            "iterations": active, "wall_s": wall, "wall_per_iteration_s": wall / active,
            "device_busy_s": busy, "busy_share": busy / wall, "host_calls": calls,
            "programs": len(eng._programs), "captures_before": captured,
            "captures_inside": inside, "capture_s": capture_s,
            "gemm_device_ms": gemm_ms, "paged_device_ms": paged_ms}
        del eng
    # every lane and mode: a short run's GEMMs by kernel name, all on the
    # tensor-core tile (a prefill and a decode pass each; summing a trace
    # costs seconds an iteration, so the runs are short)
    for lane, paged in LANES.items():
        for mode in (Mode.LLM42, Mode.BATCH_INVARIANT, Mode.NONDET):
            eng = Engine(cfg, params, mode=mode, capacity=capacity, paged_attention=paged)
            for r in build_requests(cfg, 2, det_ratio=0.5, max_out=2, seed=0):
                eng.submit(r)
            ran, names = gemm_tiles_run(torch, eng.run)
            log(f"[profile] {lane}/{mode.value}, 2 requests x 2 new tokens: GEMM "
                f"partial tiles run {sorted(ran)}")
            require(ran == {TENSOR_CORE_TILE},
                    f"{lane}/{mode.value}: bf16 GEMMs did not run only the tensor-core "
                    f"tile; the trace holds {names}")
            del eng


def kernel_events(averages):
    """The device's own rows of a profiler's ``key_averages()`` (kernels,
    copies, fills).  A host op's self device time repeats the time of the
    kernels it launched, so a sum over every row counts that time twice."""
    from torch.autograd import DeviceType

    return [e for e in averages
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]


def engine_events(eng):
    """Engine events with composite iterations unpacked into their parts."""
    for ev in eng.events:
        if ev["kind"] == "overlap":
            for k in ("decode", "verify", "prefill"):
                if k in ev:
                    yield ev[k]
            yield from ev.get("verifies", [])
        else:
            yield ev


# ---------------------------------------------------------------------------
# phases 6 and 7: online, configs
# ---------------------------------------------------------------------------

#: the online phase's traffic: ShareGPT-length requests (prompts of at most
#: 256 tokens, at most 32 new tokens), Poisson arrivals at ONLINE_QPS a
#: second of modeled time.  At Llama-3-8B's width the H100 model prices a
#: decode pass at about 5 ms (16 GB of weights over 3.35 TB/s), so a
#: request of 32 new tokens lives about 0.2 modeled seconds, and 40
#: arrivals a second keep several requests in flight while others arrive
#: and retire: the decode batch changes throughout the run (checked)
ONLINE_REQUESTS, ONLINE_QPS, ONLINE_MAX_OUT = 16, 40.0, 32

#: M of the GEMM calibration: the serve runs' decode batch (8), a verify
#: pass (32), up to where the commit GEMM's time grows with M
CALIBRATION_MS = (8, 16, 32, 64, 128, 256, 512, 1024)

#: how far the measured GEMM ratio (capped at 1: a commit GEMM faster than
#: split-K is no gain the model gives) may lie from costmodel.H100's
#: bi_compute_frac and bi_mem_frac
CALIBRATION_FRAC_TOL = 0.05


def strip_wall(ev):
    """An engine event without its host wall times, the one field that
    differs between two runs of one schedule."""
    if isinstance(ev, dict):
        return {k: strip_wall(v) for k, v in ev.items() if k != "wall"}
    if isinstance(ev, (list, tuple)):
        return type(ev)(strip_wall(v) for v in ev)
    return ev


def online_requests(cfg):
    """ONLINE_REQUESTS ShareGPT-length requests from
    ``launch/serve.py::build_requests``; the even rids deterministic, alternately greedy and seeded at
    temperature 0.8."""
    from repro_torch.launch.serve import build_requests

    reqs = build_requests(cfg, ONLINE_REQUESTS, det_ratio=0.0, max_out=ONLINE_MAX_OUT,
                          seed=0, workload="sharegpt")
    for r in reqs:
        r.sampling.is_deterministic = r.rid % 2 == 0
        if r.rid % 4 == 2:
            r.sampling.temperature = 0.8
    return reqs


def gemm_calibration(torch, cfg, summary) -> None:
    """The H100 cost-model entry's GEMM fields, measured on this card and
    held to the entry's values: the commit GEMM (4 chunks) at (K, N) =
    (d_model, d_ff) for each M of CALIBRATION_MS, and the split-K GEMM at
    the decode batch, M = 8, under FAST_PATH_POLICY's schedule.  ``bi_compute_frac`` = split-K time /
    commit time at M = 8; ``sat_rows`` = the largest M up to which the
    commit GEMM's time stays within 10 % of its time at M = 8 (the rows a
    pass can add before the GEMM's time follows them)."""
    from repro_torch.core.determinism import CANONICAL_TP_SHARDS, FAST_PATH_POLICY
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk
    from repro_torch.serving import costmodel

    g = torch.Generator(device=DEV).manual_seed(12)
    K, N = cfg.d_model, cfg.d_ff
    w = (torch.randn((K, N), generator=g, device=DEV) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn((max(CALIBRATION_MS), K), generator=g, device=DEV).to(torch.bfloat16)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    commit = {M: time_ms(torch, lambda: gemm_batch_invariant(
        x[:M], w, chunks=CANONICAL_TP_SHARDS), reps=50, flush=scratch.zero_)
        for M in CALIBRATION_MS}
    s = FAST_PATH_POLICY.schedule_for(8)
    split = time_ms(torch, lambda: gemm_splitk(x[:8], w, splits=s.splits,
                                               combine_dtype=s.combine_dtype),
                    reps=50, flush=scratch.zero_)
    sat = CALIBRATION_MS[0]
    for M in CALIBRATION_MS:
        if commit[M] > 1.1 * commit[8]:
            break
        sat = M
    frac = split / commit[8]
    hw = costmodel.H100
    log(f"[online] H100 entry calibration, commit GEMM (M,{K})@({K},{N}) chunks=4 "
        "(ms, median of 50, L2 flushed): " + ", ".join(
            f"M={M} {t:.4f}" for M, t in commit.items())
        + f"; split-K at M=8, splits={s.splits} {s.combine_dtype} combine: {split:.4f} ms")
    log(f"[online] measured bi_compute_frac = {split:.4f} / {commit[8]:.4f} = "
        f"{frac:.4f}, sat_rows = {sat}; costmodel.H100 holds bi_compute_frac "
        f"{hw.bi_compute_frac}, bi_mem_frac {hw.bi_mem_frac}, sat_rows {hw.sat_rows}")
    summary["h100_calibration"] = {"commit_ms": commit, "splitk_ms_m8": split,
                                   "bi_compute_frac": frac, "sat_rows": sat}
    require(sat == hw.sat_rows, f"measured sat_rows {sat} is not costmodel.H100's "
            f"{hw.sat_rows}")
    require(all(abs(min(frac, 1.0) - f) <= CALIBRATION_FRAC_TOL
                for f in (hw.bi_compute_frac, hw.bi_mem_frac)),
            f"measured bi_compute_frac {frac:.4f} (capped at 1) is more than "
            f"{CALIBRATION_FRAC_TOL} from costmodel.H100's")
    del w, x, scratch


def phase_online(torch, cfg, params, capacity, results, summary) -> None:
    """The online runner (``serving.online.run_online``) on the card at the
    serve phase's width, depth and capacity, on the H100 cost model's
    clock: ONLINE_REQUESTS ShareGPT-length requests under Poisson arrivals,
    half of them deterministic.  It must drain with every latency >= TTFT >
    0 and the decode batch changing; launches reset just before and read
    just after; two runs give the same event log and the same modeled
    times; each deterministic request commits what it commits alone."""
    from repro_torch.core.determinism import Mode
    from repro_torch.serving import costmodel
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.online import percentile, run_online
    from repro_torch.training.data import poisson_arrivals

    gemm_calibration(torch, cfg, summary)
    arrivals = poisson_arrivals(ONLINE_REQUESTS, ONLINE_QPS, seed=0)
    first = online_requests(cfg)
    det = [r.rid for r in first if r.sampling.is_deterministic]
    log(f"[online] {cfg.name}: {cfg.num_layers} layers, capacity {capacity}; "
        f"{ONLINE_REQUESTS} ShareGPT-length requests (prompts "
        f"{min(len(r.prompt) for r in first)}-{max(len(r.prompt) for r in first)} "
        f"tokens, {min(r.sampling.max_new_tokens for r in first)}-"
        f"{max(r.sampling.max_new_tokens for r in first)} new), deterministic rids "
        f"{det} (greedy and seeded), Poisson arrivals at {ONLINE_QPS}/s over "
        f"{arrivals[-1] * 1e3:.1f} ms of modeled time; clock costmodel.H100 at "
        f"{cfg.name}'s scale")
    runs = []
    for i in range(2):
        gc.collect()
        eng = Engine(cfg, params, mode=Mode.LLM42, capacity=capacity)
        reqs = online_requests(cfg)
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        fns = reset_launches()
        start.record()
        t0 = time.perf_counter()
        res = run_online(eng, cfg, list(zip(reqs, arrivals)), hw=costmodel.H100)
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in fns.items()}
        device_s = start.elapsed_time(end) / 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        run = f"online run {i + 1}"
        require(len(res.latencies) == ONLINE_REQUESTS and len(eng.finished) == ONLINE_REQUESTS,
                f"{run}: did not drain")
        require(all(res.latencies[r] >= res.ttfts[r] > 0 for r in res.latencies),
                f"{run}: a latency below its TTFT, or a TTFT of 0")
        want = expected_launches(cfg, eng, True)
        log(f"[online] {run}: kernel launches {counts}; from the engine's passes {want}")
        require(counts == want, f"{run}: launches do not match the passes run")
        for name, n in counts.items():
            on_path = name in PATH_KERNELS["paged", "llm42"]
            require((n > 0) == on_path, f"{run}: {name} launched {n} times")
        batches = sorted({ev["batch"] for ev in engine_events(eng) if ev["kind"] == "decode"})
        require(len(batches) >= 3, f"{run}: the decode batch took only sizes {batches}")
        lat = sorted(res.latencies.values())
        ttft = sorted(res.ttfts.values())
        rt = eng.runtime
        log(f"[online] {run}: drained {ONLINE_REQUESTS} requests, {res.out_tokens} "
            f"tokens committed in {eng._now} iterations, rollbacks "
            f"{sum(r.num_rollbacks for r in eng.finished)}, decode batch sizes "
            f"{batches}, peak running {eng.peak_running}")
        log(f"[online] {run}: modeled (costmodel.H100, not a measurement): total "
            f"{res.total_time * 1e3:.3f} ms, latency p50 "
            f"{percentile(lat, 50) * 1e3:.3f} / p99 {percentile(lat, 99) * 1e3:.3f} ms, "
            f"TTFT p50 {percentile(ttft, 50) * 1e3:.3f} / p99 "
            f"{percentile(ttft, 99) * 1e3:.3f} ms; main-stream busy "
            f"{rt.main.busy * 1e3:.3f} ms, verify-stream busy {rt.verify.busy * 1e3:.3f} ms")
        log(f"[online] {run}: measured: CUDA-event device time {device_s:.3f} s, host "
            f"wall {host_s:.3f} s ({device_s / max(rt.main.busy, 1e-12):.1f}x the "
            f"modeled main-stream busy time); peak device memory {peak:.3f} GiB")
        runs.append((eng, res))
        summary[f"online_{i + 1}"] = dict(
            total_time_s=res.total_time, latency_p50_s=percentile(lat, 50),
            latency_p99_s=percentile(lat, 99), ttft_p50_s=percentile(ttft, 50),
            ttft_p99_s=percentile(ttft, 99), main_busy_s=rt.main.busy,
            verify_busy_s=rt.verify.busy, device_s=device_s, host_s=host_s,
            iterations=eng._now, committed=res.out_tokens, peak_mem_gib=peak,
            launches=counts)
        if i == 0:
            for name, n in counts.items():
                results[name]["launches_by_mode"]["online/paged/llm42"] = n
    (e1, r1), (e2, r2) = runs
    same = (strip_wall(e1.events) == strip_wall(e2.events)
            and r1.total_time == r2.total_time and r1.latencies == r2.latencies
            and r1.ttfts == r2.ttfts)
    log(f"[online] runs 1 and 2: same event log ({len(e1.events)} events, wall "
        f"times aside) and the same modeled total, latencies and TTFTs: {same}")
    require(same, "two online runs differ")
    online = {r.rid: r.committed for r in e1.finished}
    del runs, e1, e2
    for req in online_requests(cfg):
        if not req.sampling.is_deterministic:
            continue
        gc.collect()
        solo = Engine(cfg, params, mode=Mode.LLM42, capacity=capacity)
        solo.submit(req)
        got = solo.run()[0].committed
        require(got == online[req.rid],
                f"online rid {req.rid}: committed stream differs from the request alone")
        del solo
    log(f"[online] deterministic rids {det}: committed streams online equal the "
        f"same requests served alone")


# ---------------------------------------------------------------------------
# phase 7: analysis (the determinism-contract checker on the card)
# ---------------------------------------------------------------------------

#: kernel nodes that must not appear on a commit kind
FAST_NODES = ("gemm_splitk(", "paged_attention_fast(")


def log_certificate(tag, name, cert) -> None:
    """One line a kind: its verdict and kernel nodes; then the control."""
    for kind, kc in cert["kinds"].items():
        keys = kc.get("batches", kc.get("tps"))
        log(f"[analysis] {tag} {name} {kind}: invariant={kc['invariant']} at "
            f"{'B' if 'batches' in kc else 'tp'} {keys}, {kc['canonical_lines']} "
            f"canonical lines" + (f", kernel nodes {kc['kernels']}" if "kernels" in kc else ""))
    ctl = cert["negative_control"]
    log(f"[analysis] {tag} {name} control {ctl['kind']} at "
        f"{ctl.get('batches', ctl.get('tps'))}: differs={ctl['schedules_differ']} "
        f"{ctl['kernels']}")


def require_certified(name, cert) -> None:
    for kind, kc in cert["kinds"].items():
        require(kc["invariant"], f"analysis: {name} {kind} is not invariant")
        bad = [k for k in kc.get("kernels", {}) if k.startswith(FAST_NODES)
               or (k.startswith("decode_attention(") and "kv_splits=1" not in
                   k.replace(")", ",").split(" "))]
        require(not bad, f"analysis: fast kernel nodes {bad} on {name} {kind}")
    require(cert["negative_control"]["schedules_differ"],
            f"analysis: {name}'s negative control did not differ")


def phase_analysis(torch, cfg, params, summary) -> None:
    """``repro_torch.analysis`` on CUDA tensors: the source passes, the four
    arch classes at batches 13, 17 and 19 and the mesh pass at TP 1, 2 and
    4 (every commit kind invariant, both controls differing, no
    unexplained finding, no fast kernel node on a commit kind); the
    attention class at Llama-3-8B's full width and depth on the serve
    phase's weights; a smoke verify recorded with TF32 on, which must be
    flagged; the card's canonical programs beside the CPU's."""
    from repro_torch.analysis import hazards, invariance, kernel_lint, taint
    from repro_torch.analysis.report import Report, load_allowlist
    from repro_torch.analysis.trace_utils import compare_canonical

    times = {}
    allow = load_allowlist(ROOT / "src/repro_torch/analysis/allowlist.toml")
    report = Report(allowlist=allow)

    t0 = time.perf_counter()
    report.extend(taint.run_pass(ROOT))
    report.extend(kernel_lint.run_pass(ROOT))
    times["source passes"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    findings, certs, traces = invariance.run_pass(device=DEV)
    report.extend(findings)
    report.extend(hazards.run_pass(traces))
    sync(torch)
    times["four arch classes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_findings, mesh_certs = invariance.run_mesh_pass(device=DEV)
    report.extend(mesh_findings)
    certs.update(mesh_certs)
    sync(torch)
    times["mesh pass"] = time.perf_counter() - t0
    report.finish()
    for name, cert in sorted(certs.items()):
        log_certificate("card", name, cert)
    for f in report.suppressed:
        log(f"[analysis] allowlisted {f.pass_name}/{f.rule} at {f.where}")
    require(report.ok, "analysis: unexplained findings:\n" + report.format())
    for name, cert in certs.items():
        require_certified(name, cert)
    log(f"[analysis] card: {len(certs)} certificates, 0 unexplained findings, "
        f"{len(report.suppressed)} allowlisted")

    t0 = time.perf_counter()
    full_findings, full_certs, full_traces = invariance.run_pass(
        arches=("attention",), device=DEV, cfg=cfg, params=params)
    full_report = Report(allowlist=allow)
    full_report.extend(full_findings)
    full_report.extend(hazards.run_pass(full_traces))
    sync(torch)
    times["attention at full width"] = time.perf_counter() - t0
    log_certificate(f"{cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model})",
                    "attention", full_certs["attention"])
    require(full_report.ok, "analysis at full width:\n" + full_report.format())
    require_certified(f"{cfg.name} attention", full_certs["attention"])
    del full_traces

    t0 = time.perf_counter()
    flag = torch.backends.cuda.matmul.allow_tf32
    smoke = traces[0]
    engine = invariance.build_engine(smoke.cfg, invariance.smoke_params(smoke.cfg, DEV))
    seeded = hazards.scan_trace(invariance.trace_verify(engine, invariance.BATCHES[0], tf32=True),
                                invariance.BATCHES[0], arch="attention", kind="verify")
    tf32 = [f for f in seeded if f.rule == "tf32-enabled"]
    log(f"[analysis] seeded TF32 verify: {len(tf32)} tf32-enabled finding(s), e.g. "
        f"{tf32[0].where if tf32 else None}")
    require(tf32, "analysis: a verify recorded with TF32 on was not flagged")
    require(torch.backends.cuda.matmul.allow_tf32 == flag, "analysis: TF32 flag not restored")
    times["seeded TF32"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: one thread is the fastest on the host
    try:
        _, _, cpu_traces = invariance.run_pass(device="cpu")
    finally:
        torch.set_num_threads(threads)
    same = {}
    for card_tr, cpu_tr in zip(traces, cpu_traces):
        for kind in invariance.INVARIANT_KINDS:
            diffs = [(b, compare_canonical(cpu_tr.canon[kind][b], card_tr.canon[kind][b], b, b))
                     for b in invariance.BATCHES
                     if cpu_tr.canon[kind][b] != card_tr.canon[kind][b]]
            same[f"{card_tr.arch}/{kind}"] = not diffs
            first = ""
            if diffs:
                b, (line, a, c) = diffs[0]
                first = f"; first at B={b} line {line}: CPU {a!r} card {c!r}"
            log(f"[analysis] CPU vs card {card_tr.arch} {kind}: canonical text equal "
                f"at {len(invariance.BATCHES) - len(diffs)} of {len(invariance.BATCHES)} "
                f"batches{first}")
    times["CPU traces"] = time.perf_counter() - t0

    log("[analysis] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    summary["analysis"] = {
        "certificates": len(certs), "allowlisted": len(report.suppressed),
        "full_width_invariant": True, "tf32_flagged": len(tf32),
        "cpu_equals_card": same, "seconds": {k: round(v, 1) for k, v in times.items()},
    }


#: the configs phase: each new dense config at full width.  Depth is full
#: for tinyllama (22) and phi3 (32).  command-r's 61 GB of bf16 weights (65
#: with the tied unembedding copy) leave no room for the run on one 80 GB
#: card, so it runs 8 of 40 layers; internlm2's 40 GB would fit, and it runs
#: 12 of 48 to keep its host-bound serve runs (time grows with depth) short
CONFIG_DEPTHS = {"tinyllama-1.1b": None, "phi3-mini-3.8b": None,
                 "internlm2-20b": 12, "command-r-35b": 8}

#: the fast paged kernel's bf16 combine at the configs' head shapes.  Its
#: e = exp(s - m) is rounded to bf16, and it sums each f32 score s in
#: another order than its plain version: an e whose f32 value lies near a
#: bf16 rounding midpoint rounds to one neighbour in the kernel and to the
#: other in the plain version.  Such a flip, one bf16 ulp (<= 2^-7 e), moves
#: the row's outputs by up to 2^-7 |v_j - o| / d, which at few keys a row
#: (d small) lies far past FAST_ATTN_TOL's 1e-4, measured at Llama-3-8B's
#: heads.  So an output beyond FAST_ATTN_TOL passes only where its (row,
#: head) slice is explained: the plain version with at most FLIP_MAX of the
#: slice's e rounded to their other neighbour, each e within FLIP_WINDOW
#: (relative) of a rounding midpoint in the plain version's f32, comes
#: within FAST_ATTN_TOL of the kernel on the whole slice.  The mean error,
#: which isolated flips hardly move, is held to FAST_BF16_MEAN_RATIO of the
#: plain bf16 and f32 versions' mean gap: the kernel rounds e where the
#: plain version does
FLIP_WINDOW = 2.0 ** -16
FLIP_MAX = 3
FAST_BF16_MEAN_RATIO = 0.25

#: more draws of the serve shape (seed 13 is its own) for the bf16 combine:
#: at few keys a row flips show the most
FLIP_SEEDS = (21, 34)

#: host ops that copy a tensor: none may take the whole embedding
COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy", "aten::to")


def fast_bf16_parts(torch, inp, splits):
    """``ref.paged_attention_fast`` with the bf16 combine, step for step,
    keeping what a flip of one e needs: per key its f32 e before rounding,
    the rounded e and its split's factor exp(m_c - m) into the merged row,
    and the row's merged f32 numerator and denominator.  Returns (out, e32,
    e, factor, acc, d, v) with e32, e and factor (B, KV, G, keys), acc (B,
    KV, G, D), d (B, KV, G) and v the gathered (B, keys, KV, D) values."""
    from repro_torch.kernels import ref

    q, k_pool, v_pool, pos_pool, tables, q_pos = inp[:6]
    B, H, D = q.shape
    KV, bs, nblk = k_pool.shape[2], k_pool.shape[1], tables.shape[1]
    kf, vf, pos = ref._view(k_pool, v_pool, pos_pool, tables, None)
    valid = (pos >= 0) & (pos <= q_pos[:, None])
    qg = ref._scaled_q(q, KV)
    per = nblk // splits * bs
    m = d = acc = None
    e32s, es, ms = [], [], []
    for sp in range(splits):
        sl = slice(sp * per, (sp + 1) * per)
        s = ref._scores(qg, kf[:, sl], valid[:, sl])
        m_c = s.amax(dim=-1).clamp_min(-1e30)
        e32 = torch.exp(s - m_c[..., None])
        e = e32.to(torch.bfloat16).to(torch.float32)
        d_c = e.sum(dim=-1)
        o_c = torch.einsum("bkgs,bskd->bkgd", e, vf[:, sl])
        if m is None:
            m, d, acc = m_c, d_c, o_c
        else:
            m_new = torch.maximum(m, m_c)
            a_prev, a_c = torch.exp(m - m_new), torch.exp(m_c - m_new)
            d = d * a_prev + d_c * a_c
            acc = acc * a_prev[..., None] + o_c * a_c[..., None]
            m = m_new
        e32s.append(e32)
        es.append(e)
        ms.append(m_c)
    factor = torch.cat([torch.exp(m_c - m)[..., None].expand_as(e) for m_c, e in zip(ms, es)],
                       dim=-1)
    out = (acc / d.clamp_min(1e-30)[..., None]).reshape(B, H, D)
    return out, torch.cat(e32s, dim=-1), torch.cat(es, dim=-1), factor, acc, d, vf


def explain_flips(torch, parts, out):
    """Each (row, head) slice of ``out`` with an output beyond
    FAST_ATTN_TOL of the plain version (``parts``, from
    ``fast_bf16_parts``), explained greedily: of the slice's keys whose f32
    e lies within FLIP_WINDOW of a bf16 rounding midpoint, up to FLIP_MAX
    are rounded to their other neighbour in the plain version, each the one
    that brings the slice closest to the kernel's.  Returns one dict a
    slice: its row, head, error, the keys flipped (with their f32 e and its
    relative distance from the midpoint) and the slice's error after the
    flips."""
    want, e32, e, factor, acc, d, vf = parts
    B, H, D = out.shape
    G = H // vf.shape[2]
    tol = FAST_ATTN_TOL["bfloat16"]
    diff = (out - want).abs()
    low = (e32.view(torch.int32) & -65536).view(torch.float32)
    high = ((e32.view(torch.int32) & -65536) + 65536).view(torch.float32)
    gap = (e32 - (low + high) / 2).abs() / e32.clamp_min(1e-30)
    near = (e32 > 0) & (gap <= FLIP_WINDOW)
    delta = torch.where(e == low, high, low) - e
    slices = []
    for b, h in (diff.amax(dim=-1) > tol).nonzero().tolist():
        kv, gi = divmod(h, G)
        keys = near[b, kv, gi].nonzero().flatten().tolist()

        def resid(js):
            w = delta[b, kv, gi, js] * factor[b, kv, gi, js]
            o = (acc[b, kv, gi] + w @ vf[b, js, kv]) / (d[b, kv, gi] + w.sum())
            return float((o - out[b, h]).abs().max())

        chosen, best = [], float(diff[b, h].max())
        while best > tol and len(chosen) < FLIP_MAX:
            trials = [(resid(chosen + [j]), j) for j in keys if j not in chosen]
            if not trials or min(trials)[0] >= best:
                break
            best, j = min(trials)
            chosen.append(j)
        slices.append(dict(row=b, head=h, err=float(diff[b, h].max()), resid=best,
                           flips=[(j, float(e32[b, kv, gi, j]), float(gap[b, kv, gi, j]))
                                  for j in chosen]))
    return slices


def paged_fast_bf16_case(torch, label, inp, splits):
    """The fast paged kernel with the bf16 combine against its plain
    version, held as FLIP_WINDOW, FLIP_MAX and FAST_BF16_MEAN_RATIO say:
    each output within FAST_ATTN_TOL, or its slice explained by flips of
    e (``explain_flips``); the mean error within the ratio."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_fast

    out = paged_attention_fast(*inp[:6], kv_splits=splits, combine_dtype="bfloat16")
    want = ref.paged_attention_fast(*inp[:6], kv_splits=splits, combine_dtype="bfloat16")
    want32 = ref.paged_attention_fast(*inp[:6], kv_splits=splits, combine_dtype="float32")
    parts = fast_bf16_parts(torch, inp, splits)
    require(torch.equal(parts[0], want), f"fast_bf16_parts is not the plain version ({label})")
    diff = (out - want).abs()
    err, mean_err = float(diff.max()), float(diff.mean())
    gap = float((want - want32).abs().mean())
    slices = explain_flips(torch, parts, out)
    tol = FAST_ATTN_TOL["bfloat16"]
    log(f"[configs] paged_attention_fast {label} kv_splits={splits} bfloat16: "
        f"max_abs_err {err:.3e}, mean {mean_err:.3e} = {mean_err / max(gap, 1e-30):.3f} of "
        f"the plain bf16-f32 mean gap {gap:.3e} (limit {FAST_BF16_MEAN_RATIO}); "
        f"{int((diff > 0).sum())} of {out.numel()} differ, {len(slices)} (row, head) "
        f"slices beyond {tol:g}")
    for sl in slices:
        flips = ", ".join(f"key {j} (plain f32 e {e:.9g}, {g:.2e} from a bf16 midpoint)"
                          for j, e, g in sl["flips"])
        log(f"[configs]   row {sl['row']} head {sl['head']}: max_abs_err {sl['err']:.3e}; "
            f"plain with e rounded the other way at {flips or 'no key'}: {sl['resid']:.3e} "
            f"(tol {tol:g})")
    require(all(sl["resid"] <= tol for sl in slices),
            f"paged_attention_fast disagrees with its plain version beyond flips of e ({label})")
    require(mean_err <= FAST_BF16_MEAN_RATIO * gap,
            f"paged_attention_fast's mean error is too large ({label})")
    return err


def check_config_kernels(torch, cfg, arch, results) -> None:
    """The attention kernels at the config's (H, KV, D) at the ``headline``
    and ``serve`` shapes against their plain versions, the commit paged
    kernel's and ``decode_attention``'s rows across B, and the commit GEMM
    at the config's LM-head shape: against its plain version at M = 32 and
    its rows across M."""
    from repro_torch.core.determinism import CANONICAL_TP_SHARDS
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.models.base import padded_vocab

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = dict.fromkeys(("paged_attention", "paged_attention_fast", "decode_attention",
                          "gemm_batch_invariant"), 0.0)
    names = ("headline", "serve")
    for label, inp in paged_shapes(torch, cfg, names).items():
        label = f"{arch} {label}"
        out, err = paged_commit_case(torch, label, inp, phase="configs")
        errs["paged_attention"] = max(errs["paged_attention"], err)
        paged_rows_invariant(torch, label, inp, out, phase="configs")
        for splits, cd in FAST_CASES:
            err = (paged_fast_bf16_case(torch, label, inp, splits) if cd == "bfloat16"
                   else paged_fast_case(torch, label, inp, splits, cd, phase="configs")[2])
            errs["paged_attention_fast"] = max(errs["paged_attention_fast"], err)
    for label, inp in decode_shapes(torch, cfg, names).items():
        label = f"{arch} {label}"
        for splits, cd in DECODE_CASES:
            out, err = decode_case(torch, label, inp, splits, cd, phase="configs")
            errs["decode_attention"] = max(errs["decode_attention"], err)
        decode_rows_invariant(torch, label, inp, out, phase="configs")
    for seed in FLIP_SEEDS:
        inp = paged_inputs(torch, cfg, 8, CAPACITY, BLOCK, seed=seed, min_ctx=33, max_ctx=49)
        for splits, cd in FAST_CASES:
            if cd == "bfloat16":
                err = paged_fast_bf16_case(torch, f"{arch} serve seed {seed}", inp, splits)
                errs["paged_attention_fast"] = max(errs["paged_attention_fast"], err)
    g = torch.Generator(device=DEV).manual_seed(11)
    # the stored unembedding's width: the vocabulary padded to a multiple of
    # 8 with zero columns (seamless-m4t's 256206 -> 256208)
    D, V = cfg.d_model, padded_vocab(cfg)
    w = (torch.randn((D, V), generator=g, device=DEV) * D ** -0.5).to(torch.bfloat16)
    w[:, cfg.vocab_size:] = 0
    x = torch.randn((200, D), generator=g, device=DEV).to(torch.bfloat16)
    out = gemm_batch_invariant(x[:32].contiguous(), w, chunks=CANONICAL_TP_SHARDS)
    want = ref.gemm_batch_invariant(x[:32], w, chunks=CANONICAL_TP_SHARDS)
    err = float((out.float() - want.float()).abs().max())
    tol = 2 * ulp_of(float(want.float().abs().max()), 7)
    log(f"[configs] gemm_batch_invariant {arch} LM head (32,{D})@({D},{V}) chunks=4: "
        f"max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps of max|ref|)")
    require(err <= tol, f"{arch}: gemm_batch_invariant disagrees at the LM head")
    errs["gemm_batch_invariant"] = err
    del out, want
    commit_rows_invariant(torch, gemm_batch_invariant, x, w, CANONICAL_TP_SHARDS)
    log(f"[configs] gemm_batch_invariant {arch} LM head: rows bitwise identical for "
        f"M in {ROW_MS}; repeatable")
    for name, e in errs.items():
        results[name].setdefault("max_abs_err_by_config", {})[arch] = e


def config_serve(torch, cfg, arch, params, results):
    """A short paged LLM42 serve: two deterministic requests (greedy, and
    seeded at temperature 0.8 with top-k 50) alone and beside 3 NONDET
    neighbours, under the divergence demo's aggressive fast path.  Counts
    reset just before each run and read just after; the streams must be
    identical."""
    from repro_torch.core.determinism import Mode, ReductionPolicy
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, SamplingParams

    policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                             combine_dtype="bfloat16")
    tracked = {0: dict(seed=7), 1: dict(seed=8, temperature=0.8, top_k=50)}
    total = dict.fromkeys(KERNELS, 0)

    def run(n_neighbours):
        gc.collect()
        eng = Engine(cfg, params, mode=Mode.LLM42, policy=policy, window=6, group=2,
                     max_batch=8, capacity=CAPACITY)
        for rid, kw in tracked.items():
            eng.submit(Request(rid=rid, prompt=[rid * 11 + k for k in range(1, 33)],
                               sampling=SamplingParams(max_new_tokens=16,
                                                       is_deterministic=True, **kw)))
        for i in range(n_neighbours):
            eng.submit(Request(rid=10 + i, prompt=[3 * i + k for k in range(20)],
                               sampling=SamplingParams(max_new_tokens=16)))
        fns = reset_launches()
        done = {r.rid: r for r in eng.run()}
        counts = {name: fn.launches for name, fn in fns.items()}
        want = expected_launches(cfg, eng, True)
        require(counts == want, f"{arch}: launches {counts} do not match the passes {want}")
        for name, n in counts.items():
            on_path = name in PATH_KERNELS["paged", "llm42"]
            require((n > 0) == on_path, f"{arch}: {name} launched {n} times")
            total[name] += n
        rb = sum(done[rid].num_rollbacks for rid in tracked)
        return {rid: done[rid].committed for rid in tracked}, rb, eng._now

    alone, rb0, it0 = run(0)
    crowd, rb3, it3 = run(3)
    same = alone == crowd
    log(f"[configs] {arch} paged LLM42, 2 deterministic requests (greedy + seeded) "
        f"x 16 tokens alone ({it0} iterations, {rb0} rollbacks) and beside 3 "
        f"neighbours ({it3} iterations, {rb3} rollbacks): identical={same}; kernel "
        f"launches {total}")
    require(same, f"{arch}: LLM42 streams changed beside 3 neighbours")
    require(all(len(s) == 16 for s in alone.values()), f"{arch}: short streams")
    for name, n in total.items():
        results[name]["launches_by_mode"][f"configs/{arch}"] = n
    return {"rollbacks_alone": rb0, "rollbacks_beside_3": rb3}


def check_no_embedding_copy(torch, cfg, params) -> int:
    """A tied config's forward makes no copy of the (vocab, d_model)
    embedding: no host copy op in a profiled serve run of 2 new tokens
    takes a tensor of that shape, where a per-pass transpose copy would
    (checked first on one explicit ``embed.t().contiguous()``).  Returns
    the forwards profiled."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.determinism import Mode
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, SamplingParams

    shapes = ([cfg.vocab_size, cfg.d_model], [cfg.d_model, cfg.vocab_size])

    def embedding_copies(fn):
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            fn()
            sync(torch)
        return [(e.key, e.count) for e in prof.key_averages(group_by_input_shape=True)
                if e.key in COPY_OPS and any(list(s) in shapes for s in e.input_shapes)]

    control = embedding_copies(lambda: params["embed"].t().contiguous())
    require(control, "the copy check does not see an explicit transpose copy")
    eng = Engine(cfg, params, mode=Mode.LLM42, capacity=CAPACITY)
    eng.submit(Request(rid=0, prompt=list(range(1, 17)),
                       sampling=SamplingParams(max_new_tokens=2)))
    seen = embedding_copies(eng.run)
    forwards = sum(1 for ev in engine_events(eng)
                   if ev["kind"] in ("prefill", "prefill_chunk", "decode", "verify"))
    log(f"[configs] {cfg.name} tied embedding: {forwards} forwards profiled, host copy "
        f"ops on a {cfg.vocab_size}x{cfg.d_model} tensor: {seen or 'none'} (an explicit "
        f"embed.t().contiguous() shows {control})")
    require(not seen, f"{cfg.name}: a forward copies the embedding")
    return forwards


def phase_configs(torch, results, summary) -> None:
    """Each dense config beside Llama-3-8B at full width (depth per
    CONFIG_DEPTHS), random weights from seed 0: its kernels at its head
    shape and LM head, a short paged LLM42 serve beside neighbours, the
    tied embedding's copy check, and the peak device memory."""
    from repro_torch import configs
    from repro_torch.models.base import init_params

    summary["configs"] = {}
    for arch, depth in CONFIG_DEPTHS.items():
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth) if depth else full
        log(f"[configs] {arch}: {cfg.num_layers} of {full.num_layers} layers, d_model "
            f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} (group "
            f"{cfg.num_heads // cfg.num_kv_heads}), head_dim {cfg.hd}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size}, tied embeddings {cfg.tie_embeddings}, {cfg.dtype}")
        t0 = time.perf_counter()
        check_config_kernels(torch, cfg, arch, results)
        gc.collect()
        torch.cuda.empty_cache()
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
        sync(torch)
        weights = torch.cuda.memory_allocated() / 2 ** 30
        tied = (params["unembed"].numel() * params["unembed"].element_size() / 2 ** 30
                if cfg.tie_embeddings else 0.0)
        info = config_serve(torch, cfg, arch, params, results)
        if cfg.tie_embeddings:
            info["forwards_without_embedding_copy"] = check_no_embedding_copy(
                torch, cfg, params)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[configs] {arch}: weights {weights:.3f} GiB (of it the tied unembedding "
            f"copy {tied:.3f} GiB), peak device memory {peak:.3f} GiB; "
            f"{time.perf_counter() - t0:.1f} s")
        summary["configs"][arch] = dict(layers=cfg.num_layers, weights_gib=weights,
                                        tied_unembed_gib=tied, peak_mem_gib=peak, **info)
        del params
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: variants (sliding-window rings, q-chunked attention, MoE)
# ---------------------------------------------------------------------------

#: the variants phase's depth cuts, for memory and phase time: Scout's bf16
#: weights are about 4.15 GB a layer (16 experts x 3 x 5120 x 8192) plus
#: 4.1 GB of embedding and unembedding; 8 of its 48 layers (about 37 GB)
#: would fit one 80 GB card beside its runs, and it runs 4 (about 21 GB)
#: since the cluster and training phases came, to keep the whole script
#: within its earlier length; its chunked8k variant's 8300-token prompt runs
#: 2 of them (65 ring-capped prefill chunks a run); phi3-sw4k runs 4 of 32
#: (two 4200- and 4300-token prompts a run; 8 before the same cut); the
#: gathered lane's long prefill runs llama3-8b at 2 layers
VARIANT_DEPTHS = {"llama4-scout-17b-a16e": 4, "llama4-scout-chunked8k": 2,
                  "phi3-mini-3.8b-sw4k": 4, "llama3-8b": 2}

#: the kernels that read attention K/V (none of them reads a ring)
ATTENTION_KERNELS = ("paged_attention", "paged_attention_fast", "decode_attention")

#: batch sizes of the ring and MoE row checks (B for the ring's W == 1
#: pass, T tokens for moe_ffn)
RING_ROWS = (1, 3, 8, 13)
MOE_ROWS = (1, 3, 8, 13, 32)


def tracked_engine(cfg, params, mode, prompts, max_new, *, decorate=None, neighbours=0,
                   **engine_kw):
    """An engine under the divergence demo's aggressive fast path (window
    6, group 2, at most 8 rows) with the tracked requests submitted: rid
    i a prompt of ``prompts[i]`` tokens ``(11 i + 7 k) % vocab``, greedy
    (seed 7) for even rids and seeded at temperature 0.8 with top-k 50
    (seed 8) for odd ones, deterministic outside NONDET; then
    ``neighbours`` requests of 32 + 16 tokens (rids 10, 11, ...).  Each
    request passes through ``decorate`` (its side inputs) first."""
    from repro_torch.core.determinism import Mode, ReductionPolicy
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, SamplingParams

    policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                             combine_dtype="bfloat16")
    kws = (dict(seed=7), dict(seed=8, temperature=0.8, top_k=50))
    side = decorate or (lambda r: r)
    eng = Engine(cfg, params, mode=mode, policy=policy, window=6, group=2, max_batch=8,
                 **engine_kw)
    for rid, plen in enumerate(prompts):
        eng.submit(side(Request(
            rid=rid, prompt=[(rid * 11 + 7 * k) % cfg.vocab_size for k in range(1, plen + 1)],
            sampling=SamplingParams(max_new_tokens=max_new,
                                    is_deterministic=mode != Mode.NONDET, **kws[rid % 2]))))
    for i in range(neighbours):
        eng.submit(side(Request(rid=10 + i, prompt=[3 * i + k for k in range(32)],
                                sampling=SamplingParams(max_new_tokens=16))))
    return eng


def variant_serve(torch, cfg, label, params, results, *, lanes, modes, prompts,
                  max_new, neighbours, capacity, phase="variants", decorate=None):
    """Two (or ``len(prompts)``) tracked requests, greedy and seeded at
    temperature 0.8 with top-k 50, deterministic outside NONDET, alone and
    beside ``neighbours`` requests of 32 + 16 tokens, per lane ("paged",
    "gathered", or "ring" / "state": a sliding or a recurrent config, whose
    pool has no paged leaves) and mode,
    under the divergence demo's aggressive fast path.  Counts reset just
    before each run and read just after, held to what the passes imply
    (a pool without paged leaves reads no attention kernel); LLM42 and
    BATCH_INVARIANT streams must be identical (NONDET divergence printed).
    ``decorate`` (a request -> request function) gives each request its side
    inputs (encoder frames, prefix embeds) before it is submitted.  Returns
    a summary per run, with each run's CUDA-event device time."""
    from repro_torch.core.determinism import Mode

    out = {}
    for lane in lanes:
        for mode in modes:
            run_name = f"{phase}/{label}/{lane}/{mode.value}"
            streams, info = {}, {}
            total = dict.fromkeys(KERNELS, 0)
            for n in (0, neighbours):
                gc.collect()
                t0 = time.perf_counter()
                eng = tracked_engine(cfg, params, mode, prompts, max_new, decorate=decorate,
                                     neighbours=n, capacity=capacity,
                                     paged_attention=LANES.get(lane, False))
                sync(torch)
                torch.cuda.reset_peak_memory_stats()
                fns = reset_launches()
                ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                ev0.record()
                done = {r.rid: r for r in eng.run()}
                ev1.record()
                sync(torch)
                counts = {name: fn.launches for name, fn in fns.items()}
                want = expected_launches(cfg, eng, eng._paged_fwd)
                require(counts == want, f"{run_name} beside {n}: launches {counts} do not "
                        f"match the passes {want}")
                progs = check_programs(eng, f"{run_name} beside {n}")
                if not eng.pool.paged:  # no attention kernel reads a ring or a state
                    require(not any(counts[k] for k in ATTENTION_KERNELS),
                            f"{run_name}: an attention kernel ran without paged leaves")
                for name, c in counts.items():
                    total[name] += c
                streams[n] = {rid: done[rid].committed for rid in range(len(prompts))}
                require(all(len(x) == max_new for x in streams[n].values()),
                        f"{run_name}: short streams")
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                info[n] = dict(iterations=eng._now, peak_mem_gib=peak,
                               rollbacks=[done[r].num_rollbacks for r in streams[n]],
                               seconds=time.perf_counter() - t0,
                               device_s=ev0.elapsed_time(ev1) / 1e3)
                log(f"[{phase}] {run_name} beside {n}: {eng._now} iterations, "
                    f"rollbacks by tracked rid {info[n]['rollbacks']}, kernel launches "
                    f"{counts} (= the "
                    f"passes), peak device memory {peak:.3f} GiB; device time "
                    f"{info[n]['device_s']:.3f} s (CUDA events); "
                    f"{info[n]['seconds']:.1f} s; {progs['programs']} programs, "
                    f"{progs['replays']} replays, capture {progs['capture_s']:.2f} s")
                del eng
            same = streams[0] == streams[neighbours]
            log(f"[{phase}] {run_name}: streams alone and beside {neighbours} "
                f"identical={same}")
            if mode != Mode.NONDET:
                require(same, f"{run_name}: streams changed beside {neighbours} neighbours")
            for name, c in total.items():
                results[name]["launches_by_mode"][run_name] = c
            out[f"{lane}/{mode.value}"] = dict(identical=same, **{
                f"beside_{n}": v for n, v in info.items()})
            out[f"{lane}/{mode.value}"]["streams"] = streams[0]
    return out


#: M of the MoE checks: a decode expert bucket, a verify pass's 32 rows
#: (Scout's no-drop capacity at 32 tokens), a ring-capped prefill chunk
EXPERT_MS = (1, 32, 129)


def check_moe_gemms(torch, cfg, results) -> dict:
    """The GEMMs at the shapes a MoE layer gives them: the expert
    contractions in the commit GEMM with one chunk and f32 operands, (M, d)
    @ (d, f) and (M, f) @ (f, d), for M in EXPERT_MS, against the plain
    version (1e-4, as the kernels phase holds f32) with rows across M; the
    router (M, d) @ (d, E) in bf16 through the commit GEMM (4 chunks) and
    the split-K GEMM at the demo policy's splits.  Times the expert
    contraction beside ``torch.matmul`` (TF32 off) and its bound (f32
    bytes, or f32 CUDA-core operations at 67 TFLOP/s)."""
    from repro_torch.core.determinism import CANONICAL_TP_SHARDS
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEV).manual_seed(14)
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    shapes, worst = {}, 0.0
    for K, N in ((d, f), (f, d)):
        w = torch.randn((K, N), generator=g, device=DEV) * K ** -0.5
        xb = torch.randn((200, K), generator=g, device=DEV)
        for M in EXPERT_MS:
            x = xb[:M].contiguous()
            out = gemm_batch_invariant(x, w, chunks=1)
            err = float((out - ref.gemm_batch_invariant(x, w, chunks=1)).abs().max())
            require(err <= 1e-4, f"expert GEMM f32 ({M},{K})@({K},{N}) disagrees: {err}")
            worst = max(worst, err)
            k1 = time_ms(torch, lambda: gemm_batch_invariant(x, w, chunks=1), reps=30,
                         flush=scratch.zero_)
            lib = time_ms(torch, lambda: torch.matmul(x, w), reps=30, flush=scratch.zero_)
            k2 = time_ms(torch, lambda: gemm_batch_invariant(x, w, chunks=1), reps=30,
                         flush=scratch.zero_)
            b_ms, b_by = bound((M * K + K * N + M * N) * 4, 2.0 * M * K * N,
                               F32_FLOPS_PER_S)
            ms = (k1 + k2) / 2
            shapes[f"expert f32 ({M},{K})@({K},{N})"] = dict(
                ms=ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            log(f"[variants] gemm_batch_invariant expert f32 ({M},{K})@({K},{N}) chunks=1: "
                f"max_abs_err {err:.3e} (tol 1e-4); {ms:.4f} ms (torch.matmul {lib:.4f}, "
                f"bound {b_ms:.4f} by {b_by})")
        commit_rows_invariant(torch, gemm_batch_invariant, xb, w, 1)
    log(f"[variants] expert GEMMs f32: rows bitwise identical for M in {ROW_MS}")
    w = (torch.randn((d, E), generator=g, device=DEV) * 0.02).to(torch.bfloat16)
    x = torch.randn((32, d), generator=g, device=DEV).to(torch.bfloat16)
    out = gemm_batch_invariant(x, w, chunks=CANONICAL_TP_SHARDS)
    want = ref.gemm_batch_invariant(x, w, chunks=CANONICAL_TP_SHARDS)
    err = float((out.float() - want.float()).abs().max())
    tol = 2 * ulp_of(float(want.float().abs().max()), 7)
    require(err <= tol, f"router commit GEMM disagrees: {err} > {tol}")
    errs = [err]
    for M, splits in ((1, 16), (3, 8), (8, 4)):
        out = gemm_splitk(x[:M].contiguous(), w, splits=splits, combine_dtype="bfloat16")
        want = ref.gemm_splitk(x[:M], w, splits, "bfloat16")
        err = float((out.float() - want.float()).abs().max())
        tol = 4 * ulp_of(float(want.float().abs().max()), 7)
        require(err <= tol, f"router split-K GEMM at M={M} splits={splits} disagrees")
        errs.append(err)
    log(f"[variants] router (M,{d})@({d},{E}) bf16: commit GEMM 4 chunks and split-K "
        f"at 16 / 8 / 4 splits within 2 / 4 bf16 ulps of max|ref| (max_abs_err "
        f"{max(errs):.3e})")
    results["gemm_batch_invariant"].setdefault("shapes", {}).update(shapes)
    results["gemm_batch_invariant"].setdefault("max_abs_err_by_config", {})[
        f"{cfg.name} experts f32"] = worst
    del scratch
    return shapes


def ring_rows_invariant(torch, cfg, params) -> None:
    """A ring's W == 1 pass under the commit schedule (layer 0's
    ``attention_cached`` with the config's window) gives each row the same
    bits at B in RING_ROWS, on rings that have wrapped; prints whether
    ``_softmax_attend``'s ``einsum`` would (the reason the pass sums by a
    fixed tree)."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE, deterministic_torch
    from repro_torch.models import layers
    from repro_torch.models.transformer import RING_SLACK

    g = torch.Generator(device=DEV).manual_seed(12)
    N, C, W = max(RING_ROWS), cfg.window + RING_SLACK, cfg.window
    KV, D, dt = cfg.num_kv_heads, cfg.hd, getattr(torch, cfg.dtype)
    lp = {k: v[0] for k, v in params["blocks"]["0"]["attn"].items()}
    k = torch.randn((N, C, KV, D), generator=g, device=DEV).to(dt)
    v = torch.randn((N, C, KV, D), generator=g, device=DEV).to(dt)
    last = 3 * C + 17 * torch.arange(N, device=DEV)  # wrapped two times and more
    ring = torch.arange(C, device=DEV)
    pos = (last[:, None] - (last[:, None] - ring[None]) % C).to(torch.int32)
    x = torch.randn((N, 1, cfg.d_model), generator=g, device=DEV).to(dt)
    start = (last + 1).to(torch.int32)
    outs = {}
    with deterministic_torch():
        for B in RING_ROWS:
            cache = {"k": k[:B].clone(), "v": v[:B].clone(), "pos": pos[:B].clone()}
            outs[B], _ = layers.attention_cached(lp, cfg, x[:B], cache, start[:B],
                                                 VERIFY_SCHEDULE, W)
        same = all(torch.equal(outs[B], outs[N][:B]) for B in RING_ROWS)
        require(bool(torch.isfinite(outs[N].float()).all()), "ring pass: non-finite")
        # the einsum path on the same ring (positions after the write)
        q = torch.randn((N, 1, cfg.num_heads, D), generator=g, device=DEV) * D ** -0.5
        kp, qp = pos[:, None, :], start[:, None, None]
        mask = (kp >= 0) & (kp <= qp) & (kp > qp - W)
        ein = {B: layers._softmax_attend(q[:B], k[:B], v[:B], mask[:B], VERIFY_SCHEDULE)
               for B in RING_ROWS}
        tree = {B: layers._ring_decode_attend(q[:B], k[:B], v[:B], mask[:B])
                for B in RING_ROWS}
    ein_same = all(torch.equal(ein[B], ein[N][:B]) for B in RING_ROWS)
    tree_same = all(torch.equal(tree[B], tree[N][:B]) for B in RING_ROWS)
    err = float((tree[N] - ein[N]).abs().max())
    log(f"[variants] {cfg.name} ring W == 1 under the commit schedule, {C}-slot rings "
        f"wrapped (positions up to {int(last.max())}), window {W}: rows bitwise "
        f"identical for B in {RING_ROWS}: {same} (attention_cached); the fixed-tree "
        f"attend alone {tree_same}; _softmax_attend's einsum {ein_same}; fixed tree vs "
        f"einsum max_abs_err {err:.3e}")
    require(same and tree_same, f"{cfg.name}: ring W == 1 rows change with B")
    require(err <= 1e-5, f"{cfg.name}: fixed-tree ring attend disagrees with einsum")


def moe_rows_invariant(torch, cfg, params) -> dict:
    """``moe_ffn`` (layer 0's experts) under VERIFY_SCHEDULE gives each
    token row the same bits at T in MOE_ROWS tokens: no drop, capacity T,
    the rows landing in other bucket positions as T changes."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE, deterministic_torch
    from repro_torch.models.layers import moe_ffn

    g = torch.Generator(device=DEV).manual_seed(13)
    lp = {k: v[0] for k, v in params["blocks"]["0"]["moe"].items()}
    T = max(MOE_ROWS)
    x = torch.randn((1, T, cfg.d_model), generator=g, device=DEV).to(getattr(torch, cfg.dtype))
    fns = reset_launches()
    with deterministic_torch():
        full, aux = moe_ffn(lp, cfg, x, VERIFY_SCHEDULE)
        ys = {t: moe_ffn(lp, cfg, x[:, :t], VERIFY_SCHEDULE)[0] for t in MOE_ROWS}
    sync(torch)
    same = all(torch.equal(ys[t][0], full[0, :t]) for t in MOE_ROWS)
    launches = fns["gemm_batch_invariant"].launches
    layer_ms = {}
    for t in EXPERT_MS:  # one MoE layer: router, casts, 3E expert GEMMs
        xt = torch.randn((1, t, cfg.d_model), generator=g, device=DEV).to(x.dtype)
        layer_ms[t] = time_ms(torch, lambda: moe_ffn(lp, cfg, xt, VERIFY_SCHEDULE), reps=5)
    log(f"[variants] {cfg.name} one moe_ffn layer under VERIFY_SCHEDULE: "
        + ", ".join(f"T={t} {ms:.3f} ms" for t, ms in layer_ms.items()))
    want = (1 + 3 * cfg.num_experts) * (1 + len(MOE_ROWS))
    log(f"[variants] {cfg.name} moe_ffn under VERIFY_SCHEDULE: rows bitwise identical "
        f"for T in {MOE_ROWS}: {same}; router load at T={T} "
        f"{[round(float(a), 4) for a in aux['router_load']]}, dropped "
        f"{float(aux['dropped_frac'])}; commit-GEMM launches {launches} "
        f"(router + 3 x {cfg.num_experts} a call: {want})")
    require(bool(torch.isfinite(full.float()).all()), "moe_ffn: non-finite output")
    require(same, f"{cfg.name}: moe_ffn rows change with T")
    require(launches == want and fns["gemm_splitk"].launches == 0,
            f"{cfg.name}: moe_ffn launches {launches}, want {want}")
    return layer_ms


def long_prefill_gathered(torch, results) -> dict:
    """The gathered lane's q-chunked prefill (a 3000-token prompt, bucket
    4096 > CHUNK_THRESHOLD) at llama3-8b's width, 2 layers, capacity 4096:
    LLM42 commits the paged lane's stream."""
    from repro_torch import configs
    from repro_torch.core.determinism import Mode
    from repro_torch.models import layers
    from repro_torch.models.base import init_params
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, SamplingParams

    cfg = dataclasses.replace(configs.get_config("llama3-8b"),
                              num_layers=VARIANT_DEPTHS["llama3-8b"])
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    calls = []
    real = layers._chunked_attend

    def spy(q, *a):
        calls.append(tuple(q.shape))
        return real(q, *a)

    streams, info = {}, {}
    layers._chunked_attend = spy
    try:
        for lane in ("gathered", "paged"):
            gc.collect()
            sync(torch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng = Engine(cfg, params, mode=Mode.LLM42, window=6, group=1, max_batch=2,
                         capacity=4096, paged_attention=LANES[lane])
            eng.submit(Request(rid=0, prompt=[(5 * k) % cfg.vocab_size for k in range(3000)],
                               sampling=SamplingParams(max_new_tokens=16,
                                                       is_deterministic=True)))
            fns = reset_launches()
            streams[lane] = eng.run()[0].committed
            sync(torch)
            counts = {name: fn.launches for name, fn in fns.items()}
            require(counts == expected_launches(cfg, eng, LANES[lane]),
                    f"long prefill {lane}: launches {counts}")
            for name, c in counts.items():
                results[name]["launches_by_mode"][f"variants/llama3-8b-long/{lane}"] = c
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            info[lane] = dict(peak_mem_gib=peak, seconds=time.perf_counter() - t0)
            if lane == "gathered":
                # its ("prefill", 4096) program ran the body twice on the
                # card (the warm-up and the capture), once a step on the CPU
                prog = eng._programs[("prefill", 4096)]
                body_runs = prog.runs + prog.captures
            log(f"[variants] llama3-8b ({cfg.num_layers} layers) 3000-token exclusive "
                f"prefill + 16 LLM42 tokens, {lane} lane: q-chunked calls so far "
                f"{len(calls)}, launches {counts}, peak device memory {peak:.3f} GiB; "
                f"{info[lane]['seconds']:.1f} s")
            del eng
    finally:
        layers._chunked_attend = real
    require(calls == [(1, 4096, cfg.num_heads, cfg.hd)] * cfg.num_layers * body_runs,
            f"the gathered prefill did not run q-chunked at each layer of its "
            f"{body_runs} body runs: {calls}")
    same = streams["gathered"] == streams["paged"]
    log(f"[variants] gathered lane's q-chunked prefill commits the paged lane's "
        f"stream: {same}")
    require(same and len(streams["paged"]) == 16, "long prefill: lanes differ")
    del params
    return dict(identical=same, **info)


def phase_variants(torch, results, summary) -> None:
    """Scout (MoE, paged) and its chunked8k variant (MoE + an 8192 window),
    phi3-sw4k (a 4096 window) and the gathered lane's q-chunked prefill,
    at published widths with depth cut per VARIANT_DEPTHS, random weights
    from seed 0."""
    from repro_torch import configs
    from repro_torch.core.determinism import Mode
    from repro_torch.models.base import init_params
    from repro_torch.models.transformer import RING_SLACK

    summary["variants"] = out = {}
    both = (Mode.LLM42, Mode.BATCH_INVARIANT)

    def step(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        sync(torch)
        log(f"[variants] step {name}: {time.perf_counter() - t0:.1f} s")
        return res

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        sync(torch)
        torch.cuda.reset_peak_memory_stats()

    # llama4-scout-17b-a16e: MoE, full attention, paged, heads 40/8 (G = 5)
    arch = "llama4-scout-17b-a16e"
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=VARIANT_DEPTHS[arch])
    log(f"[variants] {arch}: {cfg.num_layers} of {full.num_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} (group "
        f"{cfg.num_heads // cfg.num_kv_heads}), head_dim {cfg.hd}, {cfg.num_experts} "
        f"experts top-{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}")
    step("scout kernels at G = 5", check_config_kernels, torch, cfg, arch, results)
    gemms = step("scout expert and router GEMMs", check_moe_gemms, torch, cfg, results)
    fresh()
    params = step("scout weights", init_params, cfg,
                  torch.Generator(device=DEV).manual_seed(0), DEV)
    sync(torch)
    weights = torch.cuda.memory_allocated() / 2 ** 30
    layer_ms = step("scout moe rows", moe_rows_invariant, torch, cfg, params)
    scout = {"weights_gib": weights, "expert_gemms": gemms, "moe_layer_ms": layer_ms}
    scout.update(step("scout serve", variant_serve, torch, cfg, arch, params, results,
                      lanes=("paged", "gathered"), modes=both, prompts=(32, 32),
                      max_new=16, neighbours=3, capacity=CAPACITY))
    scout.update(step("scout nondet", variant_serve, torch, cfg, arch, params, results,
                      lanes=("paged",), modes=(Mode.NONDET,), prompts=(32, 32),
                      max_new=16, neighbours=3, capacity=CAPACITY))
    same = scout["paged/llm42"]["streams"] == scout["gathered/llm42"]["streams"]
    log(f"[variants] {arch} LLM42 streams of the gathered lane equal the paged lane's: "
        f"{same}")
    require(same, f"{arch}: LLM42 streams differ between the lanes")
    scout["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out[arch] = scout

    # llama4-scout-chunked8k: the same weights' first layers, window 8192
    long = configs.get_long_config(arch)
    ccfg = dataclasses.replace(long, num_layers=VARIANT_DEPTHS[long.name])
    cparams = dict(params, blocks={"0": {
        k: ({kk: vv[: ccfg.num_layers] for kk, vv in v.items()}
            if isinstance(v, dict) else v[: ccfg.num_layers])
        for k, v in params["blocks"]["0"].items()}})
    log(f"[variants] {long.name}: {ccfg.num_layers} of {long.num_layers} layers (the "
        f"first of the Scout weights), window {ccfg.window}, ring "
        f"{ccfg.window + RING_SLACK} slots")
    torch.cuda.reset_peak_memory_stats()
    out[long.name] = step("chunked8k serve", variant_serve, torch, ccfg, long.name,
                          cparams, results, lanes=("ring",), modes=(Mode.LLM42,),
                          prompts=(8300,), max_new=48, neighbours=1,
                          capacity=ccfg.window + RING_SLACK)
    out[long.name]["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, cparams
    fresh()

    # phi3-mini-3.8b-sw4k: dense, window 4096
    long = configs.get_long_config("phi3-mini-3.8b")
    cfg = dataclasses.replace(long, num_layers=VARIANT_DEPTHS[long.name])
    log(f"[variants] {long.name}: {cfg.num_layers} of {long.num_layers} layers, window "
        f"{cfg.window}, ring {cfg.window + RING_SLACK} slots, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, head_dim {cfg.hd}")
    params = step("phi3-sw4k weights", init_params, cfg,
                  torch.Generator(device=DEV).manual_seed(0), DEV)
    step("phi3-sw4k ring rows", ring_rows_invariant, torch, cfg, params)
    out[long.name] = step("phi3-sw4k serve", variant_serve, torch, cfg, long.name, params,
                          results, lanes=("ring",), modes=both, prompts=(4200, 4300),
                          max_new=64, neighbours=3, capacity=cfg.window + RING_SLACK)
    out[long.name]["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    fresh()

    out["llama3-8b-long-prefill"] = step("gathered long prefill", long_prefill_gathered,
                                         torch, results)
    fresh()
    for name, entry in out.items():
        peak = max(v["peak_mem_gib"] for v in entry.values()
                   if isinstance(v, dict) and "peak_mem_gib" in v) \
            if "peak_mem_gib" not in entry else entry["peak_mem_gib"]
        log(f"[variants] {name}: peak device memory {peak:.3f} GiB")
        for v in entry.values():
            if isinstance(v, dict):
                v.pop("streams", None)


# ---------------------------------------------------------------------------
# phase 9: families (first_k_dense head layers at head_dim 112; recurrent state)
# ---------------------------------------------------------------------------

#: the families phase's depth cuts, for memory: kimi-k2 at published widths
#: runs its dense head layer and one MoE layer (384 experts x 3 x 7168 x
#: 2048 bf16 = 33.8 GB, embeddings 4.7 GB: about 38.9 GB; a second MoE
#: layer would bring the weights to about 73 GB, before the pool and the
#: f32 expert casts); rwkv6-3b runs 8 of its 32 layers (all 32 take about
#: 6.1 GB; the cut keeps the whole script within its earlier length since
#: the cluster and training phases came)
FAMILY_DEPTHS = {"kimi-k2-1t-a32b": 2, "rwkv6-3b": 8}

#: the projections (K, N) each family's forward gives the GEMMs, besides
#: the LM head (``check_config_kernels``) and kimi's router and experts
#: (``check_moe_gemms``): kimi's wq / wo, wk / wv and dense FFN; rwkv's
#: r / k / v / g / o and cm_wr, the decay LoRA's two, cm_wk, cm_wv and its
#: unembedding; seamless's self and cross wq / wk / wv / wo (KV * hd =
#: d_model) and the FFN's gate / up and down, in the decoder and the encoder
FAMILY_PROJECTIONS = {
    "kimi-k2-1t-a32b": ((7168, 7168), (7168, 896), (7168, 2048), (2048, 7168)),
    "rwkv6-3b": ((2560, 2560), (2560, 64), (64, 2560), (2560, 8960), (8960, 2560),
                 (2560, 65536)),
    "seamless-m4t-medium": ((1024, 1024), (1024, 4096), (4096, 1024)),
}

#: batch sizes of the commit-schedule time_mix row check
RWKV_ROWS = (1, 3, 8, 13)


def check_projections(torch, arch, results, tag="families", encoder_m=None) -> None:
    """Both GEMMs at every (K, N) of ``FAMILY_PROJECTIONS[arch]`` in bf16:
    the commit GEMM (4 chunks) at M in {1, 8, 32} within 2 bf16 ulps of
    max|ref| and its rows bitwise across M; the split-K GEMM at the demo
    policy's (M, splits) within 4 ulps.  ``encoder_m`` (an encoder's
    frames, whose build runs every projection in the commit GEMM at that
    M) adds the commit GEMM at M = ``encoder_m``, and the rows of M in
    ROW_MS are then held against that batch's."""
    from repro_torch.core.determinism import CANONICAL_TP_SHARDS
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk

    g = torch.Generator(device=DEV).manual_seed(18)
    worst = {"gemm_batch_invariant": 0.0, "gemm_splitk": 0.0}
    cases = ((1, 16), (8, 4), (32, 4)) + (((encoder_m, None),) if encoder_m else ())
    for K, N in FAMILY_PROJECTIONS[arch]:
        w = (torch.randn((K, N), generator=g, device=DEV) * K ** -0.5).to(torch.bfloat16)
        xb = torch.randn((max(200, encoder_m or 0), K), generator=g,
                         device=DEV).to(torch.bfloat16)
        for M, splits in cases:
            x = xb[:M].contiguous()
            checks = [("gemm_batch_invariant",
                       gemm_batch_invariant(x, w, chunks=CANONICAL_TP_SHARDS),
                       ref.gemm_batch_invariant(x, w, chunks=CANONICAL_TP_SHARDS), 2)]
            if splits:
                checks.append(("gemm_splitk",
                               gemm_splitk(x, w, splits=splits, combine_dtype="bfloat16"),
                               ref.gemm_splitk(x, w, splits, "bfloat16"), 4))
            for name, out, want, ulps in checks:
                err = float((out.float() - want.float()).abs().max())
                tol = ulps * ulp_of(float(want.float().abs().max()), 7)
                require(err <= tol, f"{arch}: {name} ({M},{K})@({K},{N}) disagrees: "
                        f"{err} > {tol}")
                worst[name] = max(worst[name], err)
        commit_rows_invariant(torch, gemm_batch_invariant, xb, w, CANONICAL_TP_SHARDS)
    ms = tuple(M for M, _ in cases)
    log(f"[{tag}] {arch} projections {FAMILY_PROJECTIONS[arch]} bf16: the commit GEMM "
        f"(4 chunks) at M in {ms} within 2 bf16 ulps (max_abs_err "
        f"{worst['gemm_batch_invariant']:.3e}), rows bitwise for M in {ROW_MS} against "
        f"the {xb.shape[0]}-row batch's; split-K at 16 / 4 / 4 splits within 4 ulps "
        f"(max_abs_err {worst['gemm_splitk']:.3e})")
    for name, e in worst.items():
        results[name].setdefault("max_abs_err_by_config", {})[f"{arch} projections"] = e


def time_family_attention(torch, cfg, arch, results) -> None:
    """The three attention kernels at the config's heads, at the headline
    and serve shapes, beside their plain versions and bounds (and
    ``sdpa`` for ``decode_attention``), as the timings phase times them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_fast

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    kw = dict(kv_splits=4, combine_dtype="bfloat16")
    for label, inp in paged_shapes(torch, cfg, ("headline", "serve")).items():
        time_paged_case(torch, cfg, results, scratch.zero_, "paged_attention",
                        f"{arch} {label}", inp, lambda: paged_attention(*inp[:6]),
                        lambda: ref.paged_attention(*inp[:6]), tag="families")
        time_paged_case(torch, cfg, results, scratch.zero_, "paged_attention_fast",
                        f"{arch} {label}, kv_splits=4",
                        inp, lambda: paged_attention_fast(*inp[:6], **kw),
                        lambda: ref.paged_attention_fast(*inp[:6], **kw), tag="families")
    time_decode_attention(torch, cfg, results, scratch.zero_, names=("headline", "serve"),
                          prefix=f"{arch} ", tag="families")
    del scratch


def rwkv_rows_invariant(torch, cfg, params) -> dict:
    """``time_mix`` (layer 0's weights, one token, random shift and wkv
    state) under the commit schedule gives each row the same bits (output,
    shift and state) at B in RWKV_ROWS; prints whether the step's
    ``einsum`` would (the reason the commit path sums by fixed trees) and
    how far the two sums lie apart."""
    from repro_torch.core.determinism import (
        VERIFY_SCHEDULE, _pairwise_sum, deterministic_torch,
    )
    from repro_torch.models import rwkv6

    g = torch.Generator(device=DEV).manual_seed(19)
    N, D, hd = max(RWKV_ROWS), cfg.d_model, cfg.rwkv_head_dim
    H, dt = D // hd, getattr(torch, cfg.dtype)
    lp = {k: v[0] for k, v in params["blocks"]["0"]["rwkv"].items()}
    x = torch.randn((N, 1, D), generator=g, device=DEV).to(dt)
    prev = torch.randn((N, D), generator=g, device=DEV).to(dt)
    wkv = 0.3 * torch.randn((N, H, hd, hd), generator=g, device=DEV)
    with deterministic_torch():
        outs = {B: rwkv6.time_mix(lp, cfg, x[:B], prev[:B], wkv[:B], VERIFY_SCHEDULE)
                for B in RWKV_ROWS}
        r = torch.randn((N, H, hd), generator=g, device=DEV)
        a = 0.3 * torch.randn((N, H, hd, hd), generator=g, device=DEV)
        tree = {B: _pairwise_sum(r[:B, :, :, None] * a[:B], axis=-2) for B in RWKV_ROWS}
        ein = {B: torch.einsum("bhk,bhkv->bhv", r[:B], a[:B]) for B in RWKV_ROWS}
    sync(torch)
    same = all(torch.equal(outs[B][i], outs[N][i][:B]) for B in RWKV_ROWS
               for i in range(3))
    tree_same = all(torch.equal(tree[B], tree[N][:B]) for B in RWKV_ROWS)
    ein_same = all(torch.equal(ein[B], ein[N][:B]) for B in RWKV_ROWS)
    drift = max(float((ein[B] - ein[N][:B]).abs().max()) for B in RWKV_ROWS)
    err = float((tree[N] - ein[N]).abs().max())
    log(f"[families] {cfg.name} time_mix (W = 1) under the commit schedule: rows "
        f"(output, shift, wkv state) bitwise identical for B in {RWKV_ROWS}: {same}; the "
        f"step's fixed-tree contraction alone {tree_same}; its einsum {ein_same} (rows "
        f"move by up to {drift:.3e} with B); fixed tree vs einsum max_abs_err {err:.3e}")
    require(bool(torch.isfinite(outs[N][0].float()).all()), "time_mix: non-finite output")
    require(same and tree_same, f"{cfg.name}: time_mix rows change with B")
    require(err <= 1e-4, f"{cfg.name}: the fixed-tree contraction disagrees with einsum")
    return dict(rows_bitwise=same, einsum_rows_bitwise=ein_same, einsum_drift=drift,
                tree_vs_einsum=err)


def recurrent_depth(torch, cfg, params, results, phase="families") -> dict:
    """The counterpart of the JAX ``TestRecurrentDepth`` (rwkv at full
    width in the families phase, jamba-smoke in the hybrid phase):
    LLM42 under the pause scheduler, then under an overlap scheduler at
    spec_depth 2 with a 20 ms verify latency (the costed clock), 4 requests
    (2 deterministic) of 32 + 16 tokens under the demo's fast path; the
    overlap run must commit the pause run's deterministic streams with the
    state pool at depth 2 or more.  Launches held to the passes."""
    from repro_torch.core.determinism import Mode, ReductionPolicy
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, SamplingParams
    from repro_torch.serving.scheduler import OverlapPolicy, PauseDecodePolicy

    policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                             combine_dtype="bfloat16")
    out, streams = {}, {}
    for name, kw in (("pause", dict(scheduler=PauseDecodePolicy())),
                     ("overlap depth 2", dict(scheduler=OverlapPolicy(), spec_depth=2,
                                              verify_latency_ms=20.0))):
        gc.collect()
        eng = Engine(cfg, params, mode=Mode.LLM42, policy=policy, window=5, group=2,
                     max_batch=8, capacity=CAPACITY, **kw)
        for rid in range(4):
            eng.submit(Request(rid=rid, prompt=[(5 * rid + 3 * k) % cfg.vocab_size
                                                for k in range(32)],
                               sampling=SamplingParams(max_new_tokens=16,
                                                       is_deterministic=rid in (0, 2),
                                                       seed=70 + rid)))
        sync(torch)
        fns = reset_launches()
        t0 = time.perf_counter()
        done = {r.rid: r for r in eng.run()}
        sync(torch)
        counts = {k: fn.launches for k, fn in fns.items()}
        require(counts == expected_launches(cfg, eng, eng._paged_fwd),
                f"{cfg.name} {name}: launches {counts}")
        for k, c in counts.items():
            results[k]["launches_by_mode"][f"{phase}/{cfg.name}/{name}"] = c
        streams[name] = {rid: done[rid].committed for rid in (0, 2)}
        out[name] = dict(iterations=eng._now, peak_depth=eng.statepool.peak_depth,
                         rollbacks=[done[r].num_rollbacks for r in range(4)],
                         seconds=time.perf_counter() - t0)
        log(f"[{phase}] {cfg.name} LLM42 {name}: {eng._now} iterations, state pool "
            f"peak depth {eng.statepool.peak_depth}, rollbacks by rid "
            f"{out[name]['rollbacks']}, launches {counts} (= the passes); "
            f"{out[name]['seconds']:.1f} s")
        del eng
    same = streams["pause"] == streams["overlap depth 2"]
    log(f"[{phase}] {cfg.name}: the overlap run at spec_depth 2 commits the pause "
        f"run's deterministic streams: {same}")
    require(same, f"{cfg.name}: spec_depth 2 changed the committed streams")
    require(out["overlap depth 2"]["peak_depth"] >= 2,
            f"{cfg.name}: the state pool never held two windows")
    return out


def phase_families(torch, results, summary) -> None:
    """kimi-k2 (MoE with a first_k_dense head layer, heads 64/8 of 112) at 2
    of 61 layers and rwkv6-3b (recurrent) at 8 of its 32 layers, published
    widths, random weights from seed 0."""
    from repro_torch import configs
    from repro_torch.core.determinism import Mode
    from repro_torch.models.base import init_params

    summary["families"] = out = {}
    both = (Mode.LLM42, Mode.BATCH_INVARIANT)

    def step(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        sync(torch)
        log(f"[families] step {name}: {time.perf_counter() - t0:.1f} s")
        return res

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        sync(torch)
        torch.cuda.reset_peak_memory_stats()

    # kimi-k2-1t-a32b: a dense head layer, then MoE; heads 64/8 (G = 8), D 112
    arch = "kimi-k2-1t-a32b"
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=FAMILY_DEPTHS[arch])
    log(f"[families] {arch}: {cfg.num_layers} of {full.num_layers} layers "
        f"(first_k_dense {cfg.first_k_dense}), d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} (group {cfg.num_heads // cfg.num_kv_heads}), "
        f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, {cfg.num_experts} experts top-{cfg.top_k}, "
        f"moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}")
    step("kimi kernels at G = 8, D = 112", check_config_kernels, torch, cfg, arch, results)
    step("kimi attention timings", time_family_attention, torch, cfg, arch, results)
    step("kimi projections", check_projections, torch, arch, results)
    gemms = step("kimi expert and router GEMMs", check_moe_gemms, torch, cfg, results)
    fresh()
    params = step("kimi weights", init_params, cfg,
                  torch.Generator(device=DEV).manual_seed(0), DEV)
    weights = torch.cuda.memory_allocated() / 2 ** 30
    layer_ms = step("kimi moe rows", moe_rows_invariant, torch, cfg, params)
    kimi = {"weights_gib": weights, "expert_gemms": gemms, "moe_layer_ms": layer_ms}
    kimi.update(step("kimi serve", variant_serve, torch, cfg, arch, params, results,
                     lanes=("paged", "gathered"), modes=both, prompts=(32, 32),
                     max_new=16, neighbours=3, capacity=CAPACITY, phase="families"))
    kimi.update(step("kimi nondet", variant_serve, torch, cfg, arch, params, results,
                     lanes=("paged",), modes=(Mode.NONDET,), prompts=(32, 32),
                     max_new=16, neighbours=3, capacity=CAPACITY, phase="families"))
    same = kimi["paged/llm42"]["streams"] == kimi["gathered/llm42"]["streams"]
    log(f"[families] {arch} LLM42 streams of the gathered lane equal the paged lane's: "
        f"{same}")
    require(same, f"{arch}: LLM42 streams differ between the lanes")
    kimi["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[families] {arch}: weights {weights:.3f} GiB, peak device memory "
        f"{kimi['peak_mem_gib']:.3f} GiB")
    out[arch] = kimi
    del params
    fresh()

    # rwkv6-3b: recurrent state, FAMILY_DEPTHS of 32 layers
    arch = "rwkv6-3b"
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=FAMILY_DEPTHS[arch])
    log(f"[families] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}")
    step("rwkv projections", check_projections, torch, arch, results)
    params = step("rwkv weights", init_params, cfg,
                  torch.Generator(device=DEV).manual_seed(0), DEV)
    weights = torch.cuda.memory_allocated() / 2 ** 30
    rwkv = {"weights_gib": weights}
    rwkv["time_mix_rows"] = step("rwkv rows", rwkv_rows_invariant, torch, cfg, params)
    rwkv.update(step("rwkv serve", variant_serve, torch, cfg, arch, params, results,
                     lanes=("state",), modes=both, prompts=(32, 32), max_new=16,
                     neighbours=3, capacity=CAPACITY, phase="families"))
    rwkv.update(step("rwkv nondet", variant_serve, torch, cfg, arch, params, results,
                     lanes=("state",), modes=(Mode.NONDET,), prompts=(32, 32),
                     max_new=16, neighbours=3, capacity=CAPACITY, phase="families"))
    rwkv["depth"] = step("rwkv depth", recurrent_depth, torch, cfg, params, results)
    rwkv["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[families] {arch}: weights {weights:.3f} GiB, peak device memory "
        f"{rwkv['peak_mem_gib']:.3f} GiB")
    out[arch] = rwkv
    del params
    fresh()
    for entry in out.values():
        for v in entry.values():
            if isinstance(v, dict):
                v.pop("streams", None)


# ---------------------------------------------------------------------------
# phase 10: modalities (encoder-decoder serving, prefix embeddings)
# ---------------------------------------------------------------------------

#: llava's depth cut (of 32 layers), which keeps the whole script's run
#: within its earlier length since the cluster and training phases came
LLAVA_DEPTH = 8

#: llava's per-request KV reach: its 2880 prefix positions, a 32-token
#: prompt, 16 new tokens and the verify rows fit 4096 (CAPACITY's 2048 do not)
PREFIX_CAPACITY = 4096

#: llava's prefill chunk sizes: both cut the 2880 prefix positions inside a
#: chunk (2880 = 5 x 512 + 320 = 2 x 1000 + 880), so that chunk holds prefix
#: embeds and prompt tokens
PREFIX_CHUNKS = (512, 1000)

#: batch sizes of the cross-attention W == 1 row check
CROSS_ROWS = (1, 3, 8, 13)

#: rows and context of the cross-gather timing: the serve runs' max_batch,
#: and their tracked requests' 32 + 16 tokens
CROSS_GATHER_B, CROSS_GATHER_CTX = 8, 48

#: the iteration after which the restore check preempts its tracked request
PREEMPT_AT = 6


def modal_decorate(torch, cfg):
    """``variant_serve``'s ``decorate`` for a modality config: each request's
    stub frontend output in the model dtype, from a generator seeded with
    its rid, so a tracked request carries the same embeddings alone and
    beside neighbours."""
    from repro_torch.models.multimodal import audio_frames, vision_embeds

    dt = getattr(torch, cfg.dtype)

    def decorate(req):
        g = torch.Generator(device=DEV).manual_seed(1000 + req.rid)
        if cfg.family == "encdec":
            req.enc_embeds = audio_frames(g, 1, cfg.encoder_seq_len, cfg.d_model,
                                          dtype=dt)
        if cfg.num_prefix_embeds:
            req.prefix_embeds = vision_embeds(g, 1, cfg.d_model, dtype=dt)[
                :, : cfg.num_prefix_embeds]
        return req

    return decorate


def modal_cross_kernels(torch, cfg, arch, results) -> None:
    """``decode_attention`` at the cross shape (``decode_shapes``' ``cross``:
    B = 8 over the 1024 encoder frames, every key valid, H = KV = 16, D = 64:
    G = 1) against its plain version at both DECODE_CASES, rows across B at
    one split, timed beside ``sdpa``; then the commit GEMM at the padded LM
    head (32, 1024) @ (1024, 256208), 4 chunks, timed beside
    ``torch.matmul`` (kernel, library, library, kernel) and its plain
    version, against its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.models.base import padded_vocab

    label = f"{arch} cross"
    inp = decode_shapes(torch, cfg, ("cross",))["cross"]
    worst = 0.0
    for splits, cd in DECODE_CASES:
        out, err = decode_case(torch, label, inp, splits, cd, phase="modalities")
        worst = max(worst, err)
    decode_rows_invariant(torch, label, inp, out, phase="modalities")
    results["decode_attention"].setdefault("max_abs_err_by_config", {})[label] = worst
    del inp, out
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    time_decode_attention(torch, cfg, results, scratch.zero_, names=("cross",),
                          prefix=f"{arch} ", tag="modalities")
    g = torch.Generator(device=DEV).manual_seed(21)
    M, K, N = 32, cfg.d_model, padded_vocab(cfg)
    x = torch.randn((M, K), generator=g, device=DEV).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=g, device=DEV) * K ** -0.5).to(torch.bfloat16)
    w[:, cfg.vocab_size:] = 0
    k1 = time_ms(torch, lambda: gemm_batch_invariant(x, w, chunks=4), flush=scratch.zero_)
    l1 = time_ms(torch, lambda: torch.matmul(x, w), flush=scratch.zero_)
    l2 = time_ms(torch, lambda: torch.matmul(x, w), flush=scratch.zero_)
    k2 = time_ms(torch, lambda: gemm_batch_invariant(x, w, chunks=4), flush=scratch.zero_)
    plain_ms = time_ms(torch, lambda: ref.gemm_batch_invariant(x, w, chunks=4), reps=5,
                       flush=scratch.zero_)
    ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
    b_ms, b_by = gemm_bound(M, K, N)
    shape = f"({M},{K})@({K},{N})"
    results["gemm_batch_invariant"].setdefault("shapes", {})[f"{arch} LM head {shape}"] = \
        dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"[modalities] gemm_batch_invariant {arch} padded LM head {shape} chunks=4: "
        f"{ms:.4f} ms (readings {k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms, "
        f"torch.matmul {lib_ms:.4f} ms ({l1:.4f}, {l2:.4f}), bound {b_ms:.4f} ms "
        f"({b_by}): {ms / lib_ms:.2f}x torch.matmul, {100 * b_ms / ms:.0f}% of the bound")
    del scratch, x, w


def modal_padded_unembed(torch, cfg, params) -> None:
    """The served unembedding is stored at the padded width with zero
    columns past the vocabulary; a forward's logits have ``vocab_size``
    columns, equal bitwise to the first columns of the padded GEMM."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE, matmul
    from repro_torch.models import transformer
    from repro_torch.models.base import padded_vocab

    un = params["unembed"]
    require(un.shape == (cfg.d_model, padded_vocab(cfg)) and
            not bool(un[:, cfg.vocab_size:].any()), "the unembedding is not padded")
    g = torch.Generator(device=DEV).manual_seed(23)
    x = torch.randn((3, 5, cfg.d_model), generator=g, device=DEV).to(un.dtype)
    full = matmul(x, un, VERIFY_SCHEDULE)
    cut = transformer._unembed(params, cfg, x, VERIFY_SCHEDULE)
    sync(torch)
    require(cut.shape[-1] == cfg.vocab_size and torch.equal(cut, full[..., :cfg.vocab_size])
            and not bool(full[..., cfg.vocab_size:].any()),
            "the padded LM head's logits are not the real columns")
    log(f"[modalities] {cfg.name} unembedding stored ({cfg.d_model}, {un.shape[1]}) with "
        f"{un.shape[1] - cfg.vocab_size} zero columns; logits cut to {cfg.vocab_size}, "
        f"equal to the padded GEMM's first columns, its padded columns exactly zero")


def modal_encoder(torch, cfg, params) -> dict:
    """One encoder build (``build_cross_cache``: the 12-layer encoder over
    1024 frames at B = 1 and 12 layers' cross K/V, under VERIFY_SCHEDULE):
    its launches (``encoder_gemms`` commit GEMMs, no attention kernel), its
    bits across builds, and its device time (CUDA events around one build,
    median of 5; the eager build's host launches included)."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE, deterministic_torch
    from repro_torch.models.multimodal import audio_frames
    from repro_torch.models.transformer import build_cross_cache

    g = torch.Generator(device=DEV).manual_seed(24)
    enc = audio_frames(g, 1, cfg.encoder_seq_len, cfg.d_model,
                       dtype=getattr(torch, cfg.dtype))
    with deterministic_torch():
        fns = reset_launches()
        first = build_cross_cache(params, cfg, enc, schedule=VERIFY_SCHEDULE)
        sync(torch)
        counts = {name: fn.launches for name, fn in fns.items()}
        want = {name: encoder_gemms(cfg) if name == "gemm_batch_invariant" else 0
                for name in counts}
        require(counts == want, f"encoder build: launches {counts}, want {want}")
        ms = time_ms(torch, lambda: build_cross_cache(params, cfg, enc), reps=5)
        again = build_cross_cache(params, cfg, enc, schedule=VERIFY_SCHEDULE)
    same = all(torch.equal(first[k], again[k]) for k in first)
    finite = bool(torch.isfinite(first["k"].float()).all() and
                  torch.isfinite(first["v"].float()).all())
    log(f"[modalities] {cfg.name} encoder build ({cfg.num_encoder_layers} layers over "
        f"{cfg.encoder_seq_len} frames, then {cfg.num_layers} layers' cross K/V "
        f"{tuple(first['k'].shape)}): {ms:.3f} ms (CUDA events, median of 5), "
        f"launches {counts}; builds bitwise equal {same}; finite {finite}")
    require(same and finite, f"{cfg.name}: encoder builds differ or are not finite")
    return dict(ms=ms, launches=counts["gemm_batch_invariant"])


def modal_cross_rows(torch, cfg, params) -> dict:
    """``cross_attention`` at W == 1 (layer 0's weights, random states and
    encoder K/V of 13 rows, every frame valid) under the commit schedule
    gives each row the same bits at B in CROSS_ROWS; prints whether
    ``_softmax_attend``'s ``einsum`` (the reference's path) would."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE, deterministic_torch
    from repro_torch.models import layers

    g = torch.Generator(device=DEV).manual_seed(22)
    N, Se, dt = max(CROSS_ROWS), cfg.encoder_seq_len, getattr(torch, cfg.dtype)
    KV, H, D = cfg.num_kv_heads, cfg.num_heads, cfg.hd
    lp = {k: v[0] for k, v in params["blocks"]["0"]["cross_attn"].items()}
    x = torch.randn((N, 1, cfg.d_model), generator=g, device=DEV).to(dt)
    k = torch.randn((N, Se, KV, D), generator=g, device=DEV).to(dt)
    v = torch.randn((N, Se, KV, D), generator=g, device=DEV).to(dt)
    mask = torch.ones((N, Se), dtype=torch.bool, device=DEV)
    q = torch.randn((N, 1, H, D), generator=g, device=DEV) * D ** -0.5
    with deterministic_torch():
        outs = {B: layers.cross_attention(lp, cfg, x[:B], k[:B], v[:B], mask[:B],
                                          VERIFY_SCHEDULE) for B in CROSS_ROWS}
        ein = {B: layers._softmax_attend(q[:B], k[:B], v[:B], mask[:B, None, :],
                                         VERIFY_SCHEDULE) for B in CROSS_ROWS}
    sync(torch)
    same = all(torch.equal(outs[B], outs[N][:B]) for B in CROSS_ROWS)
    ein_same = all(torch.equal(ein[B], ein[N][:B]) for B in CROSS_ROWS)
    drift = max(float((ein[B] - ein[N][:B]).abs().max()) for B in CROSS_ROWS)
    log(f"[modalities] {cfg.name} cross_attention (W = 1, decode_attention at one split) "
        f"under the commit schedule: rows bitwise identical for B in {CROSS_ROWS}: "
        f"{same}; _softmax_attend's einsum rows {ein_same} (move by up to {drift:.3e})")
    require(bool(torch.isfinite(outs[N].float()).all()), "cross_attention: non-finite")
    require(same, f"{cfg.name}: cross-attention rows change with B")
    return dict(rows_bitwise=same, einsum_rows_bitwise=ein_same, einsum_drift=drift)


def modal_cross_gather(torch, cfg, params) -> dict:
    """What the paged lane's row-packing of the cross leaves costs a decode
    pass: ``gather_mixed`` over CROSS_GATHER_B slots of a pool (seamless
    has no other slot leaves, so it copies each row's cross K and V of
    every layer, and the mask) beside one whole decode pass over those
    rows (``pool_forward`` at W = 1 under the commit schedule, the gather
    included, tables reaching CROSS_GATHER_CTX positions, every slot
    holding one encoder build), both timed by CUDA events (median, L2
    flushed between readings)."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE, deterministic_torch
    from repro_torch.models.multimodal import audio_frames
    from repro_torch.models.transformer import build_cross_cache
    from repro_torch.serving import blockpool
    from repro_torch.serving.kv_cache import CachePool, pool_forward

    B, ctx = CROSS_GATHER_B, CROSS_GATHER_CTX
    pool = CachePool(cfg, B, CAPACITY, device=torch.device(DEV))
    lay = pool.layout
    g = torch.Generator(device=DEV).manual_seed(25)
    enc = audio_frames(g, 1, cfg.encoder_seq_len, cfg.d_model, dtype=getattr(torch, cfg.dtype))
    nb = -(-ctx // lay.block_size)
    tables = torch.full((B, lay.blocks_per_table), -1, dtype=torch.int32, device=DEV)
    tables[:, :nb] = torch.arange(B * nb, dtype=torch.int32, device=DEV).reshape(B, nb)
    start = torch.full((B,), ctx - 1, dtype=torch.int32, device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=DEV,
                           dtype=torch.int32)
    idx = torch.arange(B, device=DEV)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    with deterministic_torch():
        cross = build_cross_cache(params, cfg, enc, schedule=VERIFY_SCHEDULE)
        for slot in range(B):
            pool.data = blockpool.write_cross(pool.data, slot, cross)
        gather_ms = time_ms(torch, lambda: blockpool.gather_mixed(pool.data, lay, idx),
                            reps=50, flush=scratch.zero_)
        pass_ms = time_ms(torch, lambda: pool_forward(
            params, cfg, lay, pool.data, list(range(B)), tables, start, VERIFY_SCHEDULE,
            paged=True, tokens=tokens), reps=20, flush=scratch.zero_)
    row_bytes = sum(leaf[:, 0].numel() * leaf.element_size()
                    for leaf in pool.data["cross"].values())
    moved = 2 * B * row_bytes  # each row read once and written once
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"[modalities] {cfg.name} cross gather at B = {B} (gather_mixed: "
        f"{row_bytes / 2 ** 20:.1f} MiB a row, {moved / 2 ** 20:.1f} MiB read and written): "
        f"{gather_ms:.4f} ms (bound {b_ms:.4f} ms, bytes); one paged decode pass at "
        f"W = 1 over those rows, the gather included: {pass_ms:.4f} ms; the gather is "
        f"{100 * gather_ms / pass_ms:.1f} % of the pass (CUDA events, medians)")
    del scratch, pool, cross
    return dict(batch=B, gather_ms=gather_ms, pass_ms=pass_ms, row_mib=row_bytes / 2 ** 20,
                bound_ms=b_ms, share=gather_ms / pass_ms)


def modal_restore(torch, cfg, arch, params, results, decorate) -> dict:
    """Paged LLM42, the two tracked requests and one neighbour, under the
    demo's fast path: once unpressured, once with tracked request 0
    preempted after iteration PREEMPT_AT.  The restore rebuilds its cross
    cache bitwise equal to the first build's, and both tracked streams equal
    the unpressured run's.  Launches held to the passes."""
    from repro_torch.core.determinism import Mode

    def run(preempt):
        gc.collect()
        eng = tracked_engine(cfg, params, Mode.LLM42, (32, 32), 16, decorate=decorate,
                             neighbours=1, capacity=CAPACITY)
        fns = reset_launches()
        saved, slot, rebuilt = None, None, None
        while eng.step():
            if preempt and eng._now == PREEMPT_AT:
                victim = next(r for r in eng.running if r.rid == 0)
                slot = victim.slot
                saved = {n: t[:, slot].clone() for n, t in eng.pool.data["cross"].items()}
                require(eng.preempt(victim), "the tracked request was not preempted")
            if saved is not None and rebuilt is None and eng.num_restores:
                rebuilt = all(torch.equal(eng.pool.data["cross"][n][:, slot], saved[n])
                              for n in saved)
        sync(torch)
        counts = {name: fn.launches for name, fn in fns.items()}
        require(counts == expected_launches(cfg, eng, True),
                f"{arch} restore run: launches {counts}")
        done = {r.rid: r for r in eng.finished}
        return {rid: done[rid].committed for rid in (0, 1)}, eng, rebuilt, counts

    base, _, _, _ = run(False)
    got, eng, rebuilt, counts = run(True)
    for name, c in counts.items():
        results[name]["launches_by_mode"][f"modalities/{arch}/restore"] = c
    same = got == base
    log(f"[modalities] {arch} paged LLM42, request 0 preempted after iteration "
        f"{PREEMPT_AT}: {eng.num_preemptions} preemption(s), {eng.num_restores} "
        f"restore(s), {eng.num_cross_builds} encoder builds; the restore's cross cache "
        f"bitwise the first build's: {rebuilt}; streams equal the unpressured run's: "
        f"{same}; launches {counts} (= the passes)")
    require(eng.num_preemptions == 1 and eng.num_restores == 1, f"{arch}: no restore")
    require(bool(rebuilt), f"{arch}: the restore's cross cache differs from the first")
    require(same, f"{arch}: the restored streams differ from the unpressured run's")
    return dict(streams_equal=same, cross_rebuilt_bitwise=bool(rebuilt),
                iterations=eng._now)


def modal_prefix_chunks(torch, cfg, arch, params, results, decorate) -> dict:
    """llava's two tracked requests (32-token prompts after the 2880 prefix
    embeds) in paged LLM42, prefilled exclusively and in chunks of each of
    PREFIX_CHUNKS: every run commits the exclusive run's streams, and a
    chunk of each chunked run holds both prefix and prompt positions."""
    from repro_torch.core.determinism import Mode

    P = cfg.num_prefix_embeds
    streams, out = {}, {}
    for chunk in (0,) + PREFIX_CHUNKS:
        gc.collect()
        t0 = time.perf_counter()
        eng = tracked_engine(cfg, params, Mode.LLM42, (32, 32), 16, decorate=decorate,
                             capacity=PREFIX_CAPACITY, prefill_chunk=chunk)
        fns = reset_launches()
        done = {r.rid: r for r in eng.run()}
        sync(torch)
        counts = {name: fn.launches for name, fn in fns.items()}
        require(counts == expected_launches(cfg, eng, True),
                f"{arch} prefill chunk {chunk}: launches {counts}")
        for name, c in counts.items():
            results[name]["launches_by_mode"][f"modalities/{arch}/chunk {chunk}"] = c
        chunks = [ev for ev in engine_events(eng) if ev["kind"] == "prefill_chunk"]
        straddle = any(ev["start"] < P < ev["start"] + ev["tokens"] for ev in chunks)
        require(bool(chunks) == (chunk > 0) and straddle == (chunk > 0),
                f"{arch} prefill chunk {chunk}: chunks {[(e['start'], e['tokens']) for e in chunks]}")
        streams[chunk] = {rid: done[rid].committed for rid in (0, 1)}
        out[f"chunk {chunk}"] = dict(iterations=eng._now, prefill_chunks=len(chunks),
                                     seconds=time.perf_counter() - t0)
        log(f"[modalities] {arch} paged LLM42, prefill chunk {chunk or 'exclusive'}: "
            f"{len(chunks)} chunk passes (one holds prefix and prompt: {straddle}), "
            f"{eng._now} iterations, launches {counts} (= the passes); "
            f"{out[f'chunk {chunk}']['seconds']:.1f} s")
        del eng
    same = all(streams[c] == streams[0] for c in PREFIX_CHUNKS)
    log(f"[modalities] {arch}: chunked prefill at {PREFIX_CHUNKS} commits the exclusive "
        f"prefill's streams: {same}")
    require(same and all(len(s) == 16 for s in streams[0].values()),
            f"{arch}: chunked prefill changed the committed streams")
    out["identical"] = same
    return out


def phase_modalities(torch, results, summary) -> None:
    """seamless-m4t-medium (encoder-decoder, 12 + 12 layers, full depth)
    and llava-next-mistral-7b (2880 prefix embeds, LLAVA_DEPTH of 32
    layers) at published widths, random weights from seed 0, stub frontend
    embeddings from ``models/multimodal.py``."""
    from repro_torch import configs
    from repro_torch.core.determinism import Mode
    from repro_torch.models.base import init_params

    summary["modalities"] = out = {}
    both = (Mode.LLM42, Mode.BATCH_INVARIANT)

    def step(name, fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        sync(torch)
        log(f"[modalities] step {name}: {time.perf_counter() - t0:.1f} s")
        return res

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        sync(torch)
        torch.cuda.reset_peak_memory_stats()

    def serve(cfg, arch, params, decorate, capacity):
        res = step(f"{arch} serve", variant_serve, torch, cfg, arch, params, results,
                   lanes=("paged", "gathered"), modes=both, prompts=(32, 32),
                   max_new=16, neighbours=3, capacity=capacity, phase="modalities",
                   decorate=decorate)
        res.update(step(f"{arch} nondet", variant_serve, torch, cfg, arch, params, results,
                        lanes=("paged",), modes=(Mode.NONDET,), prompts=(32, 32),
                        max_new=16, neighbours=3, capacity=capacity, phase="modalities",
                        decorate=decorate))
        same = res["paged/llm42"]["streams"] == res["gathered/llm42"]["streams"]
        log(f"[modalities] {arch} LLM42 streams of the gathered lane equal the paged "
            f"lane's: {same}")
        require(same, f"{arch}: LLM42 streams differ between the lanes")
        return res

    # seamless-m4t-medium: encoder-decoder, heads 16/16 of 64, vocab 256206
    arch = "seamless-m4t-medium"
    cfg = configs.get_config(arch)
    log(f"[modalities] {arch}: {cfg.num_encoder_layers} encoder + {cfg.num_layers} "
        f"decoder layers, {cfg.encoder_seq_len} encoder frames, d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}")
    step("seamless kernels at G = 1, D = 64", check_config_kernels, torch, cfg, arch,
         results)
    step("seamless cross kernels and LM head", modal_cross_kernels, torch, cfg, arch,
         results)
    step("seamless projections", check_projections, torch, arch, results, tag="modalities",
         encoder_m=cfg.encoder_seq_len)
    fresh()
    params = step("seamless weights", init_params, cfg,
                  torch.Generator(device=DEV).manual_seed(0), DEV)
    weights = torch.cuda.memory_allocated() / 2 ** 30
    seam = {"weights_gib": weights}
    step("seamless padded unembedding", modal_padded_unembed, torch, cfg, params)
    seam["encoder"] = step("seamless encoder", modal_encoder, torch, cfg, params)
    seam["cross_rows"] = step("seamless cross rows", modal_cross_rows, torch, cfg, params)
    seam["cross_gather"] = step("seamless cross gather", modal_cross_gather, torch, cfg,
                                params)
    decorate = modal_decorate(torch, cfg)
    seam.update(serve(cfg, arch, params, decorate, CAPACITY))
    seam["restore"] = step("seamless restore", modal_restore, torch, cfg, arch, params,
                           results, decorate)
    seam["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[modalities] {arch}: weights {weights:.3f} GiB, peak device memory "
        f"{seam['peak_mem_gib']:.3f} GiB")
    out[arch] = seam
    del params
    fresh()

    # llava-next-mistral-7b: 2880 prefix embeds, Mistral-7B heads 32/8 of 128
    arch = "llava-next-mistral-7b"
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=LLAVA_DEPTH)
    log(f"[modalities] {arch}: {cfg.num_layers} layers, {cfg.num_prefix_embeds} prefix "
        f"embeds, d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; reach "
        f"{PREFIX_CAPACITY}")
    params = step("llava weights", init_params, cfg,
                  torch.Generator(device=DEV).manual_seed(0), DEV)
    weights = torch.cuda.memory_allocated() / 2 ** 30
    llava = {"weights_gib": weights}
    decorate = modal_decorate(torch, cfg)
    llava.update(serve(cfg, arch, params, decorate, PREFIX_CAPACITY))
    llava["chunks"] = step("llava chunked prefill", modal_prefix_chunks, torch, cfg, arch,
                           params, results, decorate)
    llava["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[modalities] {arch}: weights {weights:.3f} GiB, peak device memory "
        f"{llava['peak_mem_gib']:.3f} GiB")
    out[arch] = llava
    del params
    fresh()
    for entry in out.values():
        for v in entry.values():
            if isinstance(v, dict):
                v.pop("streams", None)


# ---------------------------------------------------------------------------
# phase 11: hybrid (jamba: mamba layers, the stacked block period)
# ---------------------------------------------------------------------------

HYBRID_ARCH = "jamba-1.5-large-398b"
#: batch sizes and pass widths of the mamba row check at jamba's widths
MAMBA_ROWS = (1, 7, 32)
MAMBA_WS = (1, 8)
#: the decode batch the mamba layer is timed at
MAMBA_TIME_B = 8
#: KV reach of the jamba-smoke engine runs (its max_seq_len)
HYBRID_CAPACITY = 512


def mamba_weights(torch, cfg):
    """One mamba layer's weights at ``cfg``'s widths and dtype, drawn as
    ``init_params`` draws a leaf (seed 0)."""
    from repro_torch.models.base import _fill, mamba_specs

    gen = torch.Generator(device=DEV).manual_seed(0)
    out = {}
    for name, spec in sorted(mamba_specs(cfg).items()):
        out[name] = torch.empty(spec.shape, dtype=getattr(torch, cfg.dtype), device=DEV)
        _fill(out[name], spec, gen)
    return out


def mamba_rows(torch, cfg, results) -> dict:
    """``mamba_layer`` at jamba's published widths (d_model 8192, d_inner
    16384, d_state 16, d_conv 4, dt_rank 512; bf16) from a random state
    under VERIFY_SCHEDULE: at each W of MAMBA_WS the rows of ``out`` and of
    both per-position state leaves at every B of MAMBA_ROWS must be the bits
    of the same rows at the largest B.  Then its device time at B =
    MAMBA_TIME_B, W = 1 under the commit schedule and the fast path's, with
    its launches per call (its 4 projections), beside the least time of its
    bytes (weights, state read and written, x and out) and products."""
    from repro_torch.core.determinism import FAST_PATH_POLICY, VERIFY_SCHEDULE
    from repro_torch.models import mamba

    p = mamba_weights(torch, cfg)
    g = torch.Generator(device=DEV).manual_seed(1)
    dt = getattr(torch, cfg.dtype)
    di, ds, dc, D = cfg.d_inner, cfg.d_state, cfg.d_conv, cfg.d_model
    big = max(MAMBA_ROWS)
    out = {}
    for W in MAMBA_WS:
        x = torch.randn((big, W, D), generator=g, device=DEV).to(dt)
        conv = torch.randn((big, dc - 1, di), generator=g, device=DEV).to(dt)
        ssm = 0.3 * torch.randn((big, di, ds), generator=g, device=DEV)
        full = None
        for B in sorted(MAMBA_ROWS, reverse=True):
            st = {"conv": conv[:B].clone(), "ssm": ssm[:B].clone()}
            y, _, pp = mamba.mamba_layer(p, cfg, x[:B], st, VERIFY_SCHEDULE, True)
            got = (y, pp["conv"], pp["ssm"])
            require(all(bool(torch.isfinite(t.float()).all()) for t in got),
                    f"mamba_layer W={W} B={B}: non-finite values")
            if full is None:
                full = got
                continue
            for name, a, b in zip(("out", "conv", "ssm"), got, full):
                require(torch.equal(a, b[:B]), f"mamba_layer W={W}: {name} rows at "
                        f"B={B} differ from B={big}")
        sync(torch)
        log(f"[hybrid] mamba_layer ({cfg.name} widths: d_model {D}, d_inner {di}, "
            f"d_state {ds}, d_conv {dc}, dt_rank {max(D // 16, 1)}, {cfg.dtype}) W={W} "
            f"under VERIFY_SCHEDULE: out and per-position conv and ssm rows bitwise "
            f"equal for B in {MAMBA_ROWS}")
        out[f"rows_W{W}"] = True
        del x, conv, ssm, full, y, pp, got
    B = MAMBA_TIME_B
    x = torch.randn((B, 1, D), generator=g, device=DEV).to(dt)
    st = mamba.init_state(cfg, B, dt, DEV)
    st["ssm"].normal_(generator=g)
    weight_bytes = sum(t.numel() * t.element_size() for t in p.values())
    state_bytes = sum(t.numel() * t.element_size() for t in st.values())
    dt_rank = max(D // 16, 1)
    flops = 2.0 * B * (D * 2 * di + di * (dt_rank + 2 * ds) + dt_rank * di + di * D)
    b_ms, b_by = bound(weight_bytes + 2 * state_bytes + 2 * x.numel() * 2, flops)
    for name, sched in (("commit", VERIFY_SCHEDULE),
                        ("fast", FAST_PATH_POLICY.schedule_for(B))):
        fns = reset_launches()
        mamba.mamba_layer(p, cfg, x, st, sched)
        sync(torch)
        counts = {k: c for k, c in launch_counts(fns).items() if c}
        record_launches(results, f"hybrid/mamba_layer/{name}", launch_counts(fns),
                        main_path=False)
        ms = time_ms(torch, lambda: mamba.mamba_layer(p, cfg, x, st, sched), reps=50)
        out[f"ms_{name}"] = ms
        log(f"[hybrid] mamba_layer B={B} W=1 {name} schedule ({tuple(sched)[:3]}): "
            f"{ms:.4f} ms device time (median of 50, CUDA events), launches per call "
            f"{counts}; bound {b_ms:.4f} ms ({b_by}: {weight_bytes / 2 ** 20:.0f} MiB of "
            f"weights), {100 * b_ms / ms:.0f}% of it")
    out["bound_ms"] = b_ms
    del p
    return out


def hybrid_restore(torch, cfg, params, results) -> dict:
    """Paged LLM42, the two tracked requests and one neighbour, once
    unpressured and once with tracked request 0 preempted after iteration
    PREEMPT_AT (its KV blocks freed, its slot's mamba state wiped for the
    replay): both tracked streams must equal the unpressured run's.
    Launches held to the passes."""
    from repro_torch.core.determinism import Mode

    def run(preempt):
        gc.collect()
        eng = tracked_engine(cfg, params, Mode.LLM42, (32, 32), 16, neighbours=1,
                             capacity=HYBRID_CAPACITY)
        fns = reset_launches()
        while eng.step():
            if preempt and eng._now == PREEMPT_AT:
                victim = next(r for r in eng.running if r.rid == 0)
                require(eng.preempt(victim), "the tracked request was not preempted")
        sync(torch)
        counts = launch_counts(fns)
        require(counts == expected_launches(cfg, eng, True),
                f"{cfg.name} restore run: launches {counts}")
        done = {r.rid: r for r in eng.finished}
        return {rid: done[rid].committed for rid in (0, 1)}, eng, counts

    base, _, _ = run(False)
    got, eng, counts = run(True)
    for name, c in counts.items():
        results[name]["launches_by_mode"][f"hybrid/{cfg.name}/restore"] = c
    same = got == base
    log(f"[hybrid] {cfg.name} paged LLM42, request 0 preempted after iteration "
        f"{PREEMPT_AT}: {eng.num_preemptions} preemption(s), {eng.num_restores} "
        f"restore(s), state pool preempts {eng.statepool.num_preempts}; streams equal "
        f"the unpressured run's: {same}; launches {counts} (= the passes)")
    require(eng.num_preemptions == 1 and eng.num_restores == 1, f"{cfg.name}: no restore")
    require(same, f"{cfg.name}: the restored streams differ from the unpressured run's")
    return dict(streams_equal=same, iterations=eng._now)


def phase_hybrid(torch, results, summary) -> None:
    """jamba-1.5-large-398b: ``mamba_rows`` at its published widths (one
    period of 8 layers holds about 90 GB of bf16 weights, more than the
    card's 80 GB, so no engine runs at that width on one card); then the
    jamba-smoke engine (4 layers, attention every 2nd, 4 experts, f32;
    random weights from seed 0): the tracked greedy and seeded requests'
    LLM42 and BATCH_INVARIANT streams alone and beside 3 neighbours on both
    lanes, the lanes equal (NONDET printed), overlap at spec_depth 2 with a
    20 ms verify latency equal to pause (``recurrent_depth``), and a
    preempted and restored request (``hybrid_restore``); launches held to
    the passes."""
    from repro_torch import configs
    from repro_torch.core.determinism import Mode
    from repro_torch.models.base import init_params

    full = configs.get_config(HYBRID_ARCH)
    summary["hybrid"] = out = {}
    out["mamba"] = mamba_rows(torch, full, results)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_smoke_config(HYBRID_ARCH)
    log(f"[hybrid] {cfg.name}: {cfg.num_layers} layers (block period "
        f"{cfg.block_period()}: {[cfg.layer_kind(i) + '/' + cfg.ffn_kind(i) for i in range(cfg.num_layers)]}), "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
        f"{cfg.num_experts} experts top-{cfg.top_k}, d_state {cfg.d_state}, {cfg.dtype}")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    both = (Mode.LLM42, Mode.BATCH_INVARIANT)
    smoke = variant_serve(torch, cfg, cfg.name, params, results,
                          lanes=("paged", "gathered"), modes=both, prompts=(32, 32),
                          max_new=16, neighbours=3, capacity=HYBRID_CAPACITY,
                          phase="hybrid")
    smoke.update(variant_serve(torch, cfg, cfg.name, params, results, lanes=("paged",),
                               modes=(Mode.NONDET,), prompts=(32, 32), max_new=16,
                               neighbours=3, capacity=HYBRID_CAPACITY, phase="hybrid"))
    same = smoke["paged/llm42"]["streams"] == smoke["gathered/llm42"]["streams"]
    log(f"[hybrid] {cfg.name} LLM42 streams of the gathered lane equal the paged lane's: "
        f"{same}")
    require(same, f"{cfg.name}: LLM42 streams differ between the lanes")
    smoke["depth"] = recurrent_depth(torch, cfg, params, results, phase="hybrid")
    smoke["restore"] = hybrid_restore(torch, cfg, params, results)
    for v in smoke.values():
        if isinstance(v, dict):
            v.pop("streams", None)
    out[cfg.name] = smoke
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: distribution (tp_matmul over torch.distributed, the dry run)
# ---------------------------------------------------------------------------

#: Llama-3-8B's row-parallel GEMM widths (K, N): q/o, k/v, gate/up, the LM
#: head, down
TP_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (4096, 128256), (14336, 4096))
TP_MS = (1, 8, 32)
#: the dry-run cases the phase runs on the card's host (every arch at
#: decode_32k, verify_32k where DRYRUN_BUDGET_S allows); kimi-k2's run
#: alone (its 384 experts a layer are about 10^5 meta ops a pass) takes
#: the ``dryrun_kimi`` phase, outside the default run
DRYRUN_SHAPES = ("decode_32k", "verify_32k")
DRYRUN_BUDGET_S = 30.0
DRYRUN_SLOW = ("kimi-k2-1t-a32b",)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_programs(torch, x, w, d, pinned=True):
    """The d ranks of ``distributed.sharding.tp_matmul`` at VERIFY_SCHEDULE
    run one after another in this process, through tp_matmul's own parts:
    each rank's local subtree is ``tp_rank_partial`` (its K slice's
    ``4 / d`` chunk partials from ``gemm_batch_invariant_partials``,
    ``tree_combine``), then ``tp_butterfly`` runs its levels with an exchange
    that hands over the partner's value entering the level (what
    ``batch_isend_irecv`` carries between ranks).  Returns each rank's result
    in x's dtype.  ``pinned=False`` combines the ranks' values in bf16 in
    ring order instead (the un-pinned schedule's all-reduce, the negative
    control)."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE
    from repro_torch.distributed.sharding import tp_butterfly, tp_rank_partial

    accs = [tp_rank_partial(x, w, r, d, VERIFY_SCHEDULE) for r in range(d)]
    if not pinned:
        acc = accs[0].to(torch.bfloat16)
        for a in accs[1:]:
            acc = acc + a.to(torch.bfloat16)
        return [acc.to(x.dtype)] * d

    def entering(r, step):  # rank r's value entering the level ``step``
        return tp_butterfly(accs[r], r, step, lambda _a, p, s: entering(p, s))

    return [entering(r, d).to(x.dtype) for r in range(d)]


def distribution_tp(torch, results, summary) -> None:
    """``tp_matmul``'s fallback on a world-size-1 NCCL group (d = 1: the
    logical path, no collective), and the d = 2 and 4 rank programs through
    tp_matmul's own parts, bitwise against the logical commit GEMM at
    Llama-3-8B's widths."""
    import torch.distributed as dist

    from repro_torch.core.determinism import VERIFY_SCHEDULE, Schedule
    from repro_torch.distributed.sharding import tp_matmul
    from repro_torch.kernels import ops
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.launch.mesh import make_host_mesh

    gen = torch.Generator(device=DEV).manual_seed(12)
    cases = []
    for K, N in TP_SHAPES:
        w = (torch.randn((K, N), generator=gen, device=DEV) * K ** -0.5).to(torch.bfloat16)
        for M in TP_MS:
            cases.append((M, K, N, torch.randn((M, K), generator=gen, device=DEV)
                          .to(torch.bfloat16), w))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_host_mesh(model=1, device="cuda")
        fns = reset_launches()
        for M, K, N, x, w in cases:
            got = tp_matmul(x, w, mesh)
            require(torch.equal(got, ops.matmul(x, w, VERIFY_SCHEDULE)),
                    f"distribution: tp_matmul fallback ({M}, {K}) @ ({K}, {N}) differs")
        sync(torch)
        record_launches(results, "distribution/tp_matmul fallback d=1",
                        launch_counts(fns), main_path=False)
    finally:
        dist.destroy_process_group()
    log(f"[distribution] tp_matmul's fallback on a DeviceMesh over an NCCL group of "
        f"world size 1 (d = 1: the logical matmul, no collective call): equal to "
        f"ops.matmul(VERIFY_SCHEDULE) at {len(cases)} shapes (K, N) in {TP_SHAPES} x M "
        f"in {TP_MS}, bf16; NCCL at d > 1 takes one card a rank: the distribution4 "
        "phase (four cards, --phases build,distribution4)")
    fns = reset_launches()
    worst = {}
    for M, K, N, x, w in cases:
        want = gemm_batch_invariant(x, w, chunks=4)
        for d in (2, 4):
            for r, got in enumerate(rank_programs(torch, x, w, d)):
                require(torch.equal(got, want), f"distribution: rank {r} of d={d} at "
                        f"({M}, {K}) @ ({K}, {N}) differs from the commit GEMM")
        tp1 = ops.matmul(x, w, Schedule())
        ring = rank_programs(torch, x, w, 4, pinned=False)[0]
        worst[(M, K, N)] = ((ring.float() - tp1.float()).abs().max().item(),
                            not torch.equal(ring, tp1))
    sync(torch)
    record_launches(results, "distribution/rank programs", launch_counts(fns),
                    main_path=False)
    log(f"[distribution] rank programs at d = 2 and 4 (sharding.tp_rank_partial: the "
        f"partials entry on each rank's K slice and its local subtree; "
        f"sharding.tp_butterfly): every rank bitwise the commit GEMM at "
        f"tp_shards 4 at all {len(cases)} shapes and M")
    for (M, K, N), (err, differs) in worst.items():
        log(f"[distribution] negative control ({M}, {K}) @ ({K}, {N}): un-pinned "
            f"d = 4 (bf16, ring order) vs tp 1: max |diff| {err:.4g}, "
            f"{'differs' if differs else 'equal'}")
    summary["distribution"] = {"unpinned_differs": sum(d for _, d in worst.values()),
                               "cases": len(cases)}
    timing = {}
    for K, N in TP_SHAPES:
        M = 8
        x = torch.randn((M, K), generator=gen, device=DEV).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=DEV) * K ** -0.5).to(torch.bfloat16)
        one = time_ms(torch, lambda: gemm_batch_invariant(x, w, chunks=4))
        four = time_ms(torch, lambda: rank_programs(torch, x, w, 4))
        timing[f"{K}x{N}"] = {"one_launch_ms": one, "d4_rank_programs_ms": four}
        log(f"[distribution] ({M}, {K}) @ ({K}, {N}): one four-chunk launch {one:.4f} ms; "
            f"the d = 4 rank programs (four quarter-K launches, subtrees, butterfly) "
            f"{four:.4f} ms (device time, CUDA events, median of 100)")
    summary["distribution"]["timing"] = timing


def dryrun_cases(torch, archs, shapes, budget_s, summary, key) -> None:
    """``launch.dryrun.run_case`` on both production meshes on this host
    (the meta device: no card memory, no kernel); no case may fail."""
    from repro_torch.launch import dryrun

    card = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    out = {}
    for shape in shapes:
        for arch in archs:
            if shape != shapes[0] and time.perf_counter() - t0 > budget_s:
                log(f"[distribution] dry run: {arch} {shape} left out (budget "
                    f"{budget_s:.0f} s spent)")
                continue
            for rec in dryrun.run_case(arch, shape, (False, True)):
                require(rec["status"] != "fail", f"dry run {arch} {shape} {rec['mesh']}: "
                        f"{rec.get('error')}")
                if rec["status"] == "skipped":
                    continue
                gib = rec["memory"]["argument_bytes"] / 2 ** 30
                out[f"{arch}/{shape}/{rec['mesh']}"] = dict(
                    run_s=rec["run_s"], flops=rec["flops"], argument_gib=gib)
                log(f"[distribution] dry run {arch:24s} {shape:11s} {rec['mesh']:16s} ok "
                    f"in {rec['run_s']:.1f} s: {rec['flops']:.3g} FLOPs, arguments "
                    f"{gib:.2f} GiB a rank (this card holds {card / 2 ** 30:.1f} GiB)")
    summary[key] = out
    log(f"[distribution] dry run: {len(out)} records, no fail, "
        f"{time.perf_counter() - t0:.1f} s")


def phase_distribution(torch, results, summary) -> None:
    """``distribution_tp``, then the dry run's decode_32k cases of every
    arch but ``DRYRUN_SLOW`` and its verify_32k cases as far as
    ``DRYRUN_BUDGET_S`` reaches."""
    from repro_torch import configs

    distribution_tp(torch, results, summary)
    inv = {v: k for k, v in configs.DASHED.items()}
    archs = [inv[a] for a in configs.list_archs() if inv[a] not in DRYRUN_SLOW]
    dryrun_cases(torch, archs, DRYRUN_SHAPES, DRYRUN_BUDGET_S, summary, "dryrun")


def phase_dryrun_kimi(torch, results, summary) -> None:
    """The dry run's decode_32k and verify_32k cases of ``DRYRUN_SLOW``."""
    dryrun_cases(torch, list(DRYRUN_SLOW), DRYRUN_SHAPES, float("inf"), summary,
                 "dryrun_kimi")


# ---------------------------------------------------------------------------
# optional phase: distribution4 (tp_matmul over NCCL, one card a rank)
# ---------------------------------------------------------------------------

#: ranks of the four-card phase, one card each
D4_RANKS = 4
#: model-axis widths: meshes (4, 1), (2, 2) and (1, 4)
D4_WIDTHS = (1, 2, 4)
#: the split schedules held across widths: (splits, combine_dtype), pinned,
#: tp_shards 4 (the reference's tp_matmul is bitwise across d at each)
D4_SPLITS = ((2, "bfloat16"), (2, "float32"), (8, "bfloat16"), (8, "float32"))
#: rows of the bf16 (tokens, 4096) activation all-reduce whose rate prices
#: the cost model's TP term: a decode pass of the serve driver's batch (8),
#: a prefill chunk (128), a long prefill (2048)
D4_TOKENS = (8, 128, 2048)
#: NCCL's timeout in each rank: a rank that stops answering fails the phase
D4_TIMEOUT_S = 120
#: the batch rows of the phase's timings (the serve driver's decode batch)
D4_TIME_M = 8


#: rounds of back-to-back calls a collective's reading takes the median of
D4_ROUNDS = 5
#: device clock cycles a collective's round holds the card asleep while the
#: host enqueues the round's calls (about 50 ms at 1.98 GHz: 20 calls of
#: up to 1.2 ms of host time each, PERF.md §6)
D4_HOLD_CYCLES = 100_000_000


def rank_time_ms(torch, dev, fn, reps, barrier=None):
    """``fn``'s time on this rank in ms (on the CPU the host clock).

    A local launch (``barrier`` None): the median over ``reps`` of CUDA
    events around one call after the timer's sleep (as ``time_ms``);
    returns that time.

    A collective (``barrier`` given): ``D4_ROUNDS`` rounds.  Each starts
    with ``barrier`` (the ranks meet), puts the card to sleep for
    ``D4_HOLD_CYCLES``, and enqueues one call (it absorbs the ranks'
    skew) and then ``reps // D4_ROUNDS`` calls between two events, so the
    card runs them back to back at its own pace, as a captured program
    would.  Returns (device ms a call, host ms a call to enqueue, held):
    the median rounds, and whether the card was still asleep when the last
    call was enqueued in every round (else the reading holds host time).
    Timed one call at a time, or back to back without the hold, a
    collective holds the host's time and jitter (PERF.md §6)."""
    def clock():
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def elapsed(a, b):
        if dev.type == "cuda":
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3

    for _ in range(3):
        fn()
    if barrier is None:
        times = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda._sleep(SLEEP_CYCLES)
            a = clock()
            fn()
            times.append(elapsed(a, clock()))
        return sorted(times)[reps // 2]
    calls = max(reps // D4_ROUNDS, 1)
    dev_ms, host_ms, held = [], [], True
    for _ in range(D4_ROUNDS):
        barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda._sleep(D4_HOLD_CYCLES)
            woke = clock()
        fn()
        a = clock()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms.append((time.perf_counter() - t0) * 1e3 / calls)
        if dev.type == "cuda":
            held &= not woke.query()
        dev_ms.append(elapsed(a, clock()) / calls)
    mid = D4_ROUNDS // 2
    return sorted(dev_ms)[mid], sorted(host_ms)[mid], held


def distribution4_rank(r, world, port, out_dir, device, shapes, ms, tokens, reps):
    """One rank of the ``distribution4`` phase (``torch.multiprocessing.spawn``
    target): bound to card r (``device == "cuda"``: NCCL) or the CPU (gloo,
    the plain kernel versions), it runs the phase's checks and timings at
    ``shapes`` (K, N) x ``ms`` and writes ``rank{r}.json`` to ``out_dir``:
    its timings, launch counts and, on rank 0, the checks' verdicts.  A
    failed check raises, which fails the spawn."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core.determinism import VERIFY_SCHEDULE, Schedule
    from repro_torch.distributed.sharding import (
        p2p_exchange, tp_butterfly, tp_matmul, tp_rank_partial,
    )
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.launch.mesh import make_host_mesh

    if device == "cuda":
        # the kernels launch on the current device: bind it before any CUDA
        # call, and load (never build) the libraries the parent built
        torch.cuda.set_device(r)
        dev = torch.device("cuda", r)
        missing = [s for s in ("gemm_batch_invariant", "gemm_splitk")
                   if not build.lib_path(s).exists()]
        require(not missing, f"distribution4 rank {r}: {missing} not built (the parent "
                "builds before spawning)")
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=r, timeout=datetime.timedelta(seconds=D4_TIMEOUT_S))
    out = {"rank": r, "device": str(dev)}
    try:
        bf = torch.bfloat16
        gen = torch.Generator(device=dev).manual_seed(12)
        cases = []
        for K, N in shapes:
            w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(bf)
            for M in ms:
                x = torch.randn((M, K), generator=gen, device=dev).to(bf)
                cases.append((M, K, N, x, w))
        for _, _, _, x, w in cases:  # every rank multiplies rank 0's operands
            for t in (x, w):
                dist.broadcast(t, src=0)
        meshes = {d: make_host_mesh(model=d, device=device) for d in D4_WIDTHS}
        fns = reset_launches()
        launches = dict.fromkeys(fns, 0)  # the tp_matmul calls' own

        def run(d, schedule, want=None):
            """tp_matmul over every case at width d; one launch a call, of
            the schedule's partials entry (the fallback at d = 1: its logical
            kernel); each result bitwise ``want``'s where given."""
            kernel = ("gemm_batch_invariant" if schedule.tp_pinned and schedule.splits <= 1
                      else "gemm_splitk")
            got = []
            for i, (M, K, N, x, w) in enumerate(cases):
                before = launch_counts(fns)
                y = tp_matmul(x, w, meshes[d], schedule=schedule)
                after = launch_counts(fns)
                diff = {k: after[k] - before[k] for k in after}
                require(diff == {k: int(k == kernel) for k in diff},
                        f"distribution4 rank {r} d={d} {schedule}: launches {diff}")
                launches[kernel] += 1
                if want is not None:
                    require(torch.equal(y, want[i]), f"distribution4 rank {r}: d={d} "
                            f"({M}, {K}) @ ({K}, {N}) {schedule} differs from the "
                            "one-card GEMM")
                got.append(y)
            return got

        def same_on_every_rank(got, what):
            flat = torch.cat([g.flatten() for g in got])
            every = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(every, flat)
            if r == 0:
                require(all(torch.equal(e, flat) for e in every),
                        f"distribution4: ranks hold other bits ({what})")

        verdicts = {}
        commit = [ops.matmul(x, w, VERIFY_SCHEDULE) for _, _, _, x, w in cases]
        for d in D4_WIDTHS:
            same_on_every_rank(run(d, VERIFY_SCHEDULE, commit), f"VERIFY_SCHEDULE d={d}")
        verdicts["pinned"] = len(cases) * len(D4_WIDTHS)
        for splits, cd in D4_SPLITS:
            sched = Schedule(splits=splits, combine_dtype=cd, tp_shards=4, tp_pinned=True)
            logical = [ops.matmul(x, w, sched) for _, _, _, x, w in cases]
            for d in D4_WIDTHS:
                same_on_every_rank(run(d, sched, logical), f"{sched} d={d}")
        verdicts["splits"] = len(cases) * len(D4_WIDTHS) * len(D4_SPLITS)
        fast = Schedule(splits=1, combine_dtype="bfloat16", tp_shards=4, tp_pinned=False)
        d1, d4, again = run(1, fast), run(4, fast), run(4, fast)
        same_on_every_rank(d4, "un-pinned d=4")
        differ = [not torch.equal(a, b) for a, b in zip(d1, d4)]
        verdicts.update(unpinned_differs=sum(differ),
                        unpinned_repeat_equal=all(torch.equal(a, b) for a, b in zip(d4, again)),
                        unpinned_max_diff=max(float((a.float() - b.float()).abs().max())
                                              for a, b in zip(d1, d4)))
        require(any(differ), "distribution4: the un-pinned d = 4 all-reduce equals d = 1 "
                "at every case (negative control)")
        out["launches"] = launches
        out["verdicts"] = verdicts

        world_group = dist.group.WORLD
        token = torch.zeros(1, device=dev)

        def barrier():
            dist.all_reduce(token, group=world_group)

        timing, host, held = {}, {}, True

        def collective(name, row, fn):
            nonlocal held
            dev_ms, host_ms, ok = rank_time_ms(torch, dev, fn, reps, barrier)
            row[name] = dev_ms
            host.setdefault(name, []).append(host_ms)
            held &= ok

        for K, N in shapes:
            x = torch.randn((D4_TIME_M, K), generator=gen, device=dev).to(bf)
            w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(bf)
            row = {"commit_ms": rank_time_ms(torch, dev, lambda: gemm_batch_invariant(
                x, w, chunks=4), reps)}
            row["partial_ms"] = rank_time_ms(torch, dev, lambda: tp_rank_partial(
                x, w, meshes[4].get_local_rank("model"), 4, VERIFY_SCHEDULE), reps)
            acc = torch.zeros((D4_TIME_M, N), device=dev)
            for d in (2, 4):
                group = meshes[d].get_group("model")
                coord = meshes[d].get_local_rank("model")
                step = 1
                while step < d:
                    collective(f"exchange_d{d}_step{step}_ms", row,
                               lambda: p2p_exchange(acc, group, coord ^ step))
                    step *= 2
                collective(f"tp_matmul_d{d}_ms", row, lambda: tp_matmul(x, w, meshes[d]))
                part = torch.zeros((D4_TIME_M, N), dtype=bf, device=dev)
                collective(f"allreduce_d{d}_ms", row,
                           lambda: dist.all_reduce(part, group=group))
            timing[f"{K}x{N}"] = row
        rates = {}
        for d in (2, 4):
            group = meshes[d].get_group("model")
            for n in tokens:
                act = torch.zeros((n, 4096), dtype=bf, device=dev)
                row = {}
                collective(f"allreduce_d{d}_tokens{n}_ms", row,
                           lambda: dist.all_reduce(act, group=group))
                rates[f"tp{d}_tokens{n}"] = {"ms": row[f"allreduce_d{d}_tokens{n}_ms"],
                                             "bytes": act.numel() * 2}
        out["host_ms"] = {k: sorted(v)[len(v) // 2] for k, v in host.items()}
        out["held"] = held
        out["timing"], out["allreduce"] = timing, rates
        barrier()  # no rank leaves while another still exchanges
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{r}.json").write_text(json.dumps(out))


def phase_distribution4(torch, results, summary) -> None:
    """``distributed.sharding.tp_matmul`` over NCCL with one card a rank: the
    kernels built here, then ``D4_RANKS`` spawned ranks (``distribution4_rank``)
    at the distribution phase's shapes; the ranks' timings merged (the
    maximum over ranks), the effective all-reduce rate computed as the cost
    model prices it (``serving/costmodel.py``: bytes x 2(tp - 1)/tp over the
    time), every reading printed beside the cards' names and power limits."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.kernels import build

    n = torch.cuda.device_count()
    require(n >= D4_RANKS, f"distribution4: {n} card(s) visible, the phase needs "
            f"{D4_RANKS} (one a rank)")
    build.build_all()  # a no-op after the build phase; the ranks only load
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    card = cards[0]
    for i, line in enumerate(cards):
        log(f"[distribution4] card {i}: {line}")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        t0 = time.perf_counter()
        mp.spawn(distribution4_rank, nprocs=D4_RANKS, join=True, args=(
            D4_RANKS, free_port(), out_dir, "cuda", TP_SHAPES, TP_MS, D4_TOKENS, 100))
        ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
                 for r in range(D4_RANKS)]
    log(f"[distribution4] {D4_RANKS} ranks (one card each, NCCL) in "
        f"{time.perf_counter() - t0:.1f} s")
    report_distribution4(ranks, card, results, summary)


def report_distribution4(ranks, card, results, summary) -> None:
    """Log and record the ranks' verdicts, launches and timings."""
    v = ranks[0]["verdicts"]
    log(f"[distribution4] VERIFY_SCHEDULE: every rank bitwise the four-chunk commit "
        f"GEMM on its own card and all ranks equal at d in {D4_WIDTHS}: {v['pinned']} "
        f"cases (K, N) in {TP_SHAPES} x M in {TP_MS} x d")
    log(f"[distribution4] split schedules (splits, combine) in {D4_SPLITS}, pinned: "
        f"every rank bitwise the logical split-K GEMM at every d: {v['splits']} cases")
    log(f"[distribution4] negative control, un-pinned bf16 all-reduce (tp_shards 4): "
        f"d = 4 differs from d = 1 at {v['unpinned_differs']} of "
        f"{v['pinned'] // len(D4_WIDTHS)} cases (max |diff| {v['unpinned_max_diff']:.4g}); "
        f"two d = 4 runs {'agree' if v['unpinned_repeat_equal'] else 'DISAGREE'} bit "
        f"for bit (printed, not asserted)")
    counts = {k: sum(rk["launches"][k] for rk in ranks) for k in ranks[0]["launches"]}
    record_launches(results, "distribution4/tp_matmul (4 ranks)", counts, main_path=False)
    log(f"[distribution4] launches over the 4 ranks, one a tp_matmul call: {counts}")
    timing = {}
    for key in ranks[0]["timing"]:
        row = {k: max(rk["timing"][key][k] for rk in ranks) for k in ranks[0]["timing"][key]}
        timing[key] = row
        parts = ", ".join(f"{k[:-3]} {t:.4f}" for k, t in row.items())
        K, N = key.split("x")
        log(f"[distribution4] ({D4_TIME_M}, {K}) @ ({K}, {N}) ms, max over ranks: "
            f"{parts} [{card}]")
    rates = {}
    for key in ranks[0]["allreduce"]:
        ms_ = max(rk["allreduce"][key]["ms"] for rk in ranks)
        nbytes = ranks[0]["allreduce"][key]["bytes"]
        tp = int(key[2:key.index("_")])
        rate = nbytes * 2 * (tp - 1) / tp / (ms_ * 1e-3)
        rates[key] = {"ms": ms_, "bytes": nbytes, "rate_bytes_per_s": rate}
        log(f"[distribution4] all_reduce bf16 ({key.split('tokens')[1]}, 4096) over "
            f"{tp} cards: {ms_:.4f} ms, {rate / 1e9:.2f} GB/s by the cost model's formula "
            f"(bytes x 2(tp-1)/tp / time) [{card}]")
    host = {k: max(rk["host_ms"][k] for rk in ranks) for k in ranks[0]["host_ms"]}
    held = all(rk["held"] for rk in ranks)
    log(f"[distribution4] collectives: device time a call back to back with the card "
        f"held while the host enqueues ({'held in every round' if held else 'NOT HELD in some round: those readings hold host time'}); "
        f"host ms a call to enqueue, median over the shapes, max over ranks: "
        + ", ".join(f"{k[:-3]} {t:.4f}" for k, t in host.items()))
    summary["distribution4"] = {"verdicts": v, "launches": counts, "timing": timing,
                                "allreduce": rates, "host_ms": host, "held": held,
                                "card": card}


# ---------------------------------------------------------------------------
# phase 13: cluster (replicas behind the deterministic router)
# ---------------------------------------------------------------------------

#: the cluster phase's config (the serve and train drivers' default arch),
#: at full width; each replica owns a KV pool of CLUSTER_CAPACITY positions
#: a slot (the serve driver's 512), the weights are shared
CLUSTER_ARCH, CLUSTER_CAPACITY = "tinyllama-1.1b", 512
#: its depth, 11 of 22 layers since the distribution phase came: at 22 the
#: default run did not fit 1200 s on a slow host (PERF.md section 4); the
#: H100 clock still prices the full config's passes, so the modeled traffic
#: and the diverts are those of 22 layers
CLUSTER_DEPTH = 11

#: the cluster phase's traffic: CLUSTER_REQUESTS prompts of a shared 2-block
#: prefix (32 tokens) and an 8-token tail, CLUSTER_MAX_NEW new tokens each,
#: arriving CLUSTER_GAP_S apart in modeled time, the even rids deterministic
#: (alternately greedy and seeded at temperature 0.8).  A tinyllama decode
#: pass costs about 0.7 ms on the H100 model (2.2 GB of weights), so a
#: request lives about 15-25 modeled ms and 4 ms gaps keep several in
#: flight: with ``imbalance=1`` the load guard diverts prefix hits
CLUSTER_REQUESTS, CLUSTER_MAX_NEW, CLUSTER_GAP_S = 12, 16, 0.004

#: (replicas, transfer policy) of the cluster runs; the last is run twice
CLUSTER_RUNS = ((1, "copy"), (2, "copy"), (2, "recompute"), (3, "copy"))
#: device memory the cluster phase may leave allocated above what it was
#: handed, once it dropped its engines and weights
CLUSTER_LEFT_MIB = 64


def cluster_requests(cfg):
    """Fresh request objects of the cluster traffic (CLUSTER_REQUESTS)."""
    import numpy as np

    from repro_torch.serving.request import Request, SamplingParams

    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab_size, 2 * BLOCK).tolist()
    tails = rng.integers(0, cfg.vocab_size, (CLUSTER_REQUESTS, 8)).tolist()
    return [Request(rid=i, prompt=prefix + tails[i], sampling=SamplingParams(
        max_new_tokens=CLUSTER_MAX_NEW, is_deterministic=i % 2 == 0, seed=70 + i,
        temperature=0.8 if i % 4 == 2 else 0.0)) for i in range(CLUSTER_REQUESTS)]


def copy_blocks_checked(torch, moves):
    """A ``blockpool.copy_blocks`` that times each copy with CUDA events and
    requires the moved rows of every paged leaf bitwise equal to the source
    rows on the device; appends (blocks, bytes, ms) to ``moves``."""
    from repro_torch.serving import blockpool

    real = blockpool.copy_blocks

    def checked(src, dst, lay, src_bids, dst_bids):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = real(src, dst, lay, src_bids, dst_bids)
        b.record()
        b.synchronize()
        nbytes = 0
        for s_leaf, d_leaf, kind in zip(blockpool._leaves(src), blockpool._leaves(out),
                                        blockpool._leaves(lay.kinds)):
            if kind == "paged":
                require(torch.equal(s_leaf[:, src_bids], d_leaf[:, dst_bids]),
                        "copy_blocks: moved rows differ from the source rows")
                nbytes += 2 * len(src_bids) * s_leaf[:, 0].numel() * s_leaf.element_size()
        moves.append((len(src_bids), nbytes, a.elapsed_time(b)))
        return out

    return real, checked


def cluster_run(torch, cfg, params, n, transfer, results, cost_cfg):
    """One ``cluster.run_online`` of the cluster traffic on the H100 clock
    (priced at ``cost_cfg``), each replica's step wrapped to attribute kernel launches (counts reset
    just before the run) and to sample its occupancy; each replica's
    launches must equal ``expected_launches`` of its own passes, and the
    merged trace must validate with one pid a replica."""
    from repro_torch.cluster import Cluster, run_online
    from repro_torch.core.determinism import Mode
    from repro_torch.serving import blockpool
    from repro_torch.serving.engine import Engine

    cluster = Cluster(lambda idx: Engine(cfg, params, mode=Mode.LLM42,
                                         capacity=CLUSTER_CAPACITY, trace=True),
                      n, transfer=transfer, imbalance=1)
    reqs = cluster_requests(cfg)
    per = [dict.fromkeys(KERNELS, 0) for _ in range(n)]
    occ = [[] for _ in range(n)]
    fns = reset_launches()
    for rep in cluster.replicas:
        def counted(rep=rep, step=rep.engine.step):
            before = {k: f.launches for k, f in fns.items()}
            out = step()
            for k, f in fns.items():
                per[rep.idx][k] += f.launches - before[k]
            occ[rep.idx].append(rep.occupancy)
            return out
        rep.engine.step = counted
    moves = []
    real, checked = copy_blocks_checked(torch, moves)
    blockpool.copy_blocks = checked
    try:
        sync(torch)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        t0 = time.perf_counter()
        res = run_online(cluster, cost_cfg, [(r, CLUSTER_GAP_S * r.rid) for r in reqs])
        b.record()
        b.synchronize()
    finally:
        blockpool.copy_blocks = real
    wall = time.perf_counter() - t0
    run = f"cluster/r{n}/{transfer}"
    counts = {k: f.launches for k, f in fns.items()}
    require(counts == {k: sum(p[k] for p in per) for k in KERNELS},
            f"{run}: launches outside the replicas' steps")
    for rep in cluster.replicas:
        want = expected_launches(cfg, rep.engine, True)
        require(per[rep.idx] == want, f"{run}: replica {rep.idx} launched "
                 f"{per[rep.idx]}, its passes imply {want}")
        del rep.engine.step  # the wrapper holds its engine: no cycle left behind
    record_launches(results, run, counts)
    trace = cluster.chrome_trace()  # validates, or raises
    require({e["pid"] for e in trace["traceEvents"]} == set(range(n)),
            f"{run}: merged trace pids")
    rt = cluster.router
    require(len(cluster.finished) == CLUSTER_REQUESTS, f"{run}: not drained")
    streams = {r.rid: tuple(r.committed) for r in cluster.finished
               if r.sampling.is_deterministic}
    info = dict(
        assignment=res.assignment, latencies=res.latencies, ttfts=res.ttfts,
        events=[[strip_wall(ev) for ev in rep.engine.events] for rep in cluster.replicas],
        streams=streams,
        router={k: getattr(rt, k) for k in ("assignments", "affinity_hits",
                                             "affinity_misses", "diverted", "transfers",
                                             "transferred_tokens")},
        throughput=res.throughput, goodput_1s=res.goodput(1.0), total_time=res.total_time,
        mean_occupancy=[sum(o) / max(len(o), 1) for o in occ],
        iterations=[len(o) for o in occ], moves=moves,
        device_s=a.elapsed_time(b) / 1e3, host_s=wall, launches=counts)
    moved = sum(m[0] for m in moves)
    log(f"[cluster] {run}: modeled fleet time {res.total_time * 1e3:.3f} ms, "
        f"throughput {res.throughput:.1f} tok/s, goodput {info['goodput_1s']:.1f} tok/s "
        f"at TTFT <= 1 s (modeled H100); router {info['router']}; assignment "
        f"{[res.assignment[i] for i in range(CLUSTER_REQUESTS)]}; mean occupancy "
        f"{['%.3f' % o for o in info['mean_occupancy']]} over "
        f"{info['iterations']} steps; {len(moves)} copy_blocks calls moved {moved} "
        f"blocks bitwise; launches {counts} (= each replica's passes); device time "
        f"{info['device_s']:.3f} s (CUDA events), host {wall:.1f} s")
    return info


def time_copy_blocks(torch, cfg, params, summary) -> None:
    """``blockpool.copy_blocks`` between two replicas' pools on one card at a
    2-block prefix (the cluster traffic's) and a 32-block one (512 tokens),
    beside the bytes it must move (read and write each paged row once);
    median of 100 calls (index tensors built per call, as the transfer
    builds them)."""
    from repro_torch.core.determinism import Mode
    from repro_torch.serving import blockpool
    from repro_torch.serving.engine import Engine

    src, dst = (Engine(cfg, params, mode=Mode.LLM42, capacity=CLUSTER_CAPACITY).pool
                for _ in range(2))
    lay = src.layout
    per_block = sum(leaf[:, 0].numel() * leaf.element_size()
                    for leaf, kind in zip(blockpool._leaves(src.data),
                                          blockpool._leaves(lay.kinds)) if kind == "paged")
    out = {}
    for nb in (2, 32):
        sb, db = list(range(nb)), list(range(nb, 2 * nb))
        ms = time_ms(torch, lambda: blockpool.copy_blocks(src.data, dst.data, lay, sb, db))
        nbytes = 2 * nb * per_block
        b_ms, b_by = bound(nbytes, 0.0)
        out[nb] = dict(ms=ms, bytes=nbytes, bound_ms=b_ms)
        log(f"[cluster] copy_blocks of {nb} blocks ({nbytes / 2 ** 20:.3f} MiB read and "
            f"written, {cfg.num_layers} layers' K, V and positions): {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.0f}% of it")
    summary["cluster"]["copy_blocks"] = out


def phase_cluster(torch, results, summary) -> None:
    """``cluster_runs``, with the device memory allocated read before it and
    after it, once everything it made is dropped.  Engines and clusters
    hold no reference cycles (their metrics gauges reach them through weak
    references, and the step wrappers this phase puts on the replicas are
    removed after each run), so a dropped engine frees its pool at once;
    the phase still collects before it reads, as a guard, not as the fix.
    At most CLUSTER_LEFT_MIB may stay."""
    gc.collect()
    held = torch.cuda.memory_allocated()
    log(f"[cluster] device memory allocated before the phase: {held / 2 ** 30:.3f} GiB")
    cluster_runs(torch, results, summary)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    summary["cluster"]["held_after_mib"] = (left - held) / 2 ** 20
    log(f"[cluster] device memory allocated after the phase, engines, replicas, "
        f"pools and weights dropped: {left / 2 ** 30:.3f} GiB ({(left - held) / 2 ** 20:.1f} "
        f"MiB above what the phase was handed; at most {CLUSTER_LEFT_MIB} MiB)")
    require(left - held <= CLUSTER_LEFT_MIB * 2 ** 20,
            "the cluster phase left device memory allocated")


def cluster_runs(torch, results, summary) -> None:
    """Replicas 1, 2 and 3 of one tinyllama engine (CLUSTER_DEPTH of 22
    layers, full width, random weights from seed 0) on one card, sharing
    the weights, each with its own paged pool, behind the deterministic
    router on the ``costmodel.H100`` clock at the full config
    (``imbalance=1``, so prefix hits divert): each
    deterministic request commits its solo stream at every replica count
    and under ``copy`` and ``recompute``; a second identical 3-replica run
    repeats the assignment, the modeled latencies and TTFTs and every
    replica's event log; the guard diverted and ``copy_blocks`` moved
    blocks, bitwise; each replica's launches equal its passes; the merged
    trace validates; then ``copy_blocks`` timed beside its bound."""
    from repro_torch import configs
    from repro_torch.core.determinism import Mode
    from repro_torch.models.base import init_params
    from repro_torch.serving.engine import Engine

    full = configs.get_config(CLUSTER_ARCH)
    cfg = dataclasses.replace(full, num_layers=CLUSTER_DEPTH)
    log(f"[cluster] {CLUSTER_ARCH}: {cfg.num_layers} of {full.num_layers} layers (priced "
        f"at {full.num_layers}), d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}, vocab {cfg.vocab_size}; "
        f"{CLUSTER_REQUESTS} requests of a 32-token shared prefix + 8 x "
        f"{CLUSTER_MAX_NEW} new tokens, {CLUSTER_GAP_S * 1e3:.0f} ms apart (modeled), "
        f"even rids deterministic; imbalance 1")
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    solo = {}
    for r in cluster_requests(cfg):
        if r.sampling.is_deterministic:
            eng = Engine(cfg, params, mode=Mode.LLM42, capacity=CLUSTER_CAPACITY)
            eng.submit(r)
            eng.run()
            solo[r.rid] = tuple(r.committed)
    summary["cluster"] = {}
    runs = {}
    for n, transfer in CLUSTER_RUNS + (CLUSTER_RUNS[-1],):
        gc.collect()
        info = cluster_run(torch, cfg, params, n, transfer, results, full)
        key = (n, transfer)
        if key in runs:  # the repeat
            first = runs[key]
            for f in ("assignment", "latencies", "ttfts", "events", "streams", "router"):
                require(info[f] == first[f], f"cluster r{n}/{transfer}: a second run "
                        f"changed its {f}")
            log(f"[cluster] r{n}/{transfer} again: the same assignment, latencies, "
                f"TTFTs, event logs and streams")
        runs[key] = info
        require(info["streams"] == solo, f"cluster r{n}/{transfer}: a deterministic "
                f"request's stream differs from its solo run")
        if n > 1:
            require(info["router"]["diverted"] >= 1, f"cluster r{n}/{transfer}: no divert")
            if transfer == "copy":
                require(info["router"]["transfers"] >= 1 and info["moves"],
                        f"cluster r{n}/{transfer}: no block transfer")
        summary["cluster"][f"r{n}/{transfer}"] = {
            k: v for k, v in info.items() if k not in ("events", "streams", "latencies",
                                                       "ttfts", "assignment")}
    log(f"[cluster] {len(solo)} deterministic streams identical alone and at 1, 2 and 3 "
        f"replicas under copy and recompute")
    time_copy_blocks(torch, cfg, params, summary)


# ---------------------------------------------------------------------------
# phase 14: training (forward_train, the GEMMs' backward, AdamW, checkpoints)
# ---------------------------------------------------------------------------

#: the training phase: tinyllama at full width and depth, TRAIN_STEPS
#: steps of TRAIN_B x TRAIN_S tokens from seed 0, AdamW (warmup 1 step,
#: cosine over TRAIN_STEPS), remat; saved after TRAIN_SAVE_AT and resumed
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_SAVE_AT, TRAIN_LR = 4, 512, 4, 2, 3e-4

#: M of the backward products' check: a step's token count and one that is
#: no multiple of 64 (nor of 8: dW's contraction is padded)
GRAD_MS = (TRAIN_B * TRAIN_S, 1003)

#: the backward products against the plain version's autograd, in bf16 ulps
#: of max |ref| (one f32 pass each; the two sum in their own orders)
GRAD_ULPS = 2

#: substrings of a library GEMM's kernel names (cuBLAS's gemm, sm90 xmma and
#: nvjet kernels, CUTLASS); the port's GEMM kernels carry one only in their
#: namespace, ``GEMM_NAMESPACE``, which is cut off before the match
LIBRARY_GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")
GEMM_NAMESPACE = "gemm_tile::"

#: (bucket, substrings of a kernel's name) for a training step's device time
STEP_BUCKETS = (
    ("commit GEMM", ("wgmma_partial_kernel", "fmaf_partial_kernel", "tree_combine_kernel",
                     "ordered_fold_kernel")),
    ("fills", ("FillFunctor",)),
    ("copies and casts", ("copy_kernel", "Memcpy", "memcpy")),
    ("library GEMM (f32 attention einsum)", LIBRARY_GEMM_MARKS),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
)

#: two microbatches' f32-summed gradients against one pass's, in bf16 ulps
#: of each leaf's max |g|: each microbatch's gradient is rounded to bf16 on
#: its own, and its attention runs at half the batch
MICRO_ULPS = 4


def train_gemm_launches(cfg, remat):
    """Commit-GEMM launches of one training step (one microbatch) of a
    config without head layers or an encoder: every forward GEMM
    (``forward_gemms``: a dense layer's 7, a hybrid block's attention and
    mamba layers' 4 and their FFNs' (3, or a MoE layer's router and 3 a
    expert), and the unembedding), the block layers' again in the
    recompute when ``remat`` (the unembedding is not rematerialized), and
    two backward products (one chunk each) for every forward GEMM, since
    every GEMM's input and weight need a gradient."""
    assert cfg.family in ("dense", "hybrid") and not cfg.first_k_dense
    fwd = sum(forward_gemms(cfg))
    return fwd + (fwd - 1 if remat else 0) + 2 * fwd


def commit_only(n):
    """Launch counts of a pass that runs the commit GEMM ``n`` times and no
    other kernel."""
    return {k: n if k == "gemm_batch_invariant" else 0 for k in KERNELS}


def check_backward_products(torch, cfg, results) -> None:
    """``ops.matmul``'s backward (``GemmGrad``) at tinyllama's projection
    shapes and LM head: dX = dY W^T and dW = X^T dY against the plain
    version's autograd on the card within GRAD_ULPS, at M in GRAD_MS; dX's
    rows bitwise across M; three commit-GEMM launches a call (the forward's
    4 chunks, two products of one) and no split-K launch; a profiler trace
    of one call holds the tensor-core tile and no library GEMM kernel; then
    each product timed beside ``torch.matmul`` on the same operands and its
    bound."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=DEV).manual_seed(30)
    bf = torch.bfloat16
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    rows, errs = [], []
    checked = dict.fromkeys(KERNELS, 0)
    for K, N in projections(cfg):
        Mx = max(GRAD_MS)
        x_all = torch.randn((Mx, K), generator=g, device=DEV).to(bf)
        w = (torch.randn((K, N), generator=g, device=DEV) * K ** -0.5).to(bf)
        dy_all = torch.randn((Mx, N), generator=g, device=DEV).to(bf)
        got = {}
        for M in GRAD_MS:
            x = x_all[:M].clone().requires_grad_(True)
            wk = w.clone().requires_grad_(True)
            fns = reset_launches()
            ops.matmul(x, wk, VERIFY_SCHEDULE).backward(dy_all[:M])
            counts = launch_counts(fns)
            require(counts == {k: 3 if k == "gemm_batch_invariant" else 0 for k in counts},
                    f"GemmGrad ({M},{K})@({K},{N}): launches {counts}")
            for k, c in counts.items():
                checked[k] += c
            xr = x_all[:M].clone().requires_grad_(True)
            wr = w.clone().requires_grad_(True)
            ref.gemm_batch_invariant(xr, wr, chunks=4).backward(dy_all[:M])
            for name, a, b in (("dX", x.grad, xr.grad), ("dW", wk.grad, wr.grad)):
                err = (a.float() - b.float()).abs().max().item()
                tol = GRAD_ULPS * ulp_of(b.float().abs().max().item(), 7)
                errs.append(err)
                require(err <= tol, f"GemmGrad {name} M={M} ({K},{N}): max abs err "
                        f"{err:.3e} > {tol:.3e}")
            got[M] = x.grad
        m0, m1 = GRAD_MS
        require(torch.equal(got[m1], got[m0][:m1]),
                f"GemmGrad dX rows change with M at ({K},{N})")
        if not rows:
            x, wk = x_all.clone().requires_grad_(True), w.clone().requires_grad_(True)
            names = trace_kernels(torch, lambda: ops.matmul(x, wk, VERIFY_SCHEDULE)
                                  .backward(dy_all))
            library = [n for n in names if any(
                m in n.replace(GEMM_NAMESPACE, "").lower() for m in LIBRARY_GEMM_MARKS)]
            require(any(TENSOR_CORE_TILE in n for n in names) and not library,
                    f"GemmGrad's trace: library GEMMs {library} among {sorted(names)}")
            log(f"[training] one GemmGrad forward + backward at ({Mx},{K})@({K},{N}) "
                f"launched {sorted(names)}: no library GEMM")
        M = m0
        dy, x = dy_all[:M].contiguous(), x_all[:M].contiguous()
        products = {
            "dX": (lambda: ops.grad_product(dy, w.t()),
                   lambda: ref.gemm_batch_invariant(dy, w.t().contiguous()),
                   lambda: torch.matmul(dy, w.t()), gemm_bound(M, N, K), w.t().contiguous(),
                   dy),
            "dW": (lambda: ops.grad_product(x.t(), dy),
                   lambda: ref.gemm_batch_invariant(x.t().contiguous(), dy),
                   lambda: torch.matmul(x.t(), dy), gemm_bound(K, M, N), dy,
                   x.t().contiguous()),
        }
        for name, (kern, plain, lib, (b_ms, b_by), b_op, a_op) in products.items():
            flush = scratch.zero_
            k1 = time_ms(torch, kern, flush=flush)
            l1 = time_ms(torch, lib, flush=flush)
            l2 = time_ms(torch, lib, flush=flush)
            k2 = time_ms(torch, kern, flush=flush)
            gemm_only = time_ms(torch, lambda: ops.gemm_batch_invariant(a_op, b_op, chunks=1),
                                flush=flush)
            plain_ms = time_ms(torch, plain, reps=10, flush=flush)
            ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
            rows.append(dict(product=name, M=M, K=K, N=N, ms=ms, gemm_only_ms=gemm_only,
                             library_ms=lib_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by))
            log(f"[training] backward {name} of ({M},{K})@({K},{N}): {ms:.4f} ms "
                f"(readings {k1:.4f}, {k2:.4f}; the commit GEMM alone on materialized "
                f"operands {gemm_only:.4f}), torch.matmul {lib_ms:.4f} ms ({l1:.4f}, "
                f"{l2:.4f}): {ms / lib_ms:.2f}x; plain {plain_ms:.4f} ms; bound "
                f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.0f}% of it")
        del x_all, w, dy_all
    record_launches(results, "training/backward check", checked, main_path=False)
    results["gemm_batch_invariant"]["backward"] = dict(max_abs_err=max(errs), rows=rows)
    log(f"[training] backward products: max abs err {max(errs):.3e} (within "
        f"{GRAD_ULPS} bf16 ulps), dX rows bitwise across M {GRAD_MS}")


def train_step_parts(torch, cfg, params, batch, opt_cfg, results, summary) -> None:
    """Where a training step's time and memory go: one more step (from
    ``params`` and a fresh optimizer state) run as ``train_step`` runs it,
    ``batch_grads`` then ``apply_updates``, with device memory read between
    them (held before the step, after the gradients and after the update;
    each half's peak by ``max_memory_allocated``); then the same step under
    ``torch.profiler``: device time by kernel, the commit GEMM's share, and
    the device's busy share of the step's wall time.  Both steps' launches
    are held to ``train_gemm_launches``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.optimizer import apply_updates, init_opt_state, tree_leaves
    from repro_torch.training.train import batch_grads, make_train_step

    gib = 2 ** 30
    want = commit_only(train_gemm_launches(cfg, True))
    n_params = sum(t.numel() for t in tree_leaves(params))
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    opt_state = init_opt_state(params)
    sync(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fns = reset_launches()
    grads, _ = batch_grads(params, cfg, batch)
    sync(torch)
    held_g, peak_g = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    new_p, new_o, _ = apply_updates(opt_cfg, params, grads, opt_state)
    sync(torch)
    held_u, peak_u = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    counts = launch_counts(fns)
    require(counts == want, f"training: the split step launched {counts}, not {want}")
    record_launches(results, "training/split step", counts)
    del grads, new_p, new_o
    mem = dict(params_gib=p_bytes / gib, f32_copy_gib=4 * n_params / gib,
               before_gib=base / gib, grads_peak_gib=peak_g / gib,
               after_grads_gib=held_g / gib, update_peak_gib=peak_u / gib,
               after_update_gib=held_u / gib)
    log(f"[training] memory of a step: params {mem['params_gib']:.3f} GiB ({cfg.dtype}), "
        f"one f32 copy of them {mem['f32_copy_gib']:.3f} GiB; held before the step "
        f"{mem['before_gib']:.3f} GiB (params, a fresh mu and nu, the batches); "
        f"gradients: peak {mem['grads_peak_gib']:.3f}, held after "
        f"{mem['after_grads_gib']:.3f} (+{(held_g - base) / gib:.3f}); update: peak "
        f"{mem['update_peak_gib']:.3f} (+{(peak_u - held_g) / gib:.3f} over the gradients), "
        f"held after {mem['after_update_gib']:.3f}")

    step_fn = make_train_step(cfg, opt_cfg)
    opt_state = init_opt_state(params)
    sync(torch)
    fns = reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        sync(torch)
        wall = time.perf_counter() - t0
    counts = launch_counts(fns)
    require(counts == want, f"training: the profiled step launched {counts}, not {want}")
    record_launches(results, "training/profiled step", counts)
    del out, opt_state
    t0 = time.perf_counter()
    averages = prof.key_averages()
    kernels = sorted(kernel_events(averages), key=lambda e: e.self_device_time_total,
                     reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    require(busy > 0, "training: the profiled step shows no device time")
    buckets = {name: [0.0, 0] for name, _ in STEP_BUCKETS + (("other", ()),)}
    for e in kernels:
        key = e.key.replace(GEMM_NAMESPACE, "")
        name = next((name for name, marks in STEP_BUCKETS
                     if any(m in key or m in key.lower() for m in marks)), "other")
        buckets[name][0] += e.self_device_time_total / 1e3
        buckets[name][1] += e.count
    log(f"[training] profiled step: host wall {wall * 1e3:.1f} ms under the profiler, "
        f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%) in "
        f"{sum(e.count for e in kernels)} device events; trace summed in "
        f"{time.perf_counter() - t0:.1f} s; by kernel name: " + ", ".join(
            f"{name} {ms:.2f} ms / {n}" for name, (ms, n) in buckets.items()))
    for e in kernels[:15]:
        log(f"[training] kernel {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d}x  {e.key[:100]}")
    ops_ = sorted((e for e in averages if e.key.startswith("aten::")
                   and e.device_time_total > 0),
                  key=lambda e: e.device_time_total, reverse=True)
    for e in ops_[:15]:
        log(f"[training] op device {e.device_time_total / 1e3:9.2f} ms cpu "
            f"{e.cpu_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:80]}")
    summary["training"].update(memory=mem, profiled_wall_ms=wall * 1e3,
                               profiled_busy_ms=busy, profiled_buckets=buckets,
                               top_kernels=[(e.key[:100], e.self_device_time_total / 1e3,
                                             e.count) for e in kernels[:15]])


#: the hybrid family's training at jamba-smoke (the published period does not
#: fit one card; one mamba layer at the published widths does): steps of
#: B x S tokens from seed 0
HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_STEPS = 4, 64, 4


def train_hybrid(torch, results, summary) -> None:
    """jamba-smoke (4 layers: attention and mamba in a block period of 2,
    MoE on every other layer; f32; random weights from seed 0):
    HYBRID_TRAIN_STEPS AdamW steps at HYBRID_TRAIN_B x HYBRID_TRAIN_S with
    remat, each step's launches held to ``train_gemm_launches``; a second
    run and a run with remat off bitwise equal in parameters, optimizer
    state and metrics; the loss finite; step time (CUDA events) and peak
    memory."""
    from repro_torch import configs
    from repro_torch.core.determinism import deterministic_torch
    from repro_torch.launch.train_launch import batch_on
    from repro_torch.models.base import init_params
    from repro_torch.training.data import SyntheticTextStream
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves
    from repro_torch.training.train import make_train_step, train_params

    cfg = configs.get_smoke_config(HYBRID_ARCH)
    B, S, steps = HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_STEPS
    params0 = train_params(cfg, init_params(
        cfg, torch.Generator(device=DEV).manual_seed(0), DEV))
    stream = iter(SyntheticTextStream(cfg.vocab_size, S, B, seed=0))
    batches = [batch_on(cfg, next(stream), i, torch.device(DEV)) for i in range(steps)]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)

    def run(remat, label):
        step_fn = make_train_step(cfg, opt_cfg, remat=remat)
        want = commit_only(train_gemm_launches(cfg, remat))
        params, opt_state = params0, init_opt_state(params0)
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        hist, times = [], []
        total = dict.fromkeys(KERNELS, 0)
        for i in range(steps):
            fns = reset_launches()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            params, opt_state, m = step_fn(params, opt_state, batches[i])
            b.record()
            b.synchronize()
            counts = launch_counts(fns)
            require(counts == want, f"training {cfg.name} {label} step {i + 1}: "
                    f"launches {counts}, the step implies {want}")
            for k, c in counts.items():
                total[k] += c
            times.append(a.elapsed_time(b))
            hist.append({k: v.clone() for k, v in m.items()})
            log(f"[training] {cfg.name} {label} step {i + 1}: loss "
                f"{float(m['loss']):.6f} gnorm {float(m['grad_norm']):.6f}; "
                f"{times[-1]:.1f} ms (CUDA events); launches {counts} (= the step's)")
        record_launches(results, f"training/{cfg.name} {label}", total)
        leaves = tree_leaves(params) + tree_leaves(opt_state.mu) + tree_leaves(opt_state.nu)
        return leaves, hist, times, torch.cuda.max_memory_allocated() / 2 ** 30

    with deterministic_torch():
        la, ha, ta, peak = run(True, "run 1")
        lb, hb, _, _ = run(True, "run 2")
        lc, hc, tc, _ = run(False, "remat off")
    for other, hist, label in ((lb, hb, "a second run"), (lc, hc, "remat off")):
        require(all(torch.equal(a, b) for a, b in zip(la, other)),
                f"training {cfg.name}: {label}'s parameters or optimizer state differ")
        require(all(torch.equal(ma[k], mb[k]) for ma, mb in zip(ha, hist) for k in ma),
                f"training {cfg.name}: {label}'s metrics differ")
    require(all(math.isfinite(float(m["loss"])) for m in ha),
            f"training {cfg.name}: a non-finite loss")
    median = sorted(ta)[len(ta) // 2]
    log(f"[training] {cfg.name}: run 2 and remat off bitwise run 1 (parameters, "
        f"optimizer state, metrics); step time median {median:.1f} ms with remat, "
        f"{sorted(tc)[len(tc) // 2]:.1f} ms without (CUDA events) -> "
        f"{B * S / median * 1e3:.0f} tok/s; peak device memory {peak:.3f} GiB")
    summary["training"]["hybrid"] = dict(
        arch=cfg.name, step_ms=ta, step_ms_no_remat=tc, peak_mem_gib=peak,
        loss=[float(m["loss"]) for m in ha],
        launches_per_step=train_gemm_launches(cfg, True))


def train_mamba_full_width(torch, results, summary) -> None:
    """One mamba layer at jamba-1.5-large's published widths (d_model 8192,
    d_inner 16384, d_state 16, d_conv 4, dt_rank 512; bf16; weights from
    seed 0) trained as ``forward_train`` trains it: ``x + mamba_layer(
    rms_norm(x))`` from the zero state under VERIFY_SCHEDULE, the loss an
    f32 sum against a fixed cotangent, autograd through the per-position
    loop (``GemmGrad``'s commit GEMMs), then the port's AdamW update of the
    layer's leaves; HYBRID_TRAIN_STEPS steps at HYBRID_TRAIN_B x
    HYBRID_TRAIN_S, with remat (``torch.utils.checkpoint``, not reentrant,
    as ``forward_train``'s) and without.  A repeat and the run without remat
    are bitwise the first in parameters, optimizer state and losses; every
    step's launches are its GEMMs' (4 forward, 4 again under remat, 8
    backward products); step time (CUDA events) and peak memory printed.
    The depth cut: one layer of the published 72 (the whole period does not
    fit one card)."""
    from repro_torch import configs
    from repro_torch.core.determinism import VERIFY_SCHEDULE, deterministic_torch
    from repro_torch.models import mamba
    from repro_torch.models.layers import rms_norm
    from repro_torch.training.optimizer import (
        AdamWConfig, apply_updates, init_opt_state, tree_leaves, tree_map,
    )
    from torch.utils.checkpoint import checkpoint

    cfg = configs.get_config(HYBRID_ARCH)
    B, S, steps = HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_STEPS
    dt = getattr(torch, cfg.dtype)
    params0 = {"norm0": torch.ones(cfg.d_model, dtype=dt, device=DEV),
               "mamba": mamba_weights(torch, cfg)}
    g = torch.Generator(device=DEV).manual_seed(3)
    xs = [torch.randn((B, S, cfg.d_model), generator=g, device=DEV).to(dt)
          for _ in range(steps)]
    cts = [torch.randn((B, S, cfg.d_model), generator=g, device=DEV) for _ in range(steps)]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)

    def layer(p, x):
        h = rms_norm(x, p["norm0"], cfg.norm_eps, VERIFY_SCHEDULE)
        return x + mamba.mamba_layer(p["mamba"], cfg, h, None, VERIFY_SCHEDULE)[0]

    def run(remat, label):
        want = commit_only(16 if remat else 12)
        params, opt_state = params0, init_opt_state(params0)
        sync(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        total = dict.fromkeys(KERNELS, 0)
        for i in range(steps):
            fns = reset_launches()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
            y = (checkpoint(layer, leaves, xs[i], use_reentrant=False) if remat
                 else layer(leaves, xs[i]))
            loss = (y.float() * cts[i]).sum()
            it = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
            grads = tree_map(lambda _: next(it), leaves)
            params, opt_state, _ = apply_updates(
                opt_cfg, tree_map(lambda v: v.detach(), leaves), grads, opt_state)
            b.record()
            b.synchronize()
            counts = launch_counts(fns)
            require(counts == want, f"training {cfg.name} mamba layer {label} step "
                    f"{i + 1}: launches {counts}, the step implies {want}")
            for k, c in counts.items():
                total[k] += c
            times.append(a.elapsed_time(b))
            losses.append(loss.detach())
        record_launches(results, f"training/{cfg.name} mamba layer {label}", total,
                        main_path=False)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        leaves = tree_leaves(params) + tree_leaves(opt_state.mu) + tree_leaves(opt_state.nu)
        return leaves, losses, times, peak

    with deterministic_torch():
        la, ha, ta, peak = run(True, "run 1")
        lb, hb, _, _ = run(True, "run 2")
        lc, hc, tc, peak_c = run(False, "remat off")
    for other, hist, label in ((lb, hb, "a second run"), (lc, hc, "remat off")):
        require(all(torch.equal(a, b) for a, b in zip(la, other)),
                f"training {cfg.name} mamba layer: {label}'s parameters or optimizer "
                "state differ")
        require(all(torch.equal(a, b) for a, b in zip(ha, hist)),
                f"training {cfg.name} mamba layer: {label}'s losses differ")
    require(all(math.isfinite(float(v)) for v in ha) and all(
        bool(torch.isfinite(t.float()).all()) for t in la),
        f"training {cfg.name} mamba layer: non-finite values")
    med, med_c = sorted(ta)[len(ta) // 2], sorted(tc)[len(tc) // 2]
    log(f"[training] {cfg.name} mamba layer at the published widths (d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, d_state {cfg.d_state}, dt_rank "
        f"{max(cfg.d_model // 16, 1)}, {cfg.dtype}; 1 of {cfg.num_layers} layers), "
        f"{steps} AdamW steps of {B} x {S}: run 2 and remat off bitwise run 1 "
        f"(parameters, optimizer state, losses); step time median {med:.1f} ms with "
        f"remat, {med_c:.1f} ms without (CUDA events); peak device memory above the "
        f"phase's {peak:.3f} GiB with remat, {peak_c:.3f} GiB without")
    summary["training"]["mamba_full_width"] = dict(
        step_ms=ta, step_ms_no_remat=tc, peak_mem_gib=peak, peak_mem_gib_no_remat=peak_c,
        loss=[float(v) for v in ha])


def phase_training(torch, results, summary) -> None:
    """``training.train`` on the card: the backward products
    (``check_backward_products``), then TRAIN_STEPS AdamW steps of
    tinyllama (22 layers, full width, random weights from seed 0) at
    TRAIN_B x TRAIN_S with remat, each step's launches held to
    ``train_gemm_launches`` (no split-K, no attention kernel), timed with
    CUDA events; a second run bitwise equal in parameters and metrics; the
    loss finite and lower on the first batch after the steps; remat=False
    gradients bitwise equal to remat's; two microbatches within MICRO_ULPS;
    saved after TRAIN_SAVE_AT steps and resumed, bitwise the uninterrupted
    run; then ``train_step_parts``; then the hybrid family's
    ``train_hybrid`` and ``train_mamba_full_width``.  Every step under ``deterministic_torch``; every
    pass's measured launches go into the kernels line."""
    from repro_torch import configs
    from repro_torch.core.determinism import deterministic_torch
    from repro_torch.launch.train_launch import batch_on
    from repro_torch.models.base import init_params
    from repro_torch.training import checkpoint
    from repro_torch.training.data import SyntheticTextStream
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_leaves
    from repro_torch.training.train import (
        batch_grads, lm_loss, loss_and_grads, make_train_step, train_params,
    )

    cfg = configs.get_config(TRAIN_ARCH)
    log(f"[training] {TRAIN_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B params, {cfg.dtype}; {TRAIN_STEPS} steps of "
        f"{TRAIN_B} x {TRAIN_S} tokens, AdamW lr {TRAIN_LR}, remat")
    summary["training"] = {}
    with deterministic_torch():
        check_backward_products(torch, cfg, results)
        params0 = train_params(cfg, init_params(
            cfg, torch.Generator(device=DEV).manual_seed(0), DEV))
        stream = iter(SyntheticTextStream(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
        batches = [batch_on(cfg, next(stream), i, torch.device(DEV))
                   for i in range(TRAIN_STEPS)]
        opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
        step_fn = make_train_step(cfg, opt_cfg)
        fwd = sum(forward_gemms(cfg))
        want = commit_only(train_gemm_launches(cfg, remat=True))
        ckpt = ROOT / "build" / "chip_smoke_train.npz"

        def run(params, opt_state, first, label, save_at=None):
            sync(torch)
            torch.cuda.reset_peak_memory_stats()
            hist, times = [], []
            total = dict.fromkeys(KERNELS, 0)
            for i in range(first, TRAIN_STEPS):
                fns = reset_launches()
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                params, opt_state, m = step_fn(params, opt_state, batches[i])
                b.record()
                b.synchronize()
                counts = launch_counts(fns)
                require(counts == want, f"training {label} step {i + 1}: launches "
                        f"{counts}, the step implies {want}")
                for k, c in counts.items():
                    total[k] += c
                ms = a.elapsed_time(b)
                times.append(ms)
                hist.append({k: v.clone() for k, v in m.items()})
                log(f"[training] {label} step {i + 1}: loss {float(m['loss']):.6f} gnorm "
                    f"{float(m['grad_norm']):.6f} lr {float(m['lr']):.3e}; {ms:.1f} ms "
                    f"(CUDA events) -> {TRAIN_B * TRAIN_S / ms * 1e3:.0f} tok/s; "
                    f"launches {counts} (= the step's)")
                if save_at == i + 1:
                    t0 = time.perf_counter()
                    checkpoint.save(str(ckpt), params, opt_state, step=i + 1)
                    log(f"[training] saved after step {i + 1}: "
                        f"{ckpt.stat().st_size / 2 ** 30:.2f} GiB in "
                        f"{time.perf_counter() - t0:.1f} s")
            record_launches(results, f"training/{label}", total)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            return params, opt_state, hist, times, peak

        t0 = time.perf_counter()
        pa, oa, ha, ta, peak = run(params0, init_opt_state(params0), 0, "run 1",
                                   save_at=TRAIN_SAVE_AT)
        log(f"[training] run 1: {time.perf_counter() - t0:.1f} s host; peak device "
            f"memory {peak:.3f} GiB")
        for i, m in enumerate(ha):
            require(all(bool(torch.isfinite(v).all()) for v in m.values()),
                    f"training step {i + 1}: non-finite metrics")
        pb, ob, hb, tb, _ = run(params0, init_opt_state(params0), 0, "run 2")
        require(all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb))),
                "training: a second run's parameters differ")
        require(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(oa.mu) + tree_leaves(oa.nu), tree_leaves(ob.mu) + tree_leaves(ob.nu))),
            "training: a second run's optimizer state differs")
        require(all(torch.equal(ma[k], mb[k]) for ma, mb in zip(ha, hb) for k in ma),
                "training: a second run's metrics differ")
        log("[training] run 2: parameters, optimizer state and metrics bitwise run 1's")
        del pb, ob
        rp, ro, rstep = checkpoint.restore(str(ckpt), params0, init_opt_state(params0))
        require(rstep == TRAIN_SAVE_AT, f"training: restored step {rstep}")
        pr, orr, hr, _, _ = run(rp, ro, TRAIN_SAVE_AT, "resumed")
        require(all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pr))),
                "training: the resumed run's parameters differ from the uninterrupted run's")
        require(all(torch.equal(ma[k], mb[k]) for ma, mb in zip(ha[TRAIN_SAVE_AT:], hr)
                    for k in ma), "training: the resumed run's metrics differ")
        log(f"[training] saved after step {TRAIN_SAVE_AT} and resumed: step "
            f"{TRAIN_STEPS} bitwise the uninterrupted run's")
        del rp, ro, pr, orr
        ckpt.unlink()
        fns = reset_launches()
        with torch.no_grad():
            b0 = batches[0]
            before, _ = lm_loss(params0, cfg, b0["tokens"], b0["targets"], b0["loss_mask"])
            after, _ = lm_loss(pa, cfg, b0["tokens"], b0["targets"], b0["loss_mask"])
        counts = launch_counts(fns)
        require(counts == commit_only(2 * fwd), f"training: two loss passes launched {counts}")
        record_launches(results, "training/loss", counts)
        require(math.isfinite(float(after)) and float(after) < float(before),
                f"training: the first batch's loss {float(before):.6f} -> {float(after):.6f}")
        log(f"[training] first batch's loss {float(before):.6f} -> {float(after):.6f} "
            f"after {TRAIN_STEPS} steps")
        del pa, oa
        fns = reset_launches()
        g_remat, _ = loss_and_grads(params0, cfg, batches[0], remat=True)
        g_plain, _ = loss_and_grads(params0, cfg, batches[0], remat=False)
        counts = launch_counts(fns)
        require(counts == commit_only(train_gemm_launches(cfg, True)
                                      + train_gemm_launches(cfg, False)),
                f"training: remat and plain gradient passes launched {counts}")
        record_launches(results, "training/gradients remat + plain", counts)
        require(all(torch.equal(a, b) for a, b in zip(tree_leaves(g_remat),
                                                      tree_leaves(g_plain))),
                "training: remat=False gradients differ from remat's")
        log("[training] remat=False gradients bitwise remat's")
        del g_plain
        fns = reset_launches()
        g_micro, _ = batch_grads(params0, cfg, batches[0], num_microbatches=2)
        counts = launch_counts(fns)
        require(counts == commit_only(2 * train_gemm_launches(cfg, True)),
                f"training: two microbatches launched {counts}")
        record_launches(results, "training/microbatches 2", counts)
        worst = 0.0
        for a, b in zip(tree_leaves(g_micro), tree_leaves(g_remat)):
            ulps = ((a.float() - b.float()).abs().max().item()
                    / ulp_of(b.float().abs().max().item(), 7))
            worst = max(worst, ulps)
        require(worst <= MICRO_ULPS, f"training: 2 microbatches' gradients {worst:.2f} "
                f"bf16 ulps from one pass's (limit {MICRO_ULPS})")
        log(f"[training] 2 microbatches: gradients within {worst:.3f} bf16 ulps of each "
            f"leaf's max |g| of one pass's (limit {MICRO_ULPS})")
        del g_micro, g_remat
        gc.collect()
        train_step_parts(torch, cfg, params0, batches[0], opt_cfg, results, summary)
    per_step = want["gemm_batch_invariant"]
    median_ms = sorted(ta)[len(ta) // 2]
    summary["training"].update(
        step_ms=ta, step_ms_run2=tb, median_step_ms=median_ms,
        tok_per_s=TRAIN_B * TRAIN_S / median_ms * 1e3, peak_mem_gib=peak,
        launches_per_step=per_step, micro_worst_ulps=worst,
        loss=[float(m["loss"]) for m in ha])
    log(f"[training] step time median {median_ms:.1f} ms (CUDA events) -> "
        f"{TRAIN_B * TRAIN_S / median_ms * 1e3:.0f} tok/s, peak device memory {peak:.3f} GiB, "
        f"{per_step} commit-GEMM launches a step (counted)")
    del params0
    gc.collect()
    torch.cuda.empty_cache()
    train_hybrid(torch, results, summary)
    train_mamba_full_width(torch, results, summary)


# ---------------------------------------------------------------------------
# phase 15: timings
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps=100, flush=None):
    """Device time of ``fn``: the median over ``reps`` launches, each timed
    by CUDA events around it.  ``flush`` runs between launches, outside the
    events; then the device sleeps about 0.1 ms, so the host has enqueued
    ``fn`` before the device reaches the first event and a reading holds no
    host delay (without it, readings of 0.015-0.025 ms moved by up to 30 %
    between two runs of 100 launches).  The median, because a launch
    enqueued later than the sleep still carries the host's delay."""
    for _ in range(3):
        fn()
    sync(torch)
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def phase_timings(torch, cfg, results) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk, gemm_splitk_partials

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEV).manual_seed(2)
    bf = torch.bfloat16
    D, F = cfg.d_model, cfg.d_ff
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)

    def flush():  # the weights of a layer are cold in L2 on the main path
        scratch.zero_()

    def gemm_row(name, M, K, N, kernel, plain, extra, into=None):
        x = torch.randn((M, K), generator=g, device=DEV).to(bf)
        w = (torch.randn((K, N), generator=g, device=DEV) * K ** -0.5).to(bf)
        # kernel, library, library, kernel: two readings of each in turns
        k1 = time_ms(torch, lambda: kernel(x, w), flush=flush)
        l1 = time_ms(torch, lambda: torch.matmul(x, w), flush=flush)
        l2 = time_ms(torch, lambda: torch.matmul(x, w), flush=flush)
        k2 = time_ms(torch, lambda: kernel(x, w), flush=flush)
        plain_ms = time_ms(torch, lambda: plain(x, w), reps=20, flush=flush)
        ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
        b_ms, b_by = gemm_bound(M, K, N)
        (results[name] if into is None else into).update(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
            shape=f"({M},{K})@({K},{N}) {extra}")
        log(f"[timings] {name} ({M},{K})@({K},{N}) {extra}: {ms:.4f} ms "
            f"(readings {k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms, "
            f"torch.matmul {lib_ms:.4f} ms ({l1:.4f}, {l2:.4f}), bound "
            f"{b_ms:.4f} ms ({b_by}): {ms / lib_ms:.2f}x torch.matmul, "
            f"{100 * b_ms / ms:.0f}% of the bound")

    # the verify pass's FFN down-projection and the decode batch's
    gemm_row("gemm_batch_invariant", 32, F, D,
             lambda x, w: gemm_batch_invariant(x, w, chunks=4),
             lambda x, w: ref.gemm_batch_invariant(x, w, chunks=4), "chunks=4")
    gemm_row("gemm_splitk", 8, F, D,
             lambda x, w: gemm_splitk(x, w, splits=4, combine_dtype="bfloat16"),
             lambda x, w: ref.gemm_splitk(x, w, 4, "bfloat16"),
             "splits=4 bf16 combine")
    # the same decode GEMM with the fast path at TP width 4 (Engine(tp=4))
    gemm_row("gemm_splitk TP fold", 8, F, D,
             lambda x, w: gemm_splitk(x, w, splits=4, combine_dtype="bfloat16",
                                      tp_shards=4),
             lambda x, w: ref.gemm_splitk(x, w, 4, "bfloat16", tp_shards=4),
             "tp=4 splits=4 bf16 combine",
             into=results["gemm_splitk"].setdefault("tp_fold", {}))
    # the partials entry at a rank's share of that GEMM in tp_matmul at d = 4
    # under a split schedule: one K chunk (d_ff / 4) at splits 8, f32 out
    gemm_row("gemm_splitk_partials", 8, F // 4, D,
             lambda x, w: gemm_splitk_partials(x, w, splits=8, combine_dtype="bfloat16"),
             lambda x, w: torch.stack(ref.gemm_splitk_partials(x, w, 8, "bfloat16")),
             "one chunk, splits=8 bf16 combine (a d = 4 rank's share)",
             into=results["gemm_splitk"]["tp_fold"].setdefault("partials", {}))
    time_gemm_table(torch, cfg, flush)
    time_gemm_host(torch, cfg)
    tiny = torch.zeros(1, device=DEV)
    log(f"[timings] timer floor: a one-element zero_ reads "
        f"{time_ms(torch, tiny.zero_, flush=flush):.4f} ms (launch and events)")
    time_paged_attention(torch, cfg, results, flush)
    time_decode_attention(torch, cfg, results, flush)
    time_rmsnorm(torch, cfg, results, flush)


def time_gemm_table(torch, cfg, flush) -> None:
    """Both GEMMs beside ``torch.matmul`` at every projection shape and at
    the M the serve runs use (commit: 8 in BATCH_INVARIANT decode, 32 in
    verify and in the 32-token prompts' prefill; split-K: 1, 4 and 8 with
    FAST_PATH_POLICY's splits), two readings of each in turns, then the
    GEMM device time of one forward (7 matmuls a layer and the
    unembedding, each weighted by its launches) against its bytes bound."""
    from repro_torch.core.determinism import CANONICAL_TP_SHARDS, FAST_PATH_POLICY
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk
    from repro_torch.serving.engine import _bucket

    g = torch.Generator(device=DEV).manual_seed(11)
    bf, L = torch.bfloat16, cfg.num_layers
    runs = {("commit", 8): "BATCH_INVARIANT decode at B=8",
            ("commit", 32): "verify, group 4 x window 8",
            ("splitk", 1): "fast decode at B=1", ("splitk", 4): "fast decode at B=4",
            ("splitk", 8): "fast decode at B=8"}
    prefill = ("commit", _bucket(32))  # one 32-token prompt a pass
    runs[prefill] = (runs[prefill] + "; " if prefill in runs else "") + \
        "prefill of a 32-token prompt"

    def kernel(kind, m):
        if kind == "commit":
            return lambda x, w: gemm_batch_invariant(x, w, chunks=CANONICAL_TP_SHARDS)
        s = FAST_PATH_POLICY.schedule_for(m)
        return lambda x, w: gemm_splitk(x, w, splits=s.splits,
                                        combine_dtype=s.combine_dtype)

    shapes = projections(cfg)
    per_forward = dict(zip(shapes, (2 * L, 2 * L, 2 * L, L, 1)))
    table, spreads = {}, []
    for K, N in shapes:
        w = (torch.randn((K, N), generator=g, device=DEV) * K ** -0.5).to(bf)
        for m in sorted({m for _, m in runs}):
            x = torch.randn((m, K), generator=g, device=DEV).to(bf)
            kinds = [kind for kind, mm in runs if mm == m]
            lib = [time_ms(torch, lambda: torch.matmul(x, w), flush=flush)]
            first = {kd: time_ms(torch, lambda: kernel(kd, m)(x, w), flush=flush)
                     for kd in kinds}
            second = {kd: time_ms(torch, lambda: kernel(kd, m)(x, w), flush=flush)
                      for kd in reversed(kinds)}
            lib.append(time_ms(torch, lambda: torch.matmul(x, w), flush=flush))
            lib_ms = sum(lib) / 2
            b_ms, _ = gemm_bound(m, K, N)
            for kd in kinds:
                ms = (first[kd] + second[kd]) / 2
                spread = abs(first[kd] - second[kd]) / ms
                spreads.append(spread)
                table[kd, m, K, N] = dict(ms=ms, library_ms=lib_ms, bound_ms=b_ms,
                                          spread=spread)
                log(f"[timings] gemm table {kd} M={m} ({K},{N}): {ms:.4f} ms "
                    f"(readings {first[kd]:.4f}, {second[kd]:.4f}), torch.matmul "
                    f"{lib_ms:.4f} ms ({lib[0]:.4f}, {lib[1]:.4f}): "
                    f"{ms / lib_ms:.2f}x; bound {b_ms:.4f} ms, "
                    f"{100 * b_ms / ms:.0f}% of it")
        del w
    log(f"[timings] gemm table: two readings of 100 launches each differ by at "
        f"most {100 * max(spreads):.1f}% (median "
        f"{100 * sorted(spreads)[len(spreads) // 2]:.1f}%)")
    forward = {}
    for (kd, m), what in runs.items():
        rows = {(K, N): table[kd, m, K, N] for K, N in shapes}
        tot = {key: sum(per_forward[kn] * r[key] for kn, r in rows.items())
               for key in ("ms", "library_ms", "bound_ms")}
        forward[f"{kd} M={m}"] = tot
        log(f"[timings] GEMM device time per forward, {kd} M={m} ({what}): "
            f"{tot['ms']:.3f} ms, torch.matmul {tot['library_ms']:.3f} ms "
            f"({tot['ms'] / tot['library_ms']:.2f}x), bytes bound "
            f"{tot['bound_ms']:.3f} ms ({100 * tot['bound_ms'] / tot['ms']:.0f}% of it)")
    log("[timings] gemm_table " + json.dumps({
        "per_forward": forward,
        "rows": [dict(kernel=kd, M=m, K=K, N=N, **r) for (kd, m, K, N), r in table.items()],
    }))


#: ``time_gemm_host``'s reading before the kernel wrappers read
#: ``kernels.recording.active`` (a full run on an NVIDIA H100 80GB HBM3 at
#: 700.00 W; PERF.md §6), printed beside each new reading
BEFORE_HOOK_GEMM_HOST_US = {"gemm_batch_invariant": 34.40, "gemm_splitk": 33.24,
                            "torch.matmul": 62.37}


def time_gemm_host(torch, cfg, passes=6) -> None:
    """Host time per GEMM call as a forward issues them: one call on each of
    a forward's 225 distinct weights ((4096, 1024) bf16, the narrowest
    projection, so that the device keeps up) at M = 8, with no
    synchronisation inside a pass, so a pass's host clock reads the
    wrapper's path (checks, allocations, tensor maps, the ctypes call, the
    launches) and not the device.  Commit GEMM, split-K GEMM and
    ``torch.matmul`` take passes in turns; each figure is the median of all
    passes but the first (which encodes the weights' tensor maps)."""
    from repro_torch.core.determinism import CANONICAL_TP_SHARDS
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk

    g = torch.Generator(device=DEV).manual_seed(12)
    bf, D, n = torch.bfloat16, cfg.d_model, 7 * cfg.num_layers + 1
    ws = [(torch.randn((D, 1024), generator=g, device=DEV) * D ** -0.5).to(bf)
          for _ in range(n)]
    x = torch.randn((8, D), generator=g, device=DEV).to(bf)
    fns = {"gemm_batch_invariant": lambda w: gemm_batch_invariant(
               x, w, chunks=CANONICAL_TP_SHARDS),
           "gemm_splitk": lambda w: gemm_splitk(x, w, splits=4, combine_dtype="bfloat16"),
           "torch.matmul": lambda w: torch.matmul(x, w)}
    readings = {name: [] for name in fns}
    for _ in range(passes):
        for name, fn in fns.items():
            sync(torch)
            t0 = time.perf_counter()
            for w in ws:
                fn(w)
            readings[name].append((time.perf_counter() - t0) / n * 1e6)
    sync(torch)
    host_us = {name: sorted(r[1:])[(len(r) - 1) // 2] for name, r in readings.items()}
    log(f"[timings] host time per GEMM call ({n} weights of ({D},1024) bf16, M=8, "
        f"median of {passes - 1} passes): " + ", ".join(
            f"{name} {us:.2f} us (before the hook: {BEFORE_HOOK_GEMM_HOST_US[name]:.2f})"
            for name, us in host_us.items()))
    log("[timings] gemm_host_us " + json.dumps(host_us))


def time_paged_attention(torch, cfg, results, flush) -> None:
    """Kernels 3 and 4 at each of ``paged_shapes``, B = 64 and the long
    context, beside their plain versions and the bound of each shape: the
    commit kernel, and the fast kernel at FAST_PATH_POLICY's schedule (bf16
    combine; kv_splits 4 at B = 8, where the long context reads K twice,
    and 1 at B = 64).  No single PyTorch call reads K/V through a block
    table, so ``library_ms`` stays null.  The headline shape's numbers fill
    the kernel's entry; every shape's go under ``shapes``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_fast

    def commit(inp):
        return (lambda: paged_attention(*inp[:6]),
                lambda: ref.paged_attention(*inp[:6]))

    def fast(inp, splits):
        kw = dict(kv_splits=splits, combine_dtype="bfloat16")
        return (lambda: paged_attention_fast(*inp[:6], **kw),
                lambda: ref.paged_attention_fast(*inp[:6], **kw))

    shapes = paged_shapes(torch, cfg)
    cases = []
    for label, inp in shapes.items():
        cases += [("paged_attention", label, inp, commit(inp)),
                  ("paged_attention_fast", label, inp, fast(inp, 4))]
    for name, label, inp, (kern, plain) in cases:
        time_paged_case(torch, cfg, results, flush, name, label, inp, kern, plain)
    del shapes, cases
    for label, make, splits in (("B=64", wide_batch_inputs, 1), ("long", long_inputs, 4)):
        inp = make(torch, cfg)
        time_paged_case(torch, cfg, results, flush, "paged_attention", label, inp,
                        *commit(inp))
        time_paged_case(torch, cfg, results, flush, "paged_attention_fast",
                        f"{label}, kv_splits={splits}", inp, *fast(inp, splits))
        del inp


def time_paged_case(torch, cfg, results, flush, name, label, inp, kern, plain,
                    tag="timings") -> None:
    q, _, _, _, tab, _, ctx = inp
    b_ms, b_by = attention_bound(cfg, q, ctx, BLOCK, tab)
    ms = time_ms(torch, kern, flush=flush)
    plain_ms = time_ms(torch, plain, reps=5, flush=flush)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               keys=int(ctx.sum()), nblk=int(tab.shape[1]))
    results[name].setdefault("shapes", {})[label] = row
    if label == "headline":
        results[name].update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                             bound_by=b_by)
    log(f"[{tag}] {name} {label}: B={q.shape[0]}, nblk={tab.shape[1]}, "
        f"{int(ctx.sum())} keys: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it); no single PyTorch "
        f"call reads K/V through a block table (library_ms null)")


def time_decode_attention(torch, cfg, results, flush, names=DECODE_SHAPES,
                          prefix="", tag="timings") -> None:
    """Kernel 5 at each of ``decode_shapes`` (those of ``names``), at
    FAST_PATH_POLICY's schedule for B = 8 (kv_splits 4, bf16 combine) and
    the commit schedule (1, f32), beside its plain version,
    ``scaled_dot_product_attention`` with a length mask and GQA (the same
    function), and the bound of each shape.  The headline shape's numbers
    fill the kernel's entry (without a ``prefix``: Llama-3-8B's heads);
    every shape's go under ``shapes``, as ``prefix + label``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    for label, (q, k, v, lens) in decode_shapes(torch, cfg, names).items():
        label = prefix + label
        S = k.shape[1]
        b_ms, b_by = decode_bound(q, k, lens)
        mask = (torch.arange(S, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
        row = dict(keys=int(lens.sum()), S=S, B=q.shape[0], library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        for splits, cd in DECODE_CASES:
            ms = time_ms(torch, lambda: decode_attention(
                q, k, v, lens, kv_splits=splits, combine_dtype=cd), flush=flush)
            plain_ms = time_ms(torch, lambda: ref.decode_attention(
                q, k, v, lens, splits, cd), reps=5, flush=flush)
            suffix = "" if splits == 4 else "_kv_splits_1"
            row.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms})
            log(f"[{tag}] decode_attention {label}: B={q.shape[0]} S={S}, "
                f"{int(lens.sum())} valid keys, kv_splits={splits} {cd}: {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}, {100 * b_ms / ms:.1f}% of it)")
        results["decode_attention"].setdefault("shapes", {})[label] = row
        if label == "headline":
            results["decode_attention"].update(
                {key: row[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                           "bound_by", "ms_kv_splits_1",
                                           "plain_ms_kv_splits_1")})
        del q, k, v, lens, ks, vs


def time_rmsnorm(torch, cfg, results, flush) -> None:
    """Kernel 6 at (M, 4096) bf16 for each of RMSNORM_ROWS, bf16 scale:
    without a residual beside ``F.rms_norm`` on the same x and scale (the
    same function), kernel, library, library, kernel; and with a residual
    (the fused add, which no single PyTorch call computes).  That the timed
    call is one launch is checked in the kernels phase (``check_rmsnorm``).
    The 32-row numbers fill the kernel's entry; every shape's go under
    ``shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm

    g = torch.Generator(device=DEV).manual_seed(9)
    D = cfg.d_model
    for M in RMSNORM_ROWS:
        x = torch.randn((M, D), generator=g, device=DEV).to(torch.bfloat16)
        r = torch.randn((M, D), generator=g, device=DEV).to(torch.bfloat16)
        sc = torch.randn((D,), generator=g, device=DEV).to(torch.bfloat16)
        k1 = time_ms(torch, lambda: rmsnorm(x, sc, eps=cfg.norm_eps), flush=flush)
        l1 = time_ms(torch, lambda: F.rms_norm(x, (D,), sc, cfg.norm_eps), flush=flush)
        l2 = time_ms(torch, lambda: F.rms_norm(x, (D,), sc, cfg.norm_eps), flush=flush)
        k2 = time_ms(torch, lambda: rmsnorm(x, sc, eps=cfg.norm_eps), flush=flush)
        r1 = time_ms(torch, lambda: rmsnorm(x, sc, r, eps=cfg.norm_eps), flush=flush)
        r2 = time_ms(torch, lambda: rmsnorm(x, sc, r, eps=cfg.norm_eps), flush=flush)
        ms, lib_ms, res_ms = (k1 + k2) / 2, (l1 + l2) / 2, (r1 + r2) / 2
        plain_ms = time_ms(torch, lambda: ref.rmsnorm(x, sc, cfg.norm_eps), reps=20,
                           flush=flush)
        b_ms, b_by = bound(2 * M * D * 2 + D * 2, 4.0 * M * D)
        rb_ms, _ = bound(3 * M * D * 2 + D * 2, 5.0 * M * D)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, ms_with_residual=res_ms, bound_ms_with_residual=rb_ms)
        results["rmsnorm"].setdefault("shapes", {})[f"({M},{D})"] = row
        if M == RMSNORM_ROWS[0]:
            results["rmsnorm"].update({key: row[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "ms_with_residual")})
        log(f"[timings] rmsnorm ({M},{D}) bf16, bf16 scale: without residual "
            f"{ms:.4f} ms (readings {k1:.4f}, {k2:.4f}), "
            f"F.rms_norm {lib_ms:.4f} ms ({l1:.4f}, {l2:.4f}): {ms / lib_ms:.2f}x; "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / ms:.1f}% of it); with residual {res_ms:.4f} ms ({r1:.4f}, "
            f"{r2:.4f}), bound {rb_ms:.4f} ms ({100 * rb_ms / res_ms:.1f}% of it)")
        del x, r


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + OPTIONAL_PHASES}")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + OPTIONAL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from repro_torch.configs import llama3_8b

    cfg = llama3_8b.config()
    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    results = {name: dict(name=name, route="cuda", **meta, launches=0,
                          launches_by_mode={}, max_abs_err=None, ms=None,
                          plain_ms=None, bound_ms=None, bound_by=None,
                          library_ms=None)
               for name, meta in KERNELS.items()}
    summary = {}
    if "build" in phases:
        timed("build", phase_build)
    if "kernels" in phases:
        timed("kernels", phase_kernels, torch, cfg, results)
    if {"serve", "programs", "determinism", "profile", "online", "analysis"} & set(phases):
        from repro_torch.models.base import init_params

        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
        sync(torch)
        log(f"[serve] random weights ({cfg.param_count() / 1e9:.2f} B params, "
            f"seed 0) in {time.perf_counter() - t0:.1f} s")
        summary.update(layers=cfg.num_layers, capacity=CAPACITY)
        if "serve" in phases:
            timed("serve", phase_serve, torch, cfg, params, CAPACITY, results, summary)
            timed("reference", phase_reference, torch, cfg, params)
        if "programs" in phases:
            timed("programs", phase_programs, torch, cfg, params, results, summary)
        if "determinism" in phases:
            timed("determinism", phase_determinism, torch, cfg, params, results, summary)
        if "profile" in phases:
            timed("profile", phase_profile, torch, cfg, params, CAPACITY, summary)
        if "online" in phases:
            timed("online", phase_online, torch, cfg, params, CAPACITY, results, summary)
        if "analysis" in phases:
            timed("analysis", phase_analysis, torch, cfg, params, summary)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if "configs" in phases:
        timed("configs", phase_configs, torch, results, summary)
    if "variants" in phases:
        timed("variants", phase_variants, torch, results, summary)
    if "families" in phases:
        timed("families", phase_families, torch, results, summary)
    if "modalities" in phases:
        timed("modalities", phase_modalities, torch, results, summary)
    if "hybrid" in phases:
        timed("hybrid", phase_hybrid, torch, results, summary)
    if "distribution" in phases:
        timed("distribution", phase_distribution, torch, results, summary)
    if "dryrun_kimi" in phases:
        timed("dryrun_kimi", phase_dryrun_kimi, torch, results, summary)
    if "distribution4" in phases:
        timed("distribution4", phase_distribution4, torch, results, summary)
    if "cluster" in phases:
        timed("cluster", phase_cluster, torch, results, summary)
    if "training" in phases:
        timed("training", phase_training, torch, results, summary)
    if "timings" in phases:
        timed("timings", phase_timings, torch, cfg, results)
    log(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f} s")
    log("[summary] " + json.dumps(summary))
    log(card)
    log(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "launches_by_mode", "max_abs_err", "max_abs_err_by_config",
                           "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms", "ms_kv_splits_1",
                           "plain_ms_kv_splits_1", "ms_with_residual", "shapes", "backward",
                           "tp_fold")
         if k in r} for r in results.values()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
