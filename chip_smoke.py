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
           sensitivity of the fast kernels, which GEMM partial tile each
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
           with counts reset the same way; then a 2-layer cut's logits on
           the card against the CPU, on each lane;
4. determinism  the divergence demo's experiment on each lane, with
           greedy and seeded deterministic requests: LLM42 and
           BATCH_INVARIANT streams must be bitwise identical alone and
           beside 3 and 6 neighbours, and the gathered lane's LLM42 streams
           equal to the paged lane's (NONDET divergence is printed);
5. profile ``torch.profiler`` over a window of 4 iterations of the paged
           LLM42 run: device time by kernel, the GEMMs' and the paged
           kernels' share, and the device's busy share; then a short run of
           every lane and mode,
           whose GEMMs must all run the tensor-core tile (by kernel name);
6. timings each kernel against its plain version and one PyTorch call,
           beside the least time the card could take (100 launches a
           reading); both GEMMs beside ``torch.matmul`` at every projection
           shape and serve-run M, their device time per forward, and the
           host time per GEMM call; the timer's floor; the paged pair at
           each of ``paged_shapes``, B = 64 and a long context;
           ``decode_attention`` at each of ``decode_shapes`` beside
           ``scaled_dot_product_attention``; ``rmsnorm`` at 32, 256 and
           16384 rows beside ``F.rms_norm`` (the same function without a
           residual) and with a residual.

The line before the last is a JSON object describing every kernel
(``launches`` sums the serve runs and the rmsnorm entry-point run,
``launches_by_mode`` splits them by lane and mode); the last line is
``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script exits non-zero without a result when no CUDA device
is visible or when it runs outside a checkout of the repository.

    python3 chip_smoke.py                 # everything, one card
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,timings
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
PHASES = ("build", "kernels", "serve", "determinism", "profile", "timings")

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
    # D = 128) and rmsnorm (bf16 x and scale, 4 vectors a lane: D = 4096):
    # registers, static shared memory, stack and spill bytes (the rings are
    # dynamic shared memory)
    for stem, text in logs.items():
        kernel, spills = None, ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                found = re.search(r"(wgmma|fmaf)_partial_kernel", line)
                if found is None and re.search(r"bfloat16Li4EE|merge_kernelILi4E", line):
                    # the attention kernels at the main path's bf16, D = 128
                    found = re.search(
                        r"(paged_(attention|split|merge)|decode_attention)_kernel", line)
                if found is None and re.search(r"rmsnorm_kernelI13__nv_bfloat16S\w*_Li4E",
                                               line):
                    found = re.search(r"rmsnorm_kernel", line)
                kernel = found.group(0) if found else None
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


def paged_shapes(torch, cfg):
    """The paged kernels' three shapes, B = 8, blocks of 16: ``headline``
    (a 128-entry table, contexts in [512, 2048), the kernel table's shape),
    ``serve`` (a 128-entry table, the serve phase's contexts: 32 prompt
    tokens and up to 16 new ones) and ``default reach`` (the serve rows
    with their tables at the engine's default capacity, cfg.max_seq_len: a
    2056-entry table)."""
    serve = paged_inputs(torch, cfg, 8, CAPACITY, BLOCK, seed=13, min_ctx=33, max_ctx=49)
    return {
        "headline": paged_inputs(torch, cfg, 8, CAPACITY, BLOCK, seed=3,
                                 min_ctx=512, max_ctx=2048),
        "serve": serve,
        "default reach": widen(torch, serve, -(-cfg.max_seq_len // BLOCK)),
    }


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


def decode_shapes(torch, cfg):
    """The dense decode kernel's five shapes at Llama-3-8B's heads, bf16,
    mirroring ``paged_shapes``: ``headline`` (B = 8 over a 2048-slot view,
    lengths in [512, 2048)), ``serve`` (the serve phase's lengths: 32 prompt
    tokens plus up to 16 committed and 7 speculated), ``default reach`` (the
    serve rows in a view of cfg.max_seq_len slots, the engine's default
    capacity; the slots past 2048 hold other random keys, which no valid
    length reaches), ``B=64`` (the headline's lengths) and ``long`` (B = 8
    over 16384 slots, lengths in [8192, 16384))."""
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    serve = decode_inputs(torch, 8, 2048, H, KV, D, seed=8, min_len=33, max_len=56)
    q, k, v, lens = serve
    g = torch.Generator(device=DEV).manual_seed(17)
    wide = [torch.randn((8, cfg.max_seq_len, KV, D), generator=g, device=DEV).to(k.dtype)
            for _ in range(2)]
    for w, t in zip(wide, (k, v)):
        w[:, : t.shape[1]] = t
    return {
        "headline": decode_inputs(torch, 8, 2048, H, KV, D, seed=3, min_len=512,
                                  max_len=2048),
        "serve": serve,
        "default reach": (q, wide[0], wide[1], lens),
        "B=64": decode_inputs(torch, 64, 2048, H, KV, D, seed=16, min_len=512,
                              max_len=2048),
        "long": decode_inputs(torch, 8, 16384, H, KV, D, seed=14, min_len=8192,
                              max_len=16384),
    }


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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
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

    check_paged_attention(torch, cfg, results)
    check_decode_attention(torch, cfg, results)
    check_rmsnorm(torch, cfg, results)


#: rows of the 8 at which the commit paged kernel's rows must keep their
#: bits: B = 1, 3 and 13 (the 8, then rows 0-4 again with their own tables
#: and q)
PAGED_ROWS = ((5,), (5, 1, 6), tuple(range(8)) + (0, 1, 2, 3, 4))

#: the fast paged kernel's (kv_splits, combine) cases at every shape
FAST_CASES = ((4, "bfloat16"), (8, "bfloat16"), (4, "float32"))


def check_paged_attention(torch, cfg, results) -> None:
    """Kernels 3 and 4 at each of ``paged_shapes``, a long context and odd
    block sizes, widths and head groups, against their plain versions; the
    commit kernel's rows bitwise identical for B in {1, 3, 8, 13}, across
    launches, and at a 128- and a 2056-entry table; the fast kernel's split
    and combine sensitivity at the headline shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_fast

    def commit_case(label, inp):
        q, k, v, pos, tab, qp, ctx = inp
        out = paged_attention(q, k, v, pos, tab, qp)
        want = ref.paged_attention(q, k, v, pos, tab, qp)
        err = float((out - want).abs().max())
        log(f"[kernels] paged_attention {label}: B={q.shape[0]} nblk={tab.shape[1]} "
            f"bs={k.shape[1]} H={q.shape[1]} KV={k.shape[2]} D={q.shape[2]} "
            f"{str(q.dtype)[6:]}, {int(ctx.sum())} keys: max_abs_err {err:.3e} "
            f"(tol {ATTN_TOL:g})")
        require(err <= ATTN_TOL, f"paged_attention disagrees with its plain version ({label})")
        return out, err

    def fast_case(label, inp, splits, cd):
        out = paged_attention_fast(*inp[:6], kv_splits=splits, combine_dtype=cd)
        want = ref.paged_attention_fast(*inp[:6], kv_splits=splits, combine_dtype=cd)
        err = float((out - want).abs().max())
        tol = FAST_ATTN_TOL[cd]
        log(f"[kernels] paged_attention_fast {label} kv_splits={splits} {cd}: "
            f"max_abs_err {err:.3e} (tol {tol:g})")
        require(err <= tol, f"paged_attention_fast disagrees with its plain version ({label})")
        return out, want, err

    worst = worst_fast = 0.0
    shapes = paged_shapes(torch, cfg)
    commit_out = {}
    for label, inp in shapes.items():
        out, err = commit_case(label, inp)
        worst = max(worst, err)
        commit_out[label] = out
        q, k, v, pos, tab, qp, _ = inp
        for rows in PAGED_ROWS:
            sel = torch.tensor(rows, device=DEV)
            part = paged_attention(q[sel].contiguous(), k, v, pos, tab[sel].contiguous(),
                                   qp[sel].contiguous())
            require(torch.equal(part, out[sel]),
                    f"paged_attention rows change at B={len(rows)} ({label})")
        require(torch.equal(out, paged_attention(q, k, v, pos, tab, qp)),
                f"paged_attention is not repeatable ({label})")
        log(f"[kernels] paged_attention {label}: rows bitwise identical for B in "
            f"{{1,3,8,13}}; repeatable")
        for splits, cd in FAST_CASES:
            worst_fast = max(worst_fast, fast_case(label, inp, splits, cd)[2])
    require(torch.equal(commit_out["serve"], commit_out["default reach"]),
            "paged_attention rows change with the table reach")
    log("[kernels] paged_attention serve rows bitwise identical at a 128- and a "
        "2056-entry table")

    # split and combine sensitivity at the headline shape, and one split
    # (the B >= 64 case)
    head = shapes["headline"]
    outs, wants = {}, {}
    for splits, cd in FAST_CASES + ((1, "bfloat16"), (1, "float32")):
        outs[splits, cd], wants[splits, cd], err = fast_case("headline", head, splits, cd)
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
    worst = max(worst, commit_case("long", inp)[1])
    for splits, cd in ((1, "bfloat16"), (1, "float32"), (4, "bfloat16")):
        worst_fast = max(worst_fast, fast_case("long", inp, splits, cd)[2])
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
        worst = max(worst, commit_case(label, inp)[1])
        for sp, cd in ((1, "bfloat16"), (splits, "bfloat16"), (splits, "float32")):
            worst_fast = max(worst_fast, fast_case(label, inp, sp, cd)[2])
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
    """The first M rows of ``xb`` (200 rows) alone give the bits they give
    in the whole batch, for every M in ROW_MS; the call repeats bitwise."""
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


def check_decode_attention(torch, cfg, results) -> None:
    """Kernel 5, the gathered lane's W == 1 attention, at each of
    ``decode_shapes`` and at D = 64, against its plain version; at kv_splits
    1 a row's bits identical for B in {1, 3, 8, 13} and across launches at
    every shape, and at a 2048- and a 32896-slot view; the combine rounding
    with f32 operands; a row's bits at places 5/17/199 of a batch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    def case(label, inp, splits, cd):
        q, k, v, lens = inp
        out = decode_attention(q, k, v, lens, kv_splits=splits, combine_dtype=cd)
        want = ref.decode_attention(q, k, v, lens, splits, cd)
        sync(torch)
        err = float((out.float() - want.float()).abs().max())
        ulp = ulp_of(float(want.float().abs().max()), 7)
        B, S, KV, D = k.shape
        log(f"[kernels] decode_attention {label}: B={B} S={S} H={q.shape[1]} KV={KV} "
            f"D={D} {str(q.dtype)[6:]}, {int(lens.clamp(0, S).sum())} keys, "
            f"kv_splits={splits} {cd}: max_abs_err {err:.3e} = {err / ulp:.2f} bf16 "
            f"ulps (tol {DECODE_ULPS[cd]})")
        require(err <= DECODE_ULPS[cd] * ulp,
                f"decode_attention disagrees with its plain version ({label})")
        if bool((lens <= 0).any()):
            require(not bool(out[lens <= 0].float().abs().max()), "length 0 must give 0")
        return out, err

    worst = 0.0
    commit_out = {}
    for label, inp in decode_shapes(torch, cfg).items():
        for splits, cd in DECODE_CASES:
            out, err = case(label, inp, splits, cd)
            worst = max(worst, err)
        commit_out[label] = out  # kv_splits 1, f32 combine
        q, k, v, lens = inp
        for rows in PAGED_ROWS:
            sel = torch.tensor(rows, device=DEV)
            part = decode_attention(q[sel].contiguous(), k[sel].contiguous(),
                                    v[sel].contiguous(), lens[sel].contiguous())
            require(torch.equal(part, out[sel]),
                    f"decode_attention rows change at B={len(rows)} ({label})")
        require(torch.equal(out, decode_attention(q, k, v, lens)),
                f"decode_attention is not repeatable ({label})")
        log(f"[kernels] decode_attention {label} kv_splits=1: rows bitwise identical "
            f"for B in {{1,3,8,13}}; repeatable")
        del inp, q, k, v
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
            worst = max(worst, case("D=64", (q, k, v, lens), splits, cd)[1])
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
            gc.collect()  # earlier engines' pools (the engine holds cycles)
            eng = Engine(cfg, params, mode=mode, capacity=capacity,
                         paged_attention=paged)
            reqs = build_requests(cfg, n_req, det_ratio=0.5, max_out=max_new, seed=0)
            sync(torch)
            torch.cuda.reset_peak_memory_stats()
            fns = reset_launches()
            res = serve(eng, reqs)
            counts = {name: fn.launches for name, fn in fns.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
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
                peak_mem_gib=peak, launches=counts)
            log(f"[serve] {run}: {res['committed']} tokens committed in "
                f"{res['iterations']} iterations, rollbacks {res['rollbacks']}, "
                f"recomputed {res['recomputed']}, device time {res['device_s']} s "
                f"-> {tps} committed tok/s; peak device memory {peak:.3f} GiB")
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


def expected_launches(cfg, eng, paged):
    """Kernel launches implied by the passes the engine reports: every
    forward runs 7 GEMMs per layer plus the unembedding in the kernel its
    schedule selects, and every single-token forward (a decode pass, or a
    one-token prefill chunk) one attention launch per layer: on the paged
    lane the fast paged kernel where its kv_splits divides the table reach,
    else the commit one; on the gathered lane the dense decode kernel."""
    from repro_torch.core.determinism import Schedule

    gemms = 7 * cfg.num_layers + 1
    nblk = eng.pool.layout.blocks_per_table
    commit = eng._commit_schedule()
    want = dict.fromkeys(KERNELS, 0)
    for ev in engine_events(eng):
        if ev["kind"] in ("prefill", "prefill_chunk", "verify"):
            want["gemm_batch_invariant"] += gemms
            if ev["kind"] == "verify" or ev["padded"] > 1:
                continue
            s = commit
        elif ev["kind"] == "decode":
            s = Schedule(*ev["schedule"])
            split = s.splits > 1 and s.tp_shards == 1
            want["gemm_splitk" if split else "gemm_batch_invariant"] += gemms
        else:
            continue
        if not paged:
            want["decode_attention"] += cfg.num_layers
        else:
            fast = s.kv_splits > 1 and nblk % s.kv_splits == 0
            want["paged_attention_fast" if fast else "paged_attention"] += cfg.num_layers
    return want


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


def phase_determinism(torch, cfg, params, summary) -> None:
    """The divergence demo's experiment (examples/dvr_divergence_demo.py)
    on each lane, with three tracked requests (one greedy, two seeded at
    temperature 0.8 with top-k 0 and 50) beside 0, 3 and 6 greedy
    neighbours."""
    from repro_torch.core.determinism import Mode, ReductionPolicy
    from repro_torch.core.spans import consistent_spans
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, SamplingParams

    policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                             combine_dtype="bfloat16")
    max_new = 32
    tracked = {0: dict(seed=7), 1: dict(seed=8, temperature=0.8),
               2: dict(seed=9, temperature=0.8, top_k=50)}

    def run(lane, mode, n_neighbours):
        eng = Engine(cfg, params, mode=mode, policy=policy, window=6, group=2,
                     max_batch=12, capacity=256, paged_attention=LANES[lane])
        for rid, kw in tracked.items():
            eng.submit(Request(rid=rid, prompt=[rid * 11 + k for k in range(1, 11)],
                               sampling=SamplingParams(
                                   max_new_tokens=max_new,
                                   is_deterministic=mode != Mode.NONDET, **kw)))
        for i in range(n_neighbours):
            eng.submit(Request(rid=10 + i, prompt=[3 * i + k for k in range(6)],
                               sampling=SamplingParams(max_new_tokens=max_new)))
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


def phase_profile(torch, cfg, params, capacity, summary, warm=4, active=4) -> None:
    """Where an LLM42 serve run's time goes: ``torch.profiler`` over a
    window of ``active`` iterations of the serve phase's paged LLM42 run,
    after ``warm`` unprofiled ones (the timed run itself goes unprofiled):
    device time by kernel and the device's busy share of the window (sum of
    kernel times over the window's wall time).  Iterations 5..8 hold four
    decode passes and the run's first grouped verify; summing the trace
    costs about 5 s an iteration, which bounds the window.  Then a short
    run of every lane and mode under a trace of the card alone, whose
    GEMMs must all run the tensor-core tile."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.determinism import Mode
    from repro_torch.launch.serve import build_requests
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, mode=Mode.LLM42, capacity=capacity)
    for r in build_requests(cfg, 8, det_ratio=0.5, max_out=16, seed=0):
        eng.submit(r)
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
    eng.run()
    t0 = time.perf_counter()
    averages = prof.key_averages()
    rows = sorted((e for e in averages if e.device_time_total > 0),
                  key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in averages) / 1e6
    log(f"[profile] llm42 iterations {first}..{first + active - 1}: host wall "
        f"{wall:.3f} s under the profiler, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%); trace summed in {time.perf_counter() - t0:.1f} s")
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
    log(f"[profile] GEMM device time in the window {gemm_ms:.1f} ms of "
        f"{busy * 1e3:.1f} ms busy: " + ", ".join(
            f"{k} {ms:.1f} ms / {n} launches" for k, (ms, n) in gemm.items()))
    require("wgmma_partial_kernel" in gemm and "fmaf_partial_kernel" not in gemm,
            "the profiled window's bf16 GEMMs did not run only the tensor-core tile")
    # the paged attention kernels' device time, by kernel name
    paged = {}
    for e in averages:
        found = re.search(r"paged_(attention|split|merge)_kernel", e.key)
        if found and e.self_device_time_total > 0:
            ms, n = paged.get(found.group(0), (0.0, 0))
            paged[found.group(0)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    paged_ms = sum(ms for ms, _ in paged.values())
    log(f"[profile] paged attention device time in the window {paged_ms:.2f} ms: "
        + ", ".join(f"{k} {ms:.2f} ms / {n} launches ({1e3 * ms / n:.1f} us each)"
                    for k, (ms, n) in sorted(paged.items())))
    for e in rows[:20]:
        log(f"[profile] {e.device_time_total / 1e3:10.1f} ms device "
            f"{e.cpu_time_total / 1e3:10.1f} ms cpu {e.count:7d}x  {e.key[:90]}")
    top_cpu = sorted(averages, key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in top_cpu[:8]:
        log(f"[profile] host self {e.self_cpu_time_total / 1e3:10.1f} ms "
            f"{e.count:7d}x  {e.key[:90]}")
    events = [ev for ev in engine_events(eng) if first <= ev["iter"] < first + active]
    for kind in ("prefill", "decode", "verify"):
        walls = [ev["wall"] for ev in events if ev["kind"] == kind]
        log(f"[profile] engine {kind}: {len(walls)} passes, {sum(walls):.3f} s wall")
    summary["profile"] = {"iterations": active, "wall_s": wall, "device_busy_s": busy,
                          "gemm_device_ms": gemm_ms, "paged_device_ms": paged_ms}
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
# phase 5: timings
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
    from repro_torch.kernels.gemm_splitk import gemm_splitk

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEV).manual_seed(2)
    bf = torch.bfloat16
    D, F = cfg.d_model, cfg.d_ff
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)

    def flush():  # the weights of a layer are cold in L2 on the main path
        scratch.zero_()

    def gemm_row(name, M, K, N, kernel, plain, extra):
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
        results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
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
            f"{name} {us:.2f} us" for name, us in host_us.items()))
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


def time_paged_case(torch, cfg, results, flush, name, label, inp, kern, plain) -> None:
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
    log(f"[timings] {name} {label}: B={q.shape[0]}, nblk={tab.shape[1]}, "
        f"{int(ctx.sum())} keys: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it); no single PyTorch "
        f"call reads K/V through a block table (library_ms null)")


def time_decode_attention(torch, cfg, results, flush) -> None:
    """Kernel 5 at each of ``decode_shapes``, at FAST_PATH_POLICY's schedule
    for B = 8 (kv_splits 4, bf16 combine) and the commit schedule (1, f32),
    beside its plain version, ``scaled_dot_product_attention`` with a length
    mask and GQA (the same function), and the bound of each shape.  The
    headline shape's numbers fill the kernel's entry; every shape's go
    under ``shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    for label, (q, k, v, lens) in decode_shapes(torch, cfg).items():
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
            log(f"[timings] decode_attention {label}: B={q.shape[0]} S={S}, "
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
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
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
    if {"serve", "determinism", "profile"} & set(phases):
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
        if "determinism" in phases:
            timed("determinism", phase_determinism, torch, cfg, params, summary)
        if "profile" in phases:
            timed("profile", phase_profile, torch, cfg, params, CAPACITY, summary)
        del params
        torch.cuda.empty_cache()
    if "timings" in phases:
        timed("timings", phase_timings, torch, cfg, results)
    log(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f} s")
    log("[summary] " + json.dumps(summary))
    log(card)
    log(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "launches_by_mode", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms", "ms_kv_splits_1",
                           "plain_ms_kv_splits_1", "ms_with_residual", "shapes")
         if k in r} for r in results.values()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
