#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

Drives ``repro_torch`` (never JAX, never the JAX package) at the full width
of Llama-3-8B (``repro_torch/configs/llama3_8b.py::config``), random weights
from a seed:

1. build   compile the four Hopper kernels from ``src/repro_torch/kernels/
           csrc`` (nvcc, in parallel) and print the card's name and power
           limit;
2. kernels hold each kernel against its plain PyTorch version at the main
           path's shapes (tolerance printed), plus row invariance across M
           and B, bitwise repeatability of the commit kernels, and split
           sensitivity of the fast kernels;
3. serve   serve requests through ``launch/serve.py``'s request builder in
           LLM42, BATCH_INVARIANT and NONDET mode (the main path), each
           run with every kernel's launch count reset just before it and
           read just after; the counts must equal what the engine's passes
           imply, and each mode must reach exactly its kernels; then a
           2-layer cut's logits on the card against the CPU;
4. determinism  the divergence demo's experiment: the deterministic
           request's LLM42 and BATCH_INVARIANT streams must be bitwise
           identical alone and beside 3 and 6 neighbours (NONDET divergence
           is printed);
5. profile ``torch.profiler`` over a repeat of the LLM42 run: device time
           by kernel and the device's busy share;
6. timings each kernel against its plain version and one PyTorch call,
           beside the least time the card could take.

The line before the last is a JSON object describing every kernel
(``launches`` sums the three serve runs, ``launches_by_mode`` splits them);
the last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script exits non-zero without a result when no CUDA device
is visible or when it runs outside a checkout of the repository.

    python3 chip_smoke.py                 # everything, one card
    python3 chip_smoke.py --phases build,kernels
"""

from __future__ import annotations

import argparse
import dataclasses
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

#: per-request KV reach of the serve phase (128 blocks of 16); the engine's
#: default, max_seq_len, would make every commit-kernel row walk 2056 blocks
CAPACITY = 2048

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
}


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
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s -> {build.BUILD_DIR}")
    for stem, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {stem}: {line.strip()}")
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


def gemm_bound(M, K, N, elt=2):
    nbytes = (M * K + K * N + M * N) * elt
    flops = 2.0 * M * N * K
    return bound(nbytes, flops)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(cfg, q, ctx, block_size):
    """Bytes a paged decode must move: q, every valid key and value row,
    the positions of the blocks it reads, the tables, the f32 output."""
    B, H, D = q.shape
    KV = cfg.num_kv_heads
    n_valid = int(ctx.sum())
    n_blocks = int(sum(-(-int(c) // block_size) for c in ctx))
    nbytes = (q.numel() * 2 + n_valid * KV * D * 2 * 2
              + n_blocks * block_size * 4 + B * 4 + q.numel() * 4)
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
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_fast,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=DEV).manual_seed(0)
    bf = torch.bfloat16
    D, F = cfg.d_model, cfg.d_ff

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEV) * scale).to(bf)

    def bf16_tol(ref_out, ulps):
        return float(ref_out.float().abs().max()) * 2.0 ** -8 * ulps

    # -- kernel 1: commit GEMM, every projection shape of a verify pass (M=32)
    worst = 0.0
    for K, N in ((D, D), (D, 1024), (D, F), (F, D), (D, cfg.vocab_size)):
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
    # f32 operands: the kernel's arithmetic without the output rounding
    x, w = rnd(13, D).float(), rnd(D, 1024, scale=D ** -0.5).float()
    err32 = float((gemm_batch_invariant(x, w, chunks=4)
                   - ref.gemm_batch_invariant(x, w, chunks=4)).abs().max())
    log(f"[kernels] gemm_batch_invariant f32 (13,{D})@({D},1024): "
        f"max_abs_err {err32:.3e} (tol 1e-4)")
    require(err32 <= 1e-4, "gemm_batch_invariant f32 disagrees")
    results["gemm_batch_invariant"]["max_abs_err"] = worst
    # rows bitwise independent of M; bitwise repeatable
    xb, w = rnd(200, D), rnd(D, F, scale=D ** -0.5)
    full = gemm_batch_invariant(xb, w, chunks=4)
    for M in (1, 7, 13, 32, 128, 200):
        part = gemm_batch_invariant(xb[:M].contiguous(), w, chunks=4)
        require(torch.equal(part, full[:M]), f"gemm_batch_invariant rows change at M={M}")
    require(torch.equal(full, gemm_batch_invariant(xb, w, chunks=4)),
            "gemm_batch_invariant is not repeatable")
    log("[kernels] gemm_batch_invariant rows bitwise identical for M in "
        "{1,7,13,32,128,200}; repeatable")

    # -- kernel 2: fast split-K GEMM at the decode batch
    worst = 0.0
    for M, splits in ((1, 8), (4, 4), (8, 4)):
        for K, N in ((D, D), (D, F), (F, D)):
            x, w = rnd(M, K), rnd(K, N, scale=K ** -0.5)
            out = gemm_splitk(x, w, splits=splits, combine_dtype="bfloat16")
            want = ref.gemm_splitk(x, w, splits, "bfloat16")
            sync(torch)
            err = float((out.float() - want.float()).abs().max())
            tol = bf16_tol(want, 4)
            require(err <= tol, f"gemm_splitk disagrees at M={M} K={K} N={N}")
            worst = max(worst, err)
    log(f"[kernels] gemm_splitk M in {{1,4,8}}, splits {{8,4}}, bf16 combine: "
        f"max_abs_err {worst:.3e} (tol 4 bf16 ulps of max|ref|)")
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

    # -- kernels 3 and 4: paged decode attention at capacity 2048
    q, k, v, pos, tab, qp, ctx = paged_inputs(
        torch, cfg, 8, 2048, 16, seed=1, min_ctx=1, max_ctx=2048)
    out = paged_attention(q, k, v, pos, tab, qp)
    want = ref.paged_attention(q, k, v, pos, tab, qp)
    err = float((out - want).abs().max())
    log(f"[kernels] paged_attention B=8 nblk=128 bs=16: max_abs_err {err:.3e} "
        f"(tol {ATTN_TOL:g})")
    require(err <= ATTN_TOL, "paged_attention disagrees with its plain version")
    results["paged_attention"]["max_abs_err"] = err
    sub = [5, 1, 6]
    out_sub = paged_attention(q[sub].contiguous(), k, v, pos, tab[sub].contiguous(),
                              qp[sub].contiguous())
    require(torch.equal(out_sub, out[sub]), "paged_attention rows change with B")
    require(torch.equal(out, paged_attention(q, k, v, pos, tab, qp)),
            "paged_attention is not repeatable")
    log("[kernels] paged_attention rows bitwise identical for B in {8,3}; repeatable")
    worst = 0.0
    outs, wants = {}, {}
    for splits, cd in ((4, "bfloat16"), (8, "bfloat16"), (4, "float32")):
        out = paged_attention_fast(q, k, v, pos, tab, qp, kv_splits=splits, combine_dtype=cd)
        want = ref.paged_attention_fast(q, k, v, pos, tab, qp, kv_splits=splits, combine_dtype=cd)
        err = float((out - want).abs().max())
        tol = FAST_ATTN_TOL[cd]
        log(f"[kernels] paged_attention_fast kv_splits={splits} {cd}: "
            f"max_abs_err {err:.3e} (tol {tol:g})")
        require(err <= tol, "paged_attention_fast disagrees with its plain version")
        worst = max(worst, err)
        outs[splits, cd], wants[splits, cd] = out, want
    results["paged_attention_fast"]["max_abs_err"] = worst
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
    one = paged_attention_fast(q, k, v, pos, tab, qp, kv_splits=1, combine_dtype="bfloat16")
    four = outs[4, "bfloat16"]
    require(not torch.equal(one, four), "paged_attention_fast: kv_splits 1 and 4 agree")
    log(f"[kernels] paged_attention_fast kv_splits 1 vs 4 (bf16 combine) differ "
        f"at {int((one != four).sum())} of {one.numel()} outputs")


# ---------------------------------------------------------------------------
# phases 3 and 4: serve, determinism
# ---------------------------------------------------------------------------


def reset_launches():
    from repro_torch.kernels import gemm_batch_invariant, gemm_splitk, paged_attention

    fns = {
        "gemm_batch_invariant": gemm_batch_invariant.gemm_batch_invariant,
        "gemm_splitk": gemm_splitk.gemm_splitk,
        "paged_attention": paged_attention.paged_attention,
        "paged_attention_fast": paged_attention.paged_attention_fast,
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
    # a short warm-up run first: the first run in a process pays lazy CUDA
    # module loading and allocator growth, which the timed runs should not
    serve(Engine(cfg, params, mode=Mode.LLM42, capacity=capacity),
          build_requests(cfg, 2, det_ratio=1.0, max_out=8, seed=1))
    for mode in (Mode.LLM42, Mode.BATCH_INVARIANT, Mode.NONDET):
        eng = Engine(cfg, params, mode=mode, capacity=capacity)
        reqs = build_requests(cfg, n_req, det_ratio=0.5, max_out=max_new, seed=0)
        fns = reset_launches()
        res = serve(eng, reqs)
        counts = {name: fn.launches for name, fn in fns.items()}
        want = expected_launches(cfg, eng)
        log(f"[serve] {mode.value}: kernel launches {counts}; from the engine's "
            f"passes {want}")
        require(counts == want, f"{mode.value}: launches do not match the passes run")
        for name, n in counts.items():
            on_path = name in PATH_KERNELS[mode.value]
            require((n > 0) == on_path, f"{mode.value}: {name} launched {n} times")
        for name, n in counts.items():
            results[name]["launches_by_mode"][mode.value] = n
            results[name]["launches"] += n
        require(res["finished"] == n_req, f"{mode.value}: {res['finished']} finished")
        for r in res["done"]:
            require(len(r.committed) == max_new, f"{mode.value}: rid {r.rid} short")
            require(all(0 <= t < cfg.vocab_size for t in r.committed),
                    f"{mode.value}: token out of range")
        tps = res["committed"] / res["device_s"]
        summary[mode.value] = dict(
            committed=res["committed"], rollbacks=res["rollbacks"],
            recomputed=res["recomputed"], iterations=res["iterations"],
            device_s=res["device_s"], committed_tok_per_s=tps, launches=counts)
        log(f"[serve] {mode.value}: {res['committed']} tokens committed in "
            f"{res['iterations']} iterations, rollbacks {res['rollbacks']}, "
            f"recomputed {res['recomputed']}, device time {res['device_s']} s "
            f"-> {tps} committed tok/s")
    for name, r in results.items():
        require(r["launches"] > 0, f"{name} was never launched on the main path")


#: the kernels each mode's serve run must reach at the serve phase's
#: capacity: its 128-block tables divide every kv_splits of
#: FAST_PATH_POLICY, so only BATCH_INVARIANT decode takes the commit
#: attention kernel (LLM42 and NONDET prefill under the commit GEMM)
PATH_KERNELS = {
    "llm42": ("gemm_batch_invariant", "gemm_splitk", "paged_attention_fast"),
    "batch_invariant": ("gemm_batch_invariant", "paged_attention"),
    "nondet": ("gemm_batch_invariant", "gemm_splitk", "paged_attention_fast"),
}


def expected_launches(cfg, eng):
    """Kernel launches implied by the passes the engine reports: every
    forward runs 7 GEMMs per layer plus the unembedding in the kernel its
    schedule selects, and every decode pass one paged attention launch per
    layer, the fast kernel where its kv_splits divides the table reach."""
    from repro_torch.core.determinism import Schedule

    gemms = 7 * cfg.num_layers + 1
    nblk = eng.pool.layout.blocks_per_table
    want = dict.fromkeys(KERNELS, 0)
    for ev in engine_events(eng):
        if ev["kind"] in ("prefill", "prefill_chunk", "verify"):
            want["gemm_batch_invariant"] += gemms
        elif ev["kind"] == "decode":
            s = Schedule(*ev["schedule"])
            split = s.splits > 1 and s.tp_shards == 1
            want["gemm_splitk" if split else "gemm_batch_invariant"] += gemms
            fast = s.kv_splits > 1 and nblk % s.kv_splits == 0
            want["paged_attention_fast" if fast else "paged_attention"] += cfg.num_layers
    return want


def phase_reference(torch, cfg, params) -> None:
    """Logits of a 2-layer cut of the served weights, on the card (kernels)
    against the CPU (plain versions), for one 16-token prompt."""
    from repro_torch.core.determinism import VERIFY_SCHEDULE
    from repro_torch.models.layers import PagedView
    from repro_torch.models.transformer import forward

    small = dataclasses.replace(cfg, num_layers=2)

    def cut(tree, dev):
        if isinstance(tree, dict):
            return {k: cut(v, dev) for k, v in tree.items()}
        return tree[:2].to(dev) if tree.dim() >= 2 and tree.shape[0] == cfg.num_layers \
            else tree.to(dev)

    def run(dev):
        p = {k: (cut(v, dev) if k == "blocks" else v.to(dev)) for k, v in params.items()}
        pool = {"blocks": {"0": {
            "k": torch.zeros((2, 4, 16, cfg.num_kv_heads, cfg.hd), dtype=p["embed"].dtype, device=dev),
            "v": torch.zeros((2, 4, 16, cfg.num_kv_heads, cfg.hd), dtype=p["embed"].dtype, device=dev),
            "pos": torch.full((2, 4, 16), -1, dtype=torch.int32, device=dev)}}}
        toks = torch.arange(1, 17, dtype=torch.int32, device=dev)[None] * 997 % cfg.vocab_size
        tables = torch.tensor([[0, -1]], dtype=torch.int32, device=dev)
        logits, _, _ = forward(p, small, toks, cache=pool,
                               start_pos=torch.zeros(1, dtype=torch.int32, device=dev),
                               schedule=VERIFY_SCHEDULE, tables=tables,
                               paged=PagedView(16, 2, 3))
        return logits.float().cpu()

    got, want = run(DEV), run("cpu")
    require(got.shape == (1, 16, cfg.vocab_size) and bool(torch.isfinite(got).all()),
            "reference forward: bad shape or non-finite logits")
    diff = (got - want).abs()
    err, mean_err = float(diff.max()), float(diff.mean())
    # the logits are bf16: both sides' f32 sums differ in order only, so a
    # logit may round one bf16 ulp apart (one ulp of max|ref| measured)
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    tol, mean_tol = 2 * ulp, REF_MEAN_ULPS * ulp
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol  # no error within tol flips these
    agree = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    log(f"[serve] reference: 2-layer cut, 16-token prompt, card vs CPU plain "
        f"versions: logits max_abs_err {err:.3e} (tol {tol:.3e} = 2 bf16 ulps of "
        f"max|ref|), mean_abs_err {mean_err:.3e} (tol {mean_tol:.3e}), "
        f"{float((diff == 0).float().mean()):.4f} of logits bitwise equal; argmax "
        f"equal at all {int(clear.sum())}/16 positions whose top-2 margin exceeds "
        f"2 tol: {agree}")
    require(err <= tol and mean_err <= mean_tol, "card logits disagree with the CPU reference")
    # 6 of the 16 positions are clear of near-ties with the seed-0 weights
    require(agree and int(clear.sum()) >= 4, "card argmax disagrees with the CPU reference")


def phase_determinism(torch, cfg, params, summary) -> None:
    """The divergence demo's experiment (examples/dvr_divergence_demo.py)."""
    from repro_torch.core.determinism import Mode, ReductionPolicy
    from repro_torch.core.spans import consistent_spans
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, SamplingParams

    policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                             combine_dtype="bfloat16")
    prompt = list(range(1, 11))

    def run(n_neighbours, mode):
        eng = Engine(cfg, params, mode=mode, policy=policy, window=6, group=2,
                     max_batch=8, capacity=256)
        eng.submit(Request(rid=0, prompt=prompt, sampling=SamplingParams(
            max_new_tokens=48, is_deterministic=mode != Mode.NONDET, seed=7)))
        for i in range(n_neighbours):
            eng.submit(Request(rid=1 + i, prompt=[3 * i + k for k in range(6)],
                               sampling=SamplingParams(max_new_tokens=48)))
        return {r.rid: r for r in eng.run()}[0]

    alone = run(0, Mode.NONDET).committed
    nondet = {}
    for n in (3, 6):
        other = run(n, Mode.NONDET).committed
        s = consistent_spans(alone, other)
        nondet[n] = {"diverged": alone != other, "first_span": s.first_span}
        log(f"[determinism] NONDET vs {n} neighbours: first consistent span "
            f"{s.first_span}/{s.total} (diverged: {alone != other})")
    summary["determinism"] = {"nondet": nondet}
    # both deterministic modes must commit the same stream whatever the
    # decode batch: LLM42 by verification, BATCH_INVARIANT by running every
    # pass under the commit schedule
    for mode in (Mode.LLM42, Mode.BATCH_INVARIANT):
        a = run(0, mode)
        seen = {}
        for n in (3, 6):
            b = run(n, mode)
            same = a.committed == b.committed
            seen[n] = {"identical": same, "rollbacks": b.num_rollbacks}
            log(f"[determinism] {mode.value} vs {n} neighbours: identical={same} "
                f"rollbacks={b.num_rollbacks} recomputed={b.num_recomputed_tokens}")
            require(same, f"{mode.value} stream changed beside {n} neighbours")
        summary["determinism"][mode.value] = seen


def phase_profile(torch, cfg, params, capacity, summary) -> None:
    """Where an LLM42 serve run's time goes: ``torch.profiler`` over a
    repeat of the serve phase's LLM42 run (the timed run itself goes
    unprofiled), device time by kernel and the device's busy share of the
    run (sum of kernel times over the profiled wall time)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.determinism import Mode
    from repro_torch.launch.serve import build_requests, serve
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, mode=Mode.LLM42, capacity=capacity)
    reqs = build_requests(cfg, 8, det_ratio=0.5, max_out=16, seed=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = serve(eng, reqs)
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    averages = prof.key_averages()
    rows = sorted((e for e in averages if e.device_time_total > 0),
                  key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in averages) / 1e6
    log(f"[profile] llm42 run: host wall {wall:.3f} s under the profiler, device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), {res['iterations']} "
        f"iterations; trace summed in {time.perf_counter() - t0:.1f} s")
    for e in rows[:25]:
        log(f"[profile] {e.device_time_total / 1e3:10.1f} ms device "
            f"{e.cpu_time_total / 1e3:10.1f} ms cpu {e.count:7d}x  {e.key[:90]}")
    events = [e for e in engine_events(eng)]
    for kind in ("prefill", "decode", "verify"):
        walls = [ev["wall"] for ev in events if ev["kind"] == kind]
        log(f"[profile] engine {kind}: {len(walls)} passes, {sum(walls):.3f} s wall")
    summary["profile"] = {"wall_s": wall, "device_busy_s": busy}


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


def time_ms(torch, fn, reps=20, flush=None):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events around
    each launch; ``flush`` runs between launches, outside the events)."""
    for _ in range(3):
        fn()
    sync(torch)
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def phase_timings(torch, cfg, results) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
    from repro_torch.kernels.gemm_splitk import gemm_splitk
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_fast,
    )

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
        ms = time_ms(torch, lambda: kernel(x, w), flush=flush)
        plain_ms = time_ms(torch, lambda: plain(x, w), flush=flush)
        lib_ms = time_ms(torch, lambda: torch.matmul(x, w), flush=flush)
        b_ms, b_by = gemm_bound(M, K, N)
        results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             shape=f"({M},{K})@({K},{N}) {extra}")
        log(f"[timings] {name} ({M},{K})@({K},{N}) {extra}: {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")

    # the verify pass's FFN down-projection and the decode batch's
    gemm_row("gemm_batch_invariant", 32, F, D,
             lambda x, w: gemm_batch_invariant(x, w, chunks=4),
             lambda x, w: ref.gemm_batch_invariant(x, w, chunks=4), "chunks=4")
    gemm_row("gemm_splitk", 8, F, D,
             lambda x, w: gemm_splitk(x, w, splits=4, combine_dtype="bfloat16"),
             lambda x, w: ref.gemm_splitk(x, w, 4, "bfloat16"),
             "splits=4 bf16 combine")
    q, k, v, pos, tab, qp, ctx = paged_inputs(
        torch, cfg, 8, 2048, 16, seed=3, min_ctx=512, max_ctx=2048)
    b_ms, b_by = attention_bound(cfg, q, ctx, 16)
    for name, kern, plain, extra in (
        ("paged_attention",
         lambda: paged_attention(q, k, v, pos, tab, qp),
         lambda: ref.paged_attention(q, k, v, pos, tab, qp), ""),
        ("paged_attention_fast",
         lambda: paged_attention_fast(q, k, v, pos, tab, qp, kv_splits=4,
                                      combine_dtype="bfloat16"),
         lambda: ref.paged_attention_fast(q, k, v, pos, tab, qp, kv_splits=4,
                                          combine_dtype="bfloat16"),
         "kv_splits=4 bf16 combine"),
    ):
        ms = time_ms(torch, kern, flush=flush)
        plain_ms = time_ms(torch, plain, reps=5, flush=flush)
        results[name].update(ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by,
                             shape=f"B=8 nblk=128 bs=16 ctx {int(ctx.sum())} keys {extra}")
        log(f"[timings] {name} B=8, {int(ctx.sum())} keys {extra}: {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); no single "
            f"PyTorch call reads K/V through a block table (library_ms null)")


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
                           "bound_ms", "bound_by", "library_ms")}
        for r in results.values()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
