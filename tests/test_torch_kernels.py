"""The port's kernels on the CPU: plain versions against the JAX package.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each one
against the plain versions tested here).  On the CPU each wrapper runs its
plain version, which these tests hold against the JAX reference:

* the GEMMs against the Pallas kernels in interpret mode and against
  ``repro.core.determinism.matmul`` (uneven K cuts included), f32 operands,
  atol 1e-4 (two f32 reduction orders over K <= 1000);
* the paged pair against ``repro.kernels.ref.paged_attention`` (the Pallas
  paged kernels need ``pl.load``, which jax 0.9 no longer has): 1e-5 with
  f32 combine, 2e-2 with bf16.  The bf16 bound is loose on purpose: the port
  keeps the TPU kernel's rounding points (``e`` rounded to bf16 before it is
  summed, the split merge in f32), while the JAX oracle rounds the merged
  ``d`` and ``o`` instead;
* dense-cache decode attention against the Pallas kernel in interpret mode
  (kv_splits 1, 3, 4; f32 and bf16 combine; D = 64; lengths 0 and S
  included): 1e-6 with f32 combine (two f32 summation orders over at most
  96 keys, outputs |o| < 3), 2 bf16 ulps of max|o| with bf16 combine (a
  reordered sum may round the running d or o across a bf16 boundary);
* the fused RMSNorm against the Pallas kernel in interpret mode (D = 300
  f32, D = 256 bf16, with and without a residual): 2 ulps of max|out| in
  the output dtype (the mean over D is summed in another order).

The GEMMs' host side and sources, which the CPU can check: the operand
rules of the tiles (bf16 through TMA: K and N multiples of 8, 16-byte
aligned bases; f32: N a multiple of 4) and that both wrappers apply them
before the device check; every ``build.ENTRY_POINTS`` argtype list against
its ``extern "C"`` signature; and a lint of the commit GEMM's sources (no
atomics; tile, K-step, ring and wgmma shapes as constexpr literals).

Plus the package-level contracts: no JAX and no ``repro`` import anywhere
in the port or ``chip_smoke.py``, ``import repro_torch`` with JAX unimportable,
the host-side copies equal to their originals but for import lines, and
``chip_smoke.py`` refusing to run without a card or outside a checkout.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.determinism import (
    FAST_PATH_POLICY, Schedule, VERIFY_SCHEDULE, deterministic_torch,
)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
from repro_torch.kernels.gemm_splitk import gemm_splitk
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_fast
from repro_torch.kernels.rmsnorm import rmsnorm

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

HOST_COPIES = [
    "serving/request.py", "core/dvr.py", "core/pipeline.py", "core/spans.py",
    "serving/streams.py", "serving/scheduler.py", "serving/prefixcache.py",
    "obs/__init__.py", "obs/metrics.py", "obs/trace.py", "obs/audit.py",
]

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the smoke shapes gain
    nothing from more, and the suite runs several workers on one machine,
    where each worker's spinning torch threads would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xw(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32))


# ---------------------------------------------------------------------------
# GEMMs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (13, 600, 256)])
def test_gemm_batch_invariant_matches_pallas(m, k, n):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.gemm_batch_invariant import gemm_batch_invariant as pallas

    x, w = _xw(m, k, n)
    want = np.asarray(pallas(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = gemm_batch_invariant(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("k", [1024, 1001])
def test_gemm_commit_tree_matches_verify_schedule(k):
    """The commit GEMM's 4-chunk tree is ``determinism.matmul`` under
    VERIFY_SCHEDULE, uneven chunks (K = 1001) included."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import determinism as jdet

    x, w = _xw(6, k, 96, seed=1)
    want = np.asarray(jdet.matmul(jnp.asarray(x), jnp.asarray(w), jdet.VERIFY_SCHEDULE))
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w), VERIFY_SCHEDULE).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("splits", [2, 4])
def test_gemm_splitk_matches_pallas(splits):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.gemm_splitk import gemm_splitk as pallas

    x, w = _xw(8, 512, 128, seed=2)
    want = np.asarray(pallas(jnp.asarray(x), jnp.asarray(w), splits=splits,
                             combine_dtype="float32", bm=8, bn=128, interpret=True))
    got = gemm_splitk(torch.from_numpy(x), torch.from_numpy(w), splits=splits).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("splits,cd", [(3, "float32"), (8, "float32"),
                                       (3, "bfloat16"), (8, "bfloat16")])
def test_gemm_splitk_uneven_k_matches_determinism(splits, cd):
    """K = 1000 is not divisible by 3 or 8: the port cuts it unevenly, as
    ``determinism.matmul`` does on the model path.  bf16 combine: a one-ulp
    flip of a rounded partial may differ, so the bound is 2 bf16 ulps."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import determinism as jdet

    x, w = _xw(4, 1000, 64, seed=3)
    want = np.asarray(jdet.matmul(jnp.asarray(x), jnp.asarray(w),
                                  jdet.Schedule(splits=splits, combine_dtype=cd)))
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                     Schedule(splits=splits, kv_splits=splits, combine_dtype=cd)).numpy()
    tol = 1e-4 if cd == "float32" else 2 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_gemm_split_count_changes_bits():
    x, w = (torch.from_numpy(a) for a in _xw(4, 512, 64, seed=4))
    one = gemm_splitk(x, w, splits=1, combine_dtype="bfloat16")
    eight = gemm_splitk(x, w, splits=8, combine_dtype="bfloat16")
    assert not torch.equal(one, eight)


def test_gemm_commit_rows_independent_of_other_rows():
    """At a fixed shape a row's bits do not depend on the other rows.  (That
    they do not depend on M either is a property of the CUDA kernel, checked
    on the card by ``chip_smoke.py``: the CPU's plain ``matmul`` picks its
    blocking from M.)"""
    x, w = (torch.from_numpy(a) for a in _xw(16, 300, 64, seed=5))
    full = gemm_batch_invariant(x, w, chunks=4)
    y = x.clone()
    y[1:] = torch.randn(15, 300, generator=torch.Generator().manual_seed(0))
    assert torch.equal(gemm_batch_invariant(y, w, chunks=4)[0], full[0])


def test_ops_matmul_routing():
    """VERIFY -> 4-chunk commit tree; splits > K -> one pass; a fast
    schedule -> split-K; un-pinned TP schedules wait."""
    x, w = (torch.from_numpy(a) for a in _xw(3, 64, 32, seed=6))
    assert torch.equal(ops.matmul(x, w, VERIFY_SCHEDULE),
                       ref.gemm_batch_invariant(x, w, chunks=4))
    assert torch.equal(ops.matmul(x, w, Schedule(splits=128)),
                       ref.gemm_batch_invariant(x, w, chunks=1))
    fast = FAST_PATH_POLICY.schedule_for(2)
    assert torch.equal(ops.matmul(x, w, fast),
                       ref.gemm_splitk(x, w, fast.splits, fast.combine_dtype))
    assert ops.matmul(x[None], w, fast).shape == (1, 3, 32)
    with pytest.raises(NotImplementedError):
        ops.matmul(x, w, Schedule(tp_shards=2))


def test_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor valid for the kernel is
    refused: a wrapper runs its plain version only for CPU tensors."""
    x = torch.empty((2, 8), device="meta")
    w = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError):
        gemm_batch_invariant(x, w)
    with pytest.raises(ValueError):
        gemm_splitk(x, w, splits=2)
    q = torch.empty((2, 4, 64), device="meta")
    kv = torch.empty((2, 16, 2, 64), device="meta")
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        rmsnorm(x, torch.empty(8, device="meta"))


# ---------------------------------------------------------------------------
# the GEMMs' host side and sources (the CUDA kernels run only on the card)
# ---------------------------------------------------------------------------


def _bf16(*shape, dtype=torch.bfloat16, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("x,w,error", [
    (_bf16(3, 16), _bf16(16, 24), None),
    (_bf16(3, 12, dtype=torch.float32), _bf16(12, 20, dtype=torch.float32), None),
    (_bf16(3, 12), _bf16(12, 24), "K=12"),  # bf16 rows must be 16-byte strides
    (_bf16(3, 16), _bf16(16, 20), "N=20"),
    (_bf16(3, 12, dtype=torch.float32), _bf16(12, 6, dtype=torch.float32), "N=6"),
    (_bf16(100)[1:49].view(3, 16), _bf16(16, 24), "aligned"),  # base 2 bytes off
    (_bf16(3, 16), _bf16(400)[8:392].view(16, 24), None),  # base 16 bytes off
    (_bf16(3, 16), _bf16(400)[4:388].view(16, 24), "aligned"),
    (_bf16(3, 16), _bf16(16, 24, dtype=torch.float32), "dtypes"),
    (_bf16(3, 16), _bf16(24, 16).t(), "contiguous"),
    (_bf16(3, 16), _bf16(8, 24), "shapes"),
    (_bf16(3, 12, dtype=torch.float32),  # w's base 4 bytes off
     _bf16(300, dtype=torch.float32)[1:241].view(12, 20), "aligned"),
    (_bf16(100, dtype=torch.float32)[1:37].view(3, 12),  # x is read by element
     _bf16(12, 20, dtype=torch.float32), None),
], ids=["bf16", "f32", "bf16-K", "bf16-N", "f32-N", "x-misaligned", "w-16B-offset",
        "w-misaligned", "dtype-mismatch", "non-contiguous", "shape-mismatch",
        "f32-w-misaligned", "f32-x-offset"])
def test_gemm_check_operands(x, w, error):
    """What the GEMM tiles take: bf16 through TMA needs K and N multiples of
    8 and 16-byte-aligned bases; f32 loads w in 16-byte vectors (N a
    multiple of 4, an aligned base) and x by element."""
    from repro_torch.kernels.gemm_batch_invariant import check_operands

    if error is None:
        check_operands("gemm", x, w)
    else:
        with pytest.raises((ValueError, TypeError), match=error):
            check_operands("gemm", x, w)


@pytest.mark.parametrize("k,n,error", [(12, 24, "K=12"), (16, 20, "N=20"), (16, 24, "meta")])
def test_gemm_wrappers_refuse_shapes_before_launch(k, n, error):
    """Off the CPU both wrappers check the operands first and then the
    device: a K or N the tiles do not take raises, and so does a tensor
    that is not on a card; neither falls back to the plain version."""
    x, w = _bf16(3, k, device="meta"), _bf16(k, n, device="meta")
    with pytest.raises(ValueError, match=error):
        gemm_batch_invariant(x, w, chunks=4)
    with pytest.raises(ValueError, match=error):
        gemm_splitk(x, w, splits=4)


CSRC = PORT / "kernels" / "csrc"


def _strip_comments(text: str) -> str:
    import re

    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def _with_headers(name: str):
    """A source and, recursively, the local headers it includes."""
    import re

    seen, todo = [], [name]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += re.findall(r'#include "([^"]+)"', (CSRC / f).read_text())
    return seen


def _c_entry_points(stem: str):
    """``extern "C"`` functions of a kernel library: name -> argument
    types, parsed from its source and the headers it includes."""
    import re

    out = {}
    for f in _with_headers(f"{stem}.cu"):
        text = _strip_comments((CSRC / f).read_text())
        for name, args in re.findall(r'extern "C"[^(]*?(\w+)\s*\(([^)]*)\)', text):
            out[name] = [a.strip() for a in args.split(",") if a.strip()]
    return out


def _entry_point_cases():
    from repro_torch.kernels import build

    return [(stem, name) for stem, fns in build.ENTRY_POINTS.items() for name in fns]


@pytest.mark.parametrize("stem,name", _entry_point_cases())
def test_entry_points_match_c_signatures(stem, name):
    """ctypes passes each argument as its declared type: a pointer declared
    as an int would be cut to 32 bits without a word.  Each entry point's
    argtypes must match its ``extern "C"`` signature in count and kind."""
    import ctypes

    from repro_torch.kernels import build

    args = _c_entry_points(stem)[name]
    kinds = [ctypes.c_void_p if "*" in a else ctypes.c_float if a.startswith("float")
             else ctypes.c_int for a in args]
    assert build.ENTRY_POINTS[stem][name] == kinds, (args, build.ENTRY_POINTS[stem][name])


def test_every_c_entry_point_is_declared():
    from repro_torch.kernels import build

    for stem, fns in build.ENTRY_POINTS.items():
        assert set(_c_entry_points(stem)) - {"repro_error_string"} == set(fns), stem


@pytest.mark.parametrize("source", _with_headers("gemm_batch_invariant.cu"))
def test_commit_gemm_sources_have_no_atomics(source):
    """The commit path's rules: no atomics anywhere in the commit GEMM or
    the headers it includes (comments aside)."""
    assert "atomic" not in _strip_comments((CSRC / source).read_text()).lower()


def test_commit_gemm_tiles_are_literal():
    """Tile sizes, the K step, the ring depth and the wgmma instruction
    shape are constexpr literals (nothing can be chosen from M), and the
    instruction in the source is the one the constants describe: M = the
    tile's 64 output columns, N = its 32 batch rows, K = 16."""
    import re

    text = _strip_comments((CSRC / "gemm_tile.cuh").read_text())
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+);", text))
    for name in ("TC_BN", "TC_BM", "TC_BK", "TC_MMA_K", "TC_STAGES", "TC_CONSUMERS",
                 "BM", "BN", "BK", "THREADS"):
        assert consts.get(name, "").isdigit(), (name, consts.get(name))
    shapes = set(re.findall(r"wgmma\.mma_async\.sync\.aligned\.(m\d+n\d+k\d+)", text))
    assert shapes == {f"m{consts['TC_BN']}n{consts['TC_BM']}k{consts['TC_MMA_K']}"}
    # the batch never picks the tile: M enters the launch only as a count of tiles
    launch = text[text.index("launch_partials<__nv_bfloat16>"):]
    assert "dim3 grid((M + TC_BM - 1) / TC_BM" in launch


def test_gemm_weight_maps_cached_x_maps_per_call():
    """Host cost per call: the bf16 launch takes the weight's tensor map from
    the cache, keyed by all that the map encodes besides its fixed box (base,
    K, N), and encodes x's map on every call."""
    text = _strip_comments((CSRC / "gemm_tile.cuh").read_text())
    launch = text[text.index("launch_partials<__nv_bfloat16>("):]
    launch = launch[:launch.index("launch_partials<float>")]
    assert "weight_map(w, K, N, &wmap)" in launch
    assert "encode_bf16(x, M, K, TC_BM, &xmap)" in launch
    assert "encode_bf16(w, K, N, TC_BK, &map)" in text
    assert "ptr == o.ptr && rows == o.rows && cols == o.cols" in text


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------


def _paged_problem(seed, B=3, H=8, KV=2, D=32, bs=4, nblk=8):
    """Pools with every row owning private blocks for a random context,
    the rest of its table -1 (null block), plus stale positions ahead of
    the query that the mask must hide."""
    rng = np.random.default_rng(seed)
    NB = B * nblk + 2
    k = rng.standard_normal((NB, bs, KV, D)).astype(np.float32)
    v = rng.standard_normal((NB, bs, KV, D)).astype(np.float32)
    pos = np.full((NB, bs), -1, np.int32)
    tables = np.full((B, nblk), -1, np.int32)
    q_pos = np.zeros(B, np.int32)
    for b in range(B):
        length = int(rng.integers(1, nblk * bs))
        n = -(-length // bs)
        blocks = rng.permutation(np.arange(b * nblk, (b + 1) * nblk))[:n]
        tables[b, :n] = blocks
        for j, bid in enumerate(blocks):
            pos[bid] = np.arange(j * bs, (j + 1) * bs)  # tail past length: stale
        q_pos[b] = length - 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, k, v, pos, tables, q_pos, NB - 2


def _jax_ref(problem, **kw):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    q, k, v, pos, tab, qp, nb = problem
    return np.asarray(jref.paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos, tab, qp)), null_bid=nb, **kw))


def _t(problem):
    return tuple(torch.from_numpy(a) for a in problem[:6])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_attention_matches_jax_ref(seed):
    problem = _paged_problem(seed)
    got = paged_attention(*_t(problem), null_bid=problem[6]).numpy()
    np.testing.assert_allclose(got, _jax_ref(problem), atol=1e-5, rtol=0)


@pytest.mark.parametrize("splits,cd,tol", [
    (2, "float32", 1e-5), (4, "float32", 1e-5),
    (2, "bfloat16", 2e-2), (4, "bfloat16", 2e-2),
])
def test_paged_attention_fast_matches_jax_ref(splits, cd, tol):
    problem = _paged_problem(10 + splits)
    got = paged_attention_fast(*_t(problem), kv_splits=splits, combine_dtype=cd,
                               null_bid=problem[6]).numpy()
    want = _jax_ref(problem, kv_splits=splits, combine_dtype=cd)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_paged_null_block_reads_are_masked():
    problem = _paged_problem(7)
    a = paged_attention(*_t(problem))
    q, k, v, pos, tab, qp, nb = _t(problem) + (problem[6],)
    k2, v2 = k.clone(), v.clone()
    k2[nb] = 1e4
    v2[nb] = 1e4
    assert torch.equal(a, paged_attention(q, k2, v2, pos, tab, qp))
    assert bool(torch.isfinite(a).all())


def test_paged_rows_independent_of_batch():
    q, k, v, pos, tab, qp = _t(_paged_problem(8))
    full = paged_attention(q, k, v, pos, tab, qp)
    assert torch.equal(paged_attention(q[1:2], k, v, pos, tab[1:2], qp[1:2]), full[1:2])


def test_paged_split_count_changes_bits():
    problem = _t(_paged_problem(5))
    one = paged_attention_fast(*problem, kv_splits=1, combine_dtype="bfloat16")
    four = paged_attention_fast(*problem, kv_splits=4, combine_dtype="bfloat16")
    assert not torch.equal(one, four)


def test_ops_paged_routing():
    """kv_splits 1 -> commit kernel; a split that does not divide the table
    reach (8 blocks, 3 splits) falls back to the commit kernel; one that
    divides it -> the fast kernel."""
    problem = _t(_paged_problem(9))
    commit = paged_attention(*problem)
    assert torch.equal(ops.paged_attention(*problem, VERIFY_SCHEDULE), commit)
    uneven = Schedule(splits=3, kv_splits=3, combine_dtype="bfloat16")
    assert torch.equal(ops.paged_attention(*problem, uneven), commit)
    fast = Schedule(splits=4, kv_splits=4, combine_dtype="bfloat16")
    assert torch.equal(ops.paged_attention(*problem, fast),
                       paged_attention_fast(*problem, kv_splits=4,
                                            combine_dtype="bfloat16"))


# ---------------------------------------------------------------------------
# dense-cache decode attention, fused RMSNorm
# ---------------------------------------------------------------------------


def _decode_problem(seed, B=4, H=8, KV=2, S=96, D=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    lengths = np.array([0, S, 17, 50][:B], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(splits, cd):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention as pallas

    problem = _decode_problem(20 + splits)
    want = np.asarray(pallas(*(jnp.asarray(a) for a in problem), kv_splits=splits,
                             combine_dtype=cd, interpret=True))
    got = decode_attention(*(torch.from_numpy(a) for a in problem),
                           kv_splits=splits, combine_dtype=cd).numpy()
    tol = 1e-6 if cd == "float32" else float(np.abs(want).max()) * 2.0 ** -7
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert not np.any(got[0])  # lengths 0: nothing to attend, output 0


def test_decode_attention_masked_positions_and_rows():
    """Keys at s >= lengths never leak, and a row's output does not
    depend on the other rows of the batch."""
    q, k, v, lengths = (torch.from_numpy(a) for a in _decode_problem(30))
    base = decode_attention(q, k, v, lengths, kv_splits=4, combine_dtype="bfloat16")
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths.tolist()):
        k2[b, n:] = 1e9
        v2[b, n:] = -1e9
    assert torch.equal(base, decode_attention(q, k2, v2, lengths, kv_splits=4,
                                              combine_dtype="bfloat16"))
    one = decode_attention(q[2:3], k[2:3], v[2:3], lengths[2:3], kv_splits=4,
                           combine_dtype="bfloat16")
    assert torch.equal(one, base[2:3])


def test_ops_decode_attention_routing():
    """A kv_splits that does not divide S (96 keys, 5 splits) falls back to
    one split, as ``repro.kernels.ops.decode_attention`` does."""
    q, k, v, lengths = (torch.from_numpy(a) for a in _decode_problem(31))
    fast = Schedule(splits=4, kv_splits=4, combine_dtype="bfloat16")
    assert torch.equal(ops.decode_attention(q, k, v, lengths, fast),
                       decode_attention(q, k, v, lengths, kv_splits=4,
                                        combine_dtype="bfloat16"))
    uneven = Schedule(splits=5, kv_splits=5, combine_dtype="bfloat16")
    assert torch.equal(ops.decode_attention(q, k, v, lengths, uneven),
                       decode_attention(q, k, v, lengths, kv_splits=1,
                                        combine_dtype="bfloat16"))


@pytest.mark.parametrize("d,dtype", [(300, "float32"), (256, "bfloat16")])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_matches_pallas(d, dtype, with_res):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rmsnorm import rmsnorm as pallas

    rng = np.random.default_rng(d)
    x, res = rng.standard_normal((2, 5, d)).astype(np.float32)
    sc = rng.standard_normal(d).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jres = jnp.asarray(res).astype(jdt) if with_res else None
    want = np.asarray(pallas(jnp.asarray(x).astype(jdt), jnp.asarray(sc), jres,
                             bm=5, interpret=True).astype(jnp.float32))
    tres = torch.from_numpy(res).to(tdt) if with_res else None
    got = ops.rmsnorm(torch.from_numpy(x).to(tdt)[None], torch.from_numpy(sc),
                      tres[None] if with_res else None, eps=1e-5)[0]
    assert got.dtype == tdt
    mant = 23 if dtype == "float32" else 7
    tol = 2 * float(np.abs(want).max()) * 2.0 ** -mant
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_deterministic_torch_restores_flags():
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cuda.matmul.allow_tf32)
    with deterministic_torch():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32) == before


# ---------------------------------------------------------------------------
# package contracts
# ---------------------------------------------------------------------------


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")] + ["chip_smoke.py"]))
def test_port_never_imports_jax_or_repro(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & {"jax", "jaxlib", "repro"}, f"{path} imports {roots}"


def test_import_without_jax():
    """Every module of the port imports with ``jax`` unimportable."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; import repro_torch; "
            f"[importlib.import_module(m) for m in {mods!r}]; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copies_differ_only_in_imports(rel):
    src = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    dst = (PORT / rel).read_text().splitlines()
    assert len(src) == len(dst)
    for a, b in zip(src, dst):
        if a != b:
            assert a.lstrip().startswith(("from repro.", "import repro.")), a
            assert b == a.replace("repro.", "repro_torch.", 1), b


def test_chip_smoke_refuses_without_card(tmp_path):
    """No CUDA device here: the script exits non-zero and prints no result,
    in the checkout and alone in an empty directory."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script), "--phases", "build"],
                             capture_output=True, text=True, env=env,
                             cwd=script.parent, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
