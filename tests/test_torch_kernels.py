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
its ``extern "C"`` signature (the split-K library's partials entry,
``repro_gemm_splitk_partials``, included, with its plain version's chunk
values folded back into ``ref.gemm_splitk`` bit for bit and held against
JAX's ``_tp_partials``); and a lint of the commit GEMM's sources (no
atomics; tile, K-step, ring and wgmma shapes as constexpr literals).

The commit paged kernel the same way: a lint of its source (no atomics; its
key-axis partition, tile and ring as constexpr literals; B in its launch
only as the grid's row count), and a plain model of its fixed
chunk-and-merge order (columns round-robin over the cluster's ranks, an
online softmax per tile, the ranks merged in order) held within 1e-6 of
``ref.paged_attention``: merging a rank with no valid key changes no bit,
and a row's bits are the same alone and in a batch of 8.

The dense decode kernel likewise: a lint of ``csrc/decode_attention.cu``
(no atomics; cluster, tile, ring and merge-round sizes as constexpr
literals; tile t of a chunk to rank t % DA_CLUSTER; B only as the grid's
row count) and a plain model of its order (a chunk's valid keys in tiles
from the chunk's start, tiles round-robin over the ranks, the ranks merged
max first and in rank order, the chunks in split order through
``combine_dtype``) held against ``ref.decode_attention`` and the Pallas
kernel (1e-6 with f32 combine, 2 bf16 ulps with bf16): neutral partials and
skipped trailing chunks change no bit, rows do not depend on B, and at one
split not on S.  And the fused norm: a lint of ``csrc/rmsnorm.cu`` (literal
CTA shape and plan bounds, a plan read from D alone, M only as a count)
and a plain model of its sum tree, within 1 bf16 ulp (4 f32 ulps) of
``ref.rmsnorm`` and 2 of the Pallas kernel, rows independent of M.

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
from repro_torch.kernels.gemm_splitk import gemm_splitk, gemm_splitk_partials
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
    schedule -> split-K; an un-pinned TP schedule -> split-K's TP fold."""
    x, w = (torch.from_numpy(a) for a in _xw(3, 64, 32, seed=6))
    assert torch.equal(ops.matmul(x, w, VERIFY_SCHEDULE),
                       ref.gemm_batch_invariant(x, w, chunks=4))
    assert torch.equal(ops.matmul(x, w, Schedule(splits=128)),
                       ref.gemm_batch_invariant(x, w, chunks=1))
    fast = FAST_PATH_POLICY.schedule_for(2)
    assert torch.equal(ops.matmul(x, w, fast),
                       ref.gemm_splitk(x, w, fast.splits, fast.combine_dtype))
    assert ops.matmul(x[None], w, fast).shape == (1, 3, 32)
    assert torch.equal(ops.matmul(x, w, Schedule(tp_shards=2)),
                       ref.gemm_splitk(x, w, 1, tp_shards=2))


@pytest.mark.parametrize("k,tp,splits,cd", [
    (512, 4, 8, "bfloat16"), (512, 4, 2, "float32"), (1000, 3, 8, "bfloat16"),
    (1000, 4, 300, "float32"), (512, 1, 4, "bfloat16")],
    ids=["tp4-s8-bf16", "tp4-s2-f32", "uneven-tp3-s8", "narrow-chunk", "tp1"])
def test_gemm_splitk_partials_are_the_chunk_values(k, tp, splits, cd):
    """The split-K library's partials entry returns the TP chunk values that
    its fold consumes: its plain version (the CPU wrapper's stack of
    ``ref.gemm_splitk_partials``) folded by the pinned tree, or in order
    through ``combine_dtype``, is ``ref.gemm_splitk`` bit for bit, uneven
    cuts and chunks narrower than ``splits`` included; each chunk is within
    1e-4 (f32 combine) or 2 bf16 ulps of JAX's per-chunk value
    (``repro.core.determinism._tp_partials``)."""
    from repro_torch.core.determinism import torch_dtype, tree_combine

    x, w = (torch.from_numpy(a) for a in _xw(4, k, 64, seed=11))
    vals = gemm_splitk_partials(x, w, splits=splits, combine_dtype=cd, tp_shards=tp)
    assert vals.shape == (tp, 4, 64) and vals.dtype == torch.float32
    parts = list(vals.unbind(0))
    assert torch.equal(tree_combine(parts), ref.gemm_splitk(
        x, w, splits, cd, tp_shards=tp, tp_pinned=True))
    acc = parts[0].to(torch_dtype(cd))
    for p in parts[1:]:
        acc = acc + p.to(torch_dtype(cd))
    want = ref.gemm_splitk(x, w, splits, cd, tp_shards=tp)
    assert torch.equal(acc.float() if tp > 1 else parts[0], want)
    jax = pytest.importorskip("jax")
    from repro.core import determinism as jdet

    jparts = jdet._tp_partials(jax.numpy.asarray(x.numpy()), jax.numpy.asarray(w.numpy()),
                               jdet.Schedule(splits=splits, combine_dtype=cd, tp_shards=tp))
    for got, jp in zip(parts, jparts):
        jp = np.asarray(jp)
        tol = 1e-4 if cd == "float32" else 2 * 2.0 ** -8 * np.abs(jp).max()
        np.testing.assert_allclose(got.numpy(), jp, atol=tol, rtol=0)


def test_wrappers_never_fall_back():
    """A wrapper runs its plain version only for CPU tensors: meta operands
    (the dry run) get an empty meta output of the kernel's shape, nothing
    computed, no launch counted; operands that are not all on the CPU, one
    card or the meta device are refused."""
    x = torch.empty((2, 8), device="meta")
    w = torch.empty((8, 8), device="meta")
    q = torch.empty((2, 4, 64), device="meta")
    kv = torch.empty((2, 16, 2, 64), device="meta")
    lengths = torch.empty(2, dtype=torch.int32, device="meta")
    before = gemm_batch_invariant.launches
    for out, shape in ((gemm_batch_invariant(x, w), (2, 8)),
                       (gemm_splitk(x, w, splits=2), (2, 8)),
                       (gemm_splitk_partials(x, w, splits=2, tp_shards=2), (2, 2, 8)),
                       (decode_attention(q, kv, kv, lengths), (2, 4, 64)),
                       (rmsnorm(x, torch.empty(8, device="meta")), (2, 8))):
        assert out.device.type == "meta" and tuple(out.shape) == shape
    assert gemm_batch_invariant.launches == before
    w_cpu = torch.empty((8, 8))
    with pytest.raises(ValueError):
        gemm_batch_invariant(x, w_cpu)
    with pytest.raises(ValueError):
        gemm_splitk(x, w_cpu, splits=2)
    with pytest.raises(ValueError):
        gemm_splitk_partials(x, w_cpu, splits=2)
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, torch.empty(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        rmsnorm(x, torch.empty(8))


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
    device: a K or N the tiles do not take raises (on meta tensors too, as
    the dry run calls them), and so does an operand pair that is not on one
    card or the meta device; neither falls back to the plain version."""
    x = _bf16(3, k, device="meta")
    w = _bf16(k, n, device="cpu" if error == "meta" else "meta")
    with pytest.raises(ValueError, match=error):
        gemm_batch_invariant(x, w, chunks=4)
    with pytest.raises(ValueError, match=error):
        gemm_splitk(x, w, splits=4)
    with pytest.raises(ValueError, match=error):
        gemm_splitk_partials(x, w, splits=4, tp_shards=2)


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


@pytest.mark.parametrize("source", _with_headers("gemm_batch_invariant.cu") + ["gemm_grad.cu"])
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


def test_gemm_grad_lint_is_clean():
    """The backward products' source passes the determinism contract's
    kernel lint with no finding, no allowlist entry and no fast-path
    exemption; its tile, K step, ring, warpgroups and wgmma shape are
    constexpr literals, the instruction in the source is the one they
    describe (M = 64 rows a consumer warpgroup, N = the tile's 256
    columns, K = 16), and M enters the launch only as a count of tiles."""
    import re

    from repro_torch.analysis import kernel_lint

    rel = "src/repro_torch/kernels/csrc/gemm_grad.cu"
    assert kernel_lint.lint_file(CSRC / "gemm_grad.cu", rel) == []
    assert not [f for f in kernel_lint.run_pass(ROOT) if f.where.startswith(rel)]
    allow = (PORT / "analysis" / "allowlist.toml").read_text()
    raw = (CSRC / "gemm_grad.cu").read_text()
    assert "gemm_grad" not in allow and "det: fastpath" not in raw
    text = _strip_comments(raw)
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+);", text))
    for name in ("GP_BM", "GP_BN", "GP_BK", "GP_MMA_K", "GP_STAGES", "GP_ATOM", "GP_WG"):
        assert consts.get(name, "").isdigit(), (name, consts.get(name))
    shapes = set(re.findall(r"wgmma\.mma_async\.sync\.aligned\.(m\d+n\d+k\d+)", text))
    assert shapes == {f"m64n{consts['GP_BN']}k{consts['GP_MMA_K']}"}
    assert int(consts["GP_BM"]) == 2 * 64  # two consumer warpgroups of 64 rows
    launch = text[text.index("cudaError_t launch_grad("):]
    assert "dim3 grid((M + GP_BM - 1) / GP_BM, (N + GP_BN - 1) / GP_BN);" in launch
    # one launch a product: no workspace, no second kernel
    assert launch[:launch.index('extern "C"')].count("<<<") == 1


@pytest.mark.parametrize("shape,view,want", [
    ((4, 16), lambda t: t, (0, 16)),
    ((16, 8), lambda t: t.t(), (1, 8)),
    ((4, 24), lambda t: t[:, :12], (0, 24)),          # a column slice keeps its stride
    ((4, 20), lambda t: t, (-1, 0)),                  # a row stride of 40 bytes
    ((4, 17), lambda t: t[:, 1:], (-1, 0)),           # base 2 bytes off
    ((4, 16), lambda t: t[:, ::2], (-1, 0)),          # no unit stride
], ids=["rows", "transposed", "slice", "unaligned-stride", "unaligned-base", "strided"])
def test_gemm_grad_operand_layout(shape, view, want):
    """Which views ``gemm_grad`` reads in place (TMA: a unit stride, a
    leading stride of a multiple of 8 bf16, a 16-byte-aligned base), and
    the aligned copy it makes of the others: row-major, its stride
    rounded up to a multiple of 8, the same values."""
    from repro_torch.kernels.gemm_grad import aligned_rows, operand_layout

    t = view(torch.arange(shape[0] * shape[1], dtype=torch.float32)
             .reshape(shape).bfloat16())
    assert operand_layout(t) == want
    if want[0] < 0:
        c = aligned_rows(t)
        assert torch.equal(c, t) and operand_layout(c)[0] == 0
        assert c.stride(0) % 8 == 0 and c.stride(0) - t.shape[1] < 8


def test_gemm_grad_meta_and_refusals():
    """``gemm_grad`` on meta views (the dry run) gives a meta output of the
    product's shape, counting no launch; bf16 only, one device, and never
    the plain version off the CPU."""
    from repro_torch.kernels.gemm_grad import gemm_grad

    before = gemm_grad.launches
    a = torch.empty((24, 13), dtype=torch.bfloat16, device="meta")
    out = gemm_grad(a.t(), a)
    assert out.device.type == "meta" and tuple(out.shape) == (13, 13)
    assert out.dtype == torch.bfloat16 and gemm_grad.launches == before
    with pytest.raises(TypeError, match="bf16"):
        gemm_grad(a.float().t(), a.float())
    with pytest.raises(ValueError, match="meta"):
        gemm_grad(a.t(), torch.empty((24, 13), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        gemm_grad(a, a)


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
# the commit paged kernel's source and its chunk-and-merge order
# ---------------------------------------------------------------------------


def _consts(name: str):
    """The ``constexpr int`` constants of a source that are integer literals."""
    import re

    text = _strip_comments((CSRC / name).read_text())
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _source_part(name: str, start: str, end: str) -> str:
    text = _strip_comments((CSRC / name).read_text())
    body = text[text.index(start):]
    return body[:body.index(end)]


@pytest.mark.parametrize("source", _with_headers("paged_attention.cu"))
def test_paged_sources_have_no_atomics(source):
    """The commit path's rules: no atomics in the paged kernels' source or
    the headers it includes (comments aside)."""
    assert "atomic" not in _strip_comments((CSRC / source).read_text()).lower()


def test_commit_paged_partition_is_literal():
    """The commit kernel's key-axis partition (cluster size, columns per
    chunk), its tile and its ring are constexpr integer literals, and the
    kernel reads them, not anything that could follow B, kv_splits, the
    contexts or the card."""
    consts = _consts("paged_attention.cu")
    for name in ("PA_CLUSTER", "PA_CHUNK_BLOCKS", "PA_TILE_KEYS", "PA_STAGES", "PA_WINDOW"):
        assert name in consts, name
    kernel = _source_part("paged_attention.cu", "paged_attention_kernel(const T*",
                          "paged_split_kernel")
    assert "__cluster_dims__(PA_CLUSTER, 1, 1)" in _source_part(
        "paged_attention.cu", "__global__ void __cluster_dims__(PA_CLUSTER",
        "paged_attention_kernel(")
    assert "PA_CLUSTER, PA_CHUNK_BLOCKS}" in kernel  # the slice of a rank
    for word in ("gridDim", "splits", "combine", "clock", "smid"):
        assert word not in kernel, word
    # the merge: the ranks' max first, then the sums in rank order
    assert "for (int c = 0; c < PA_CLUSTER; ++c) M = fmaxf(M, " in kernel
    assert "float M = -1e30f;" in kernel
    assert "Lsum += p[1] * wc;" in kernel


def test_commit_paged_launch_takes_b_as_a_count_of_rows():
    """B enters the commit launch only as the grid's row axis."""
    import re

    launch = _source_part("paged_attention.cu", "cudaError_t launch_commit(",
                          "cudaError_t launch_fast(")
    assert "dim3(PA_CLUSTER, a.KV, B)" in launch
    uses = re.findall(r"\bB\b", launch)
    assert len(uses) == 2, uses  # the parameter and the grid


def _commit_model(q, k, v, pos, tables, q_pos, parts_hook=None):
    """A plain model of the commit kernel's order, in f32: table column t
    goes to rank (t // PA_CHUNK_BLOCKS) % PA_CLUSTER; a rank walks its
    columns in order, each block in tiles of PA_TILE_KEYS keys, one online
    softmax update per tile; the ranks' partials merge with their max M
    first (from -1e30), then l and o summed in rank order with weights
    exp(m_c - M).  ``parts_hook`` may edit the list of partials of a (row,
    KV head) before the merge."""
    c = _consts("paged_attention.cu")
    CL, CH, TK = c["PA_CLUSTER"], c["PA_CHUNK_BLOCKS"], c["PA_TILE_KEYS"]
    B, H, D = q.shape
    _, bs, KV, _ = k.shape
    G, nblk = H // KV, tables.shape[1]
    f32 = torch.float32
    out = torch.empty((B, H, D), dtype=f32)

    def neutral():
        return (torch.full((G,), -1e30), torch.zeros(G), torch.zeros(G, D))

    for b in range(B):
        for h in range(KV):
            qs = q[b, h * G:(h + 1) * G].to(f32) * (D ** -0.5)
            parts = []
            for r in range(CL):
                m, l, o = neutral()
                for t in range(nblk):
                    bid = int(tables[b, t])
                    if (t // CH) % CL != r or bid < 0:
                        continue
                    for j0 in range(0, bs, TK):
                        kk = k[bid, j0:j0 + TK, h].to(f32)
                        vv = v[bid, j0:j0 + TK, h].to(f32)
                        pp = pos[bid, j0:j0 + TK]
                        s = (qs @ kk.T).masked_fill(~((pp >= 0) & (pp <= q_pos[b])),
                                                    float("-inf"))
                        mn = torch.maximum(m, s.amax(dim=-1))
                        alpha = torch.exp(m - mn)
                        p = torch.exp(s - mn[:, None])
                        l = l * alpha + p.sum(dim=-1)
                        o = o * alpha[:, None] + p @ vv
                        m = mn
                parts.append((m, l, o))
            if parts_hook is not None:
                parts = parts_hook(parts, neutral)
            out[b, h * G:(h + 1) * G] = _commit_merge(parts, neutral())
    return out


def _rank_merge(parts, start):
    """The ranks' partials merged as the kernels merge them: the max M
    first (from start's m), then l and o summed in rank order with weights
    exp(m_c - M).  Returns (M, l, o)."""
    m, l, o = start
    for mc, _, _ in parts:
        m = torch.maximum(m, mc)
    for mc, lc, oc in parts:
        w = torch.exp(mc - m)
        l = l + lc * w
        o = o + oc * w[:, None]
    return m, l, o


def _commit_merge(parts, start):
    _, l, o = _rank_merge(parts, start)
    return o / l.clamp_min(1e-30)[:, None]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_paged_model_matches_refs(seed):
    """The commit kernel's chunk-and-merge order computes the plain
    version's function: within 1e-6 of ``ref.paged_attention`` (two f32
    summation orders, outputs |o| < 3), and of the JAX oracle as the plain
    version is (1e-5)."""
    problem = _paged_problem(seed)
    got = _commit_model(*_t(problem))
    want = ref.paged_attention(*_t(problem), null_bid=problem[6])
    assert float((got - want).abs().max()) <= 1e-6
    np.testing.assert_allclose(got.numpy(), _jax_ref(problem), atol=1e-5, rtol=0)


def test_commit_paged_model_neutral_partials_change_no_bit():
    """A rank with no valid key (no block, or only masked positions) yields
    the neutral partial, and merging it anywhere changes no bit; so the
    same rows at a wider table reach (more -1 columns) keep their bits."""
    problem = _t(_paged_problem(3, B=4))
    base = _commit_model(*problem)
    for at in (0, 2, 5):
        def hook(parts, neutral, at=at):
            return parts[:at] + [neutral(), neutral()] + parts[at:]
        assert torch.equal(_commit_model(*problem, parts_hook=hook), base)
    q, k, v, pos, tab, qp = problem
    wide = torch.full((tab.shape[0], 5 * tab.shape[1]), -1, dtype=tab.dtype)
    wide[:, : tab.shape[1]] = tab
    assert torch.equal(_commit_model(q, k, v, pos, wide, qp), base)
    # a block whose positions are all past q_pos is masked whole
    stale = pos.clone()
    free = [b for b in range(k.shape[0] - 2) if not bool((tab == b).any())][0]
    stale[free] = 10_000
    tab2 = wide.clone()
    tab2[:, tab.shape[1]] = free
    assert torch.equal(_commit_model(q, k, v, stale, tab2, qp), base)


def test_commit_paged_model_rows_independent_of_batch():
    """A row's bits are the same alone (B = 1) and in a batch of 8."""
    q, k, v, pos, tab, qp = _t(_paged_problem(4, B=8))
    full = _commit_model(q, k, v, pos, tab, qp)
    for b in (0, 5, 7):
        alone = _commit_model(q[b:b + 1], k, v, pos, tab[b:b + 1], qp[b:b + 1])
        assert torch.equal(alone[0], full[b])


# ---------------------------------------------------------------------------
# the dense decode kernel's source and its tile, rank and chunk order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", _with_headers("decode_attention.cu"))
def test_decode_sources_have_no_atomics(source):
    """The commit path's rules: no atomics in the dense decode kernel's
    source or the headers it includes (comments aside)."""
    assert "atomic" not in _strip_comments((CSRC / source).read_text()).lower()


def test_decode_partition_is_literal():
    """The dense decode kernel's key-axis partition (cluster size, tile),
    its ring and its merge rounds are constexpr integer literals; a tile
    goes to rank t % DA_CLUSTER by its index t in its chunk alone; the
    kernel reads nothing that could follow B, the lengths or the card; the
    ranks merge with their max first and their sums in rank order."""
    consts = _consts("decode_attention.cu")
    for name in ("DA_CLUSTER", "DA_TILE_KEYS", "DA_STAGES", "DA_MAX_ROUND", "GMAX"):
        assert name in consts, name
    src = "decode_attention.cu"
    assert "__cluster_dims__(DA_CLUSTER, 1, 1)" in _source_part(
        src, "template <typename T, int E, int D>\n__global__", "decode_attention_kernel(")
    kernel = _source_part(src, "decode_attention_kernel(const T*", "cudaError_t launch(")
    chunks = _source_part(src, "struct Chunks {", "};")
    # tile t of a chunk: rank t % DA_CLUSTER (the rank's tiles r, r + C, ...)
    assert "return n > r ? (n - 1 - r) / DA_CLUSTER + 1 : 0;" in chunks
    assert ("return ch.start(c) + (ch.r + (u - first) * DA_CLUSTER) * DA_TILE_KEYS;"
            in _source_part(src, "struct Cursor {", "};"))
    for word in ("gridDim", "clock", "smid", "atomic"):
        assert word not in kernel, word
    # the ranks' max first, then the sums in rank order; the chunks in
    # split order through combine_dtype
    assert "for (int rr = 0; rr < DA_CLUSTER; ++rr) M = fmaxf(M, " in kernel
    assert "float M = -1e30f;" in kernel
    assert "dc += p[1] * w;" in kernel
    assert "for (int c = c0; c < c1; ++c) {" in kernel
    assert "d_run = round_to(dc, a.combine);" in kernel


def test_decode_launch_takes_b_as_a_count_of_rows():
    """B enters the launch only as the grid's row axis."""
    import re

    launch = _source_part("decode_attention.cu", "cudaError_t launch(", "extern \"C\"")
    assert "dim3(DA_CLUSTER, a.KV, B)" in launch
    uses = re.findall(r"\bB\b", launch)
    assert len(uses) == 2, uses  # the parameter and the grid


def _decode_model(q, k, v, lengths, kv_splits, combine_dtype="float32", *,
                  parts_hook=None, skip_trailing=True):
    """A plain model of the dense decode kernel's order, in f32: the chunks
    of ``_split_sizes(S, kv_splits)``; a chunk's valid keys cut into tiles
    of DA_TILE_KEYS from the chunk's start; tile t to rank t % DA_CLUSTER,
    each rank one online-softmax update per tile; the ranks merged by
    ``_rank_merge``; the chunk triples merged in split order with d and o
    rounded through ``combine_dtype`` at the first chunk and after every
    merge.  ``skip_trailing`` skips the chunks after the first that start at
    or past the row's length, as the kernel does; ``parts_hook`` may edit a
    chunk's list of rank partials before the merge."""
    from repro_torch.core.determinism import _split_sizes

    c = _consts("decode_attention.cu")
    CL, TK = c["DA_CLUSTER"], c["DA_TILE_KEYS"]
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    f32, cd = torch.float32, getattr(torch, combine_dtype)
    out = torch.empty((B, H, D), dtype=f32)

    def neutral():
        return (torch.full((G,), -1e30), torch.zeros(G), torch.zeros(G, D))

    def rnd(t):
        return t.to(cd).to(f32)

    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        for h in range(KV):
            qs = q[b, h * G:(h + 1) * G].to(f32) * (D ** -0.5)
            start = 0
            for ci, size in enumerate(_split_sizes(S, kv_splits)):
                if skip_trailing and ci > 0 and start >= n:
                    break
                vend = min(start + size, n)
                ntile = -(-max(vend - start, 0) // TK)
                parts = []
                for r in range(CL):
                    m, l, o = neutral()
                    for t in range(r, ntile, CL):
                        k0 = start + t * TK
                        kk = k[b, k0:min(k0 + TK, vend), h].to(f32)
                        vv = v[b, k0:min(k0 + TK, vend), h].to(f32)
                        s = qs @ kk.T
                        mn = torch.maximum(m, s.amax(dim=-1))
                        alpha = torch.exp(m - mn)
                        p = torch.exp(s - mn[:, None])
                        l = l * alpha + p.sum(dim=-1)
                        o = o * alpha[:, None] + p @ vv
                        m = mn
                    parts.append((m, l, o))
                if parts_hook is not None:
                    parts = parts_hook(parts, neutral)
                mc, dc, oc = _rank_merge(parts, neutral())
                if ci == 0:
                    m_run, d_run, o_run = mc, rnd(dc), rnd(oc)
                else:
                    m_new = torch.maximum(m_run, mc)
                    a1, a2 = torch.exp(m_run - m_new), torch.exp(mc - m_new)
                    d_run = rnd(a1 * d_run + a2 * dc)
                    o_run = rnd(a1[:, None] * o_run + a2[:, None] * oc)
                    m_run = m_new
                start += size
            out[b, h * G:(h + 1) * G] = o_run / d_run.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("splits,S", [(1, 96), (4, 96), (4, 100), (3, 99)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_model_matches_refs(splits, S, cd):
    """The dense kernel's tile, rank and chunk order computes the plain
    version's function and the Pallas kernel's (interpret mode), at S a
    multiple of the tile and not (chunks of 25 and 33 keys): within 1e-6
    with f32 combine (two f32 summation orders over at most 100 keys,
    outputs |o| < 3), 2 bf16 ulps of max|o| with bf16 combine (a reordered
    sum may round the running d or o across a bf16 boundary)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention as pallas

    problem = _decode_problem(40 + splits, S=S)
    got = _decode_model(*(torch.from_numpy(a) for a in problem), splits, cd)
    want = ref.decode_attention(*(torch.from_numpy(a) for a in problem), splits, cd)
    jax_want = np.asarray(pallas(*(jnp.asarray(a) for a in problem), kv_splits=splits,
                                 combine_dtype=cd, interpret=True))
    tol = 1e-6 if cd == "float32" else float(want.abs().max()) * 2.0 ** -7
    assert float((got - want).abs().max()) <= tol
    np.testing.assert_allclose(got.numpy(), jax_want, atol=tol, rtol=0)
    assert not bool(got[0].abs().max())  # length 0: output 0


def test_decode_model_matches_ref_at_uneven_chunks():
    """S = 100 in 3 chunks (34, 33, 33 keys: _split_sizes' uneven cut, which
    the Pallas kernel does not take), against the plain version."""
    problem = [torch.from_numpy(a) for a in _decode_problem(45, S=100)]
    for cd, tol in (("float32", 1e-6), ("bfloat16", None)):
        want = ref.decode_attention(*problem, 3, cd)
        tol = tol or float(want.abs().max()) * 2.0 ** -7
        assert float((_decode_model(*problem, 3, cd) - want).abs().max()) <= tol


def test_decode_model_rows_independent_of_batch():
    """A row's bits are the same alone (B = 1) and in a batch of 4, at the
    commit schedule and at the fast one."""
    q, k, v, lengths = (torch.from_numpy(a) for a in _decode_problem(46))
    for splits, cd in ((1, "float32"), (4, "bfloat16")):
        full = _decode_model(q, k, v, lengths, splits, cd)
        for b in range(4):
            alone = _decode_model(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths[b:b + 1],
                                  splits, cd)
            assert torch.equal(alone[0], full[b])


def test_decode_model_neutral_partials_change_no_bit():
    """Neutral partials merged anywhere among a chunk's ranks change no bit,
    and neither does skipping the trailing empty chunks (rows of 0 and 17
    keys in 4 chunks of 24: chunks 1-3 are empty)."""
    problem = [torch.from_numpy(a) for a in _decode_problem(47)]
    for splits, cd in ((4, "bfloat16"), (4, "float32"), (1, "float32")):
        base = _decode_model(*problem, splits, cd)
        for at in (0, 3, 8):
            def hook(parts, neutral, at=at):
                return parts[:at] + [neutral(), neutral()] + parts[at:]
            assert torch.equal(_decode_model(*problem, splits, cd, parts_hook=hook), base)
        assert torch.equal(_decode_model(*problem, splits, cd, skip_trailing=False), base)


def test_decode_model_kv_splits_1_bits_do_not_depend_on_s():
    """At kv_splits 1 the same rows in a 96- and a 400-slot view (other
    random keys past slot 96, which no length reaches) give the same bits."""
    q, k, v, lengths = (torch.from_numpy(a) for a in _decode_problem(48))
    rng = np.random.default_rng(49)
    wide_k, wide_v = (torch.from_numpy(rng.standard_normal((4, 400, 2, 64)).astype(np.float32))
                      for _ in range(2))
    wide_k[:, :96], wide_v[:, :96] = k, v
    assert torch.equal(_decode_model(q, k, v, lengths, 1),
                       _decode_model(q, wide_k, wide_v, lengths, 1))


# ---------------------------------------------------------------------------
# the fused norm's source and its sum tree
# ---------------------------------------------------------------------------


def test_rmsnorm_tree_is_literal():
    """The norm's CTA shape and the bounds of its plan are constexpr
    literals, the plan reads D and the element size alone, and M enters
    the launch only as a count (the grid, and the last CTA's row mask)."""
    import re

    consts = _consts("rmsnorm.cu")
    for name in ("RN_WARPS", "RN_MAX_VPT", "RN_MAX_CLUSTER", "RN_SM_CTAS"):
        assert name in consts, name
    text = _strip_comments((CSRC / "rmsnorm.cu").read_text())
    assert "atomic" not in text.lower()
    plan = _source_part("rmsnorm.cu", "Plan plan(int D, int elt) {", "\n}\n")
    assert not re.search(r"\bM\b", plan)
    kernel = _source_part("rmsnorm.cu", "rmsnorm_kernel(const T*",
                          "cudaError_t launch_vpt(")
    assert len(re.findall(r"\bM\b", kernel)) == 2  # the parameter and the row mask
    assert "const bool live = row < M;" in kernel
    launch = _source_part("rmsnorm.cu", "cudaError_t launch_vpt(", "extern \"C\"")
    lines = [ln.strip() for ln in launch.splitlines() if re.search(r"\bM\b", ln)]
    assert all(ln.startswith(("int M, int D", "cfg.gridDim = dim3(", "static_cast<T*>(out), M",
                              "int M, int D, float eps", "if (p.cl > RN_MAX_CLUSTER",
                              "case ", "default: "))
               for ln in lines), lines
    # the tree: lanes in vector and element order, an xor butterfly, the
    # row's segments in order
    assert "ss = fmaf(xp[k].get(e), xp[k].get(e), ss);" in kernel
    assert "for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(" in kernel
    assert "for (int i = 0; i < nseg; ++i) total = __fadd_rn(total, seg_sum[first + i]);" in kernel


def _rmsnorm_plan(D, elt):
    """csrc/rmsnorm.cu::plan: (vectors a lane, warps a row)."""
    c = _consts("rmsnorm.cu")
    V = 16 // elt
    nvec = -(-D // V)
    vpt = 1
    while vpt < c["RN_MAX_VPT"] and nvec > 32 * vpt * c["RN_WARPS"]:
        vpt *= 2
    nseg = 1
    while nseg * 32 * vpt < nvec:
        nseg *= 2
    return vpt, nseg


def _rmsnorm_model(x, scale, eps=1e-5, residual=None):
    """A plain model of the norm kernel's sum tree, vectorised over rows:
    element j = ((seg * VPT + k) * 32 + lane) * V + e of a row, zero past
    D; each lane adds its squares over (k, e) in order; an xor butterfly
    over the 32 lanes; the segments in order.  Products and sums are each
    rounded (the kernel fuses them), so it models the order, not the bits."""
    M, D = x.shape
    V = 16 // x.element_size()
    vpt, nseg = _rmsnorm_plan(D, x.element_size())
    if residual is not None:
        x = (x.float() + residual.float()).to(x.dtype)
    xf = x.float()
    padded = torch.zeros((M, nseg * vpt * 32 * V))
    padded[:, :D] = xf
    sq = (padded * padded).reshape(M, nseg, vpt, 32, V)
    lane = torch.zeros((M, nseg, 32))
    for k_ in range(vpt):
        for e in range(V):
            lane = lane + sq[:, :, k_, :, e]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lane = lane + lane[..., idx ^ o]
    total = torch.zeros(M)
    for s_ in range(nseg):
        total = total + lane[:, s_, 0]
    inv = torch.rsqrt(total / D + eps)
    return (xf * inv[:, None] * scale.float()).to(x.dtype)


@pytest.mark.parametrize("d,dtype", [(300, "float32"), (4096, "bfloat16"),
                                     (256, "bfloat16"), (9000, "bfloat16")])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_model_matches_refs(d, dtype, with_res):
    """The norm kernel's sum tree computes the plain version's function and
    the Pallas kernel's (interpret mode): within 1 ulp of max|out| in the
    output dtype of ``ref.rmsnorm`` for bf16 (the sum's order moves
    rsqrt by an f32 ulp or so), 4 for f32, and within the Pallas test's 2
    ulps of the Pallas kernel."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rmsnorm import rmsnorm as pallas

    rng = np.random.default_rng(d + 1)
    x, res = rng.standard_normal((2, 5, d)).astype(np.float32)
    sc = rng.standard_normal(d).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    tx, tres = torch.from_numpy(x).to(tdt), torch.from_numpy(res).to(tdt)
    tres = tres if with_res else None
    got = _rmsnorm_model(tx, torch.from_numpy(sc), residual=tres).float()
    want = ref.rmsnorm(tx, torch.from_numpy(sc), 1e-5, tres).float()
    mant = 23 if dtype == "float32" else 7
    ulp = float(want.abs().max()) * 2.0 ** -mant
    assert float((got - want).abs().max()) <= (4 if dtype == "float32" else 1) * ulp
    jres = jnp.asarray(res).astype(jdt) if with_res else None
    jax_want = np.asarray(pallas(jnp.asarray(x).astype(jdt), jnp.asarray(sc), jres,
                                 bm=5, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.numpy(), jax_want, atol=2 * ulp, rtol=0)


def test_rmsnorm_model_rows_independent_of_m():
    """The plan reads D alone, so a row's bits are the same in batches of 1,
    5 and 13 rows and at any place in them."""
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.standard_normal((13, 4096)).astype(np.float32)).to(torch.bfloat16)
    sc = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).to(torch.bfloat16)
    full = _rmsnorm_model(x, sc)
    for m in (1, 5, 13):
        assert torch.equal(_rmsnorm_model(x[:m], sc), full[:m])
    assert torch.equal(_rmsnorm_model(x[7:9], sc), full[7:9])


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


# ---------------------------------------------------------------------------
# head dims off the 32-element grid (kimi-k2's D = 112)
# ---------------------------------------------------------------------------

#: the head dims the attention kernels take: D % 16 == 0, 16 <= D <= 256
HEAD_DIMS = tuple(range(16, 257, 16))


def test_attention_dispatch_instantiates_every_head_dim():
    """``REPRO_DISPATCH_D`` gives each head dim an instantiation of its own
    (D = 112 among them), with E = ceil(D / 32) lanes' worth a lane; both
    attention sources dispatch through it with ``E_, D_`` and refuse the
    same dims their entry points check."""
    import re

    tile = _strip_comments((CSRC / "attention_tile.cuh").read_text())
    cases = [int(d) for d in re.findall(r"REPRO_CASE_D\((\d+), CALL\)", tile)]
    assert tuple(cases) == HEAD_DIMS
    assert "constexpr int D_ = DV, E_ = (DV + 31) / 32;" in tile
    assert "REPRO_DISPATCH_E" not in tile
    for name in ("paged_attention.cu", "decode_attention.cu"):
        text = _strip_comments((CSRC / name).read_text())
        dispatches = re.findall(r"REPRO_DISPATCH_D\(D, return \(int\)\((\w+)<([^>]*)>", text)
        assert dispatches and all(args.endswith("E_, D_") for _, args in dispatches), name
    paged = _strip_comments((CSRC / "paged_attention.cu").read_text())
    assert "D % 16 == 0 && D >= 16 && D <= 256" in paged
    dense = _strip_comments((CSRC / "decode_attention.cu").read_text())
    assert "D % 16 || D < 16 || D > 256" in dense


def test_d32_instantiations_mask_nothing():
    """At D = 32 * E the templates' default D and ``live`` (a compile-time
    ``true``) leave those instantiations unmasked, the code they had before
    masked widths existed; a masked element (D < 32 * E) is never loaded,
    accumulated or stored: every store of o in both sources and every V
    term sits behind ``live``."""
    import re

    tile = _strip_comments((CSRC / "attention_tile.cuh").read_text())
    assert "template <typename T, int E, int D = 32 * E>" in tile
    live = tile[tile.index("bool live(int lane, int e)"):]
    live = live[:live.index("\n}\n")]
    assert "if constexpr (D == 32 * E) {\n    return true;" in live
    assert "if (live<E, D>(lane, e)) o[e] = fmaf(wj, v[e], o[e]);" in tile
    for name, stores in (("paged_attention.cu", (r"dst\[e\] = ", r"o_part\[row \* D")),
                         ("decode_attention.cu", (r"store_as\(dst \+ e",))):
        text = _strip_comments((CSRC / name).read_text())
        for pattern in stores:
            found = list(re.finditer(pattern, text))
            assert found, (name, pattern)
            for m in found:
                line = text[text.rindex("\n", 0, m.start()) + 1:m.start()]
                assert "if (live<E, D>(" in line, (name, line)


def test_wrappers_take_every_head_dim_the_kernels_take():
    """The wrappers refuse, before a launch, the head dims the entry points
    refuse: the same ``D % 16`` and ``16 <= D <= 256``."""
    for name in ("paged_attention.py", "decode_attention.py"):
        text = (PORT / "kernels" / name).read_text()
        assert "D % 16 or not 16 <= D <= 256" in text, name


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_paged_model_matches_refs_at_d112(seed):
    """kimi-k2's heads (G = 8, D = 112): the commit kernel's order against
    the plain version (1e-6) and the JAX oracle (1e-5), rows independent of
    the batch."""
    problem = _paged_problem(30 + seed, H=16, KV=2, D=112)
    got = _commit_model(*_t(problem))
    want = ref.paged_attention(*_t(problem), null_bid=problem[6])
    assert float((got - want).abs().max()) <= 1e-6
    np.testing.assert_allclose(got.numpy(), _jax_ref(problem), atol=1e-5, rtol=0)
    q, k, v, pos, tab, qp = _t(problem)
    assert torch.equal(_commit_model(q[1:2], k, v, pos, tab[1:2], qp[1:2])[0], got[1])


@pytest.mark.parametrize("splits,cd", [(1, "float32"), (4, "bfloat16")])
def test_decode_model_matches_refs_at_d112(splits, cd):
    """The dense kernel's order at G = 8, D = 112 against its plain version
    and the Pallas kernel (interpret mode), tolerances as at D = 64."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention as pallas

    problem = _decode_problem(50 + splits, H=16, KV=2, D=112)
    got = _decode_model(*(torch.from_numpy(a) for a in problem), splits, cd)
    want = ref.decode_attention(*(torch.from_numpy(a) for a in problem), splits, cd)
    jax_want = np.asarray(pallas(*(jnp.asarray(a) for a in problem), kv_splits=splits,
                                 combine_dtype=cd, interpret=True))
    tol = 1e-6 if cd == "float32" else float(want.abs().max()) * 2.0 ** -7
    assert float((got - want).abs().max()) <= tol
    np.testing.assert_allclose(got.numpy(), jax_want, atol=tol, rtol=0)
