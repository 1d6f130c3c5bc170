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
  ``d`` and ``o`` instead.

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
from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant
from repro_torch.kernels.gemm_splitk import gemm_splitk
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_fast

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

HOST_COPIES = [
    "serving/request.py", "core/dvr.py", "core/pipeline.py", "core/spans.py",
    "serving/streams.py", "serving/scheduler.py", "serving/prefixcache.py",
    "obs/__init__.py", "obs/metrics.py", "obs/trace.py", "obs/audit.py",
]


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
