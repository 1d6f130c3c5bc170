"""The fast path's tensor-parallel width on the CPU.

* ``kernels.ops.matmul`` under un-pinned TP schedules (tp 2 and 4 x splits
  1, 2 and 8 x combine bf16 and f32) against
  ``repro.core.determinism.matmul``, at a K whose nested chunks are uneven,
  within ``TP_TOL`` (f32) or 2 bf16 ulps of max |ref| (bf16 combine: each
  framework's f32 partials round apart near a bf16 midpoint).
* ``ops.matmul`` on CPU tensors bitwise equal to the plain version of the
  kernel it routes to, at every TP schedule, pinned or not; fast tp 1 and
  tp 4 differ (negative control); the pinned tree realized as device-local
  subtrees at widths 1, 2 and 4 gives the logical tree's bits.
* The engine (llama3-8b smoke): committed LLM42 streams bitwise across
  tp 1, 2 and 4 under the pause, overlap and adaptive schedulers (after
  ``tests/test_sharding.py::TestTPInvariantCommit``); the port at tp 2
  against the JAX engine at tp 2 on shared weights (pause scheduler,
  compared up to the first near-tie); ``serve.py --tp 2`` runs and
  ``--tp 3`` is refused.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import (
    CANONICAL_TP_SHARDS, VERIFY_SCHEDULE, Mode, Schedule, _split_sizes, tree_combine,
)
from repro_torch.kernels import ops, ref
from repro_torch.models.base import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import AdaptivePolicy, OverlapPolicy, PauseDecodePolicy

ROOT = Path(__file__).resolve().parents[1]
#: the serve CLI's process runs with one intra-op thread, as this module's
#: own tests do: several test workers share the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
CFG = configs.get_smoke_config("llama3-8b")
#: f32 combine: the two frameworks' f32 partials differ by summation order
TP_TOL = 1e-5
#: a verifier margin far above the logits' disagreement cannot flip a token
MARGIN_TOL = 1e-3
SCHEDULERS = {"pause": PauseDecodePolicy, "overlap": OverlapPolicy,
              "adaptive": AdaptivePolicy}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xw(M=5, K=300, N=64, seed=0):
    """K = 300: tp 4 cuts 75-column chunks, splits 8 cuts those 10, 10, 10,
    9, ..., which is not ``_split_sizes(300, 32)``."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def test_nested_cut_is_not_the_flat_cut():
    nested = [s for c in _split_sizes(300, 4) for s in _split_sizes(c, 8)]
    assert nested != _split_sizes(300, 32) and sum(nested) == 300


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("tp", [2, 4])
def test_unpinned_matmul_matches_jax(tp, splits, cd):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import Schedule as JSchedule, matmul as jmatmul

    x, w = _xw(seed=tp * 10 + splits)
    s = Schedule(splits=splits, combine_dtype=cd, tp_shards=tp)
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w), s).numpy()
    want = np.asarray(jmatmul(jnp.asarray(x), jnp.asarray(w), JSchedule(*s)))
    tol = TP_TOL if cd == "float32" else 2 * np.abs(want).max() * 2.0 ** -8
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _tp_schedules():
    return [Schedule(splits=s, combine_dtype=cd, tp_shards=tp, tp_pinned=pin)
            for tp in (1, 2, 4) for s in (1, 2, 8) for cd in ("bfloat16", "float32")
            for pin in (False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ops_matmul_equals_the_plain_versions(dtype):
    """Every TP schedule reaches the plain version of the kernel it routes
    to: pinned one-split schedules the commit GEMM at ``tp_shards`` chunks,
    the rest (tp 1 with splits, or any un-pinned or split TP schedule) the
    split-K GEMM's two-level fold."""
    x, w = (torch.from_numpy(a).to(dtype) for a in _xw(seed=3))
    for s in _tp_schedules():
        got = ops.matmul(x, w, s)
        if s.splits == 1 and (s.tp_shards == 1 or s.tp_pinned):
            want = ref.gemm_batch_invariant(x, w, chunks=s.tp_shards)
        else:
            want = ref.gemm_splitk(x, w, s.splits, s.combine_dtype,
                                   tp_shards=s.tp_shards, tp_pinned=s.tp_pinned)
        assert torch.equal(got, want), s
    # one split and one TP chunk: the split-K fold degenerates to one pass
    assert torch.equal(ref.gemm_splitk(x, w, 1, tp_shards=1),
                       ref.gemm_batch_invariant(x, w, chunks=1))


def test_fast_tp_width_changes_bits():
    """Negative control: the un-pinned fold follows the TP width."""
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in _xw(4, 64, 32, seed=4))
    fast1 = Schedule(splits=2, combine_dtype="bfloat16", tp_shards=1)
    fast4 = Schedule(splits=2, combine_dtype="bfloat16", tp_shards=4)
    assert not torch.equal(ops.matmul(x, w, fast1), ops.matmul(x, w, fast4))


@pytest.mark.parametrize("width", [1, 2, 4])
def test_pinned_tree_is_tp_invariant(width):
    """The canonical pinned tree realized on a width-d mesh (each device
    combines its own chunk partials, then the devices' sums combine in the
    same association) gives the logical commit GEMM's bits."""
    x, w = (torch.from_numpy(a) for a in _xw(4, 64, 32, seed=5))
    sizes = _split_sizes(64, CANONICAL_TP_SHARDS)
    parts = [xc @ wc for xc, wc in zip(torch.split(x, sizes, dim=-1),
                                        torch.split(w, sizes, dim=0))]
    per = CANONICAL_TP_SHARDS // width
    local = [tree_combine(parts[d * per:(d + 1) * per]) for d in range(width)]
    assert torch.equal(tree_combine(local), ops.matmul(x, w, VERIFY_SCHEDULE))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _det_reqs(n=3, max_new=8):
    return [Request(rid=i, prompt=[(5 * i + j) % CFG.vocab_size for j in range(9)],
                    sampling=SamplingParams(max_new_tokens=max_new, is_deterministic=True,
                                            seed=70 + i))
            for i in range(n)]


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_committed_streams_bitwise_across_tp(params, scheduler):
    streams = {}
    for tp in (1, 2, 4):
        eng = Engine(CFG, params, mode=Mode.LLM42, window=4, group=2, max_batch=4,
                     capacity=128, scheduler=SCHEDULERS[scheduler](), tp=tp)
        for r in _det_reqs():
            eng.submit(r)
        streams[tp] = {r.rid: tuple(r.committed) for r in eng.run()}
        if tp > 1:
            assert eng._decode_schedule(3) == eng.policy.schedule_for(3)._replace(
                tp_shards=tp, tp_pinned=False)
    assert streams[1] == streams[2] == streams[4]
    assert all(len(s) == 8 for s in streams[1].values())


def test_engine_at_tp2_matches_jax_engine():
    """The port at tp 2 against the JAX engine at tp 2 on the JAX package's
    weights: 2 greedy LLM42 requests of 8 new tokens commit the same tokens
    up to the first near-tie (reported)."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.core.determinism import Mode as JMode
    from repro.models import init_params as jax_init
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling
    from repro.serving.scheduler import PauseDecodePolicy as JPause

    jcfg = jconfigs.get_smoke_config("llama3-8b")
    jp = jax_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(CFG, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    kw = dict(window=4, group=2, max_batch=2, capacity=64, tp=2)
    jeng = JEngine(jcfg, jp, mode=JMode.LLM42, scheduler=JPause(), **kw)
    teng = Engine(CFG, tp, mode=Mode.LLM42, audit=True, scheduler=PauseDecodePolicy(),
                  **kw)
    for r in _det_reqs(2):
        teng.submit(r)
        jeng.submit(JRequest(rid=r.rid, prompt=r.prompt, sampling=JSampling(
            max_new_tokens=8, is_deterministic=True, seed=r.sampling.seed)))
    want = {r.rid: r.committed for r in jeng.run()}
    got = {r.rid: r.committed for r in teng.run()}
    margins = {(rec.rid, rec.index): rec.margin for rec in teng.obs.audit.records}
    near_ties = []
    for rid in range(2):
        assert len(got[rid]) == len(want[rid]) == 8
        for i, (a, b) in enumerate(zip(got[rid], want[rid])):
            if margins[(rid, i)] < MARGIN_TOL:
                near_ties.append((rid, i, margins[(rid, i)]))
                break
            assert a == b, f"rid {rid} token {i}: port {a}, JAX {b}"
    print(f"near-ties that ended a comparison: {near_ties}")


def test_engine_refuses_a_width_that_does_not_divide_the_tree(params):
    with pytest.raises(ValueError, match="canonical shard count"):
        Engine(CFG, params, tp=3)


@pytest.mark.parametrize("tp,ok", [(2, True), (3, False)])
def test_serve_cli_tp(tp, ok):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--requests", "3", "--max-new", "6", "--tp", str(tp)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", **ONE_THREAD})
    if ok:
        assert out.returncode == 0, out.stderr[-2000:]
        assert f"tp={tp}" in out.stdout and "finished 3 requests" in out.stdout
    else:
        assert out.returncode != 0 and "canonical shard count" in out.stderr
