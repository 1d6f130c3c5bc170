"""The port's serving engine on the CPU (``llama3-smoke``, plain kernels).

* Against the JAX engine on shared weights: LLM42, 4 deterministic
  requests, 10 new tokens each.  Committed streams must agree token for
  token up to the first position whose verifier top-1/top-2 margin is below
  ``MARGIN_TOL``; such near-ties (where f32 reordering between XLA and torch
  may flip the argmax) end the comparison for that request and are
  reported, not asserted.
* Within the port, bitwise: committed streams identical across {pause,
  overlap, adaptive} x spec_depth {1, 4}, across co-traffic mixes, across
  chunked and exclusive prefill; BATCH_INVARIANT streams identical across
  co-traffic mixes; NONDET diverges under the divergence demo's bf16 policy.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import llama3_8b
from repro_torch.core.determinism import Mode, ReductionPolicy
from repro_torch.models.base import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import (
    AdaptivePolicy, OverlapPolicy, PauseDecodePolicy,
)

ROOT = Path(__file__).resolve().parents[1]
CFG = llama3_8b.smoke_config()
#: the divergence demo's aggressive fast path: rollbacks actually happen
DEMO_POLICY = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                              combine_dtype="bfloat16")
#: f32 logits of the two frameworks agree to ~1e-5 at this size
#: (test_torch_model); a margin 100x that cannot flip
MARGIN_TOL = 1e-3


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


@pytest.fixture(scope="module")
def jax_params():
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config
    from repro.models import init_params as jax_init

    return jax_init(get_smoke_config("llama3-8b"), jax.random.key(0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    import jax

    return params_from_numpy(CFG, jax.tree_util.tree_map(np.asarray, jax_params), "cpu")


def _prompts(n, seed=1, length=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, length).tolist() for _ in range(n)]


def test_engine_matches_jax_engine(jax_params, port_params):
    from repro.configs import get_smoke_config
    from repro.core.determinism import Mode as JMode
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling

    kw = dict(window=4, group=2, max_batch=4, capacity=64)
    prompts = _prompts(4)
    jeng = JEngine(get_smoke_config("llama3-8b"), jax_params, mode=JMode.LLM42, **kw)
    teng = Engine(CFG, port_params, mode=Mode.LLM42, audit=True, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, sampling=JSampling(
            max_new_tokens=10, is_deterministic=True)))
        teng.submit(Request(rid=i, prompt=p, sampling=SamplingParams(
            max_new_tokens=10, is_deterministic=True)))
    want = {r.rid: r.committed for r in jeng.run()}
    got = {r.rid: r.committed for r in teng.run()}
    margins = {(rec.rid, rec.index): rec.margin for rec in teng.obs.audit.records}
    near_ties = []
    for rid in range(4):
        assert len(got[rid]) == len(want[rid]) == 10
        for i, (a, b) in enumerate(zip(got[rid], want[rid])):
            if margins[(rid, i)] < MARGIN_TOL:
                near_ties.append((rid, i, margins[(rid, i)]))
                break
            assert a == b, f"rid {rid} token {i}: port {a}, JAX {b}"
    print(f"near-ties that ended a comparison: {near_ties}")


def _run(params, mode, *, policy=DEMO_POLICY, neighbours=0, scheduler=None,
         spec_depth=1, prefill_chunk=0, max_new=24):
    eng = Engine(CFG, params, mode=mode, policy=policy, window=6, group=2,
                 max_batch=8, capacity=128, scheduler=scheduler,
                 spec_depth=spec_depth, prefill_chunk=prefill_chunk)
    eng.submit(Request(rid=0, prompt=list(range(1, 11)), sampling=SamplingParams(
        max_new_tokens=max_new, is_deterministic=mode == Mode.LLM42, seed=7)))
    for i in range(neighbours):
        eng.submit(Request(rid=1 + i, prompt=[3 * i + k for k in range(6)],
                           sampling=SamplingParams(max_new_tokens=max_new)))
    return {r.rid: r for r in eng.run()}[0]


@pytest.fixture(scope="module")
def reference_stream(port_params):
    return _run(port_params, Mode.LLM42).committed


@pytest.mark.parametrize("policy", ["pause", "overlap", "adaptive"])
@pytest.mark.parametrize("depth", [1, 4])
def test_llm42_streams_identical_across_schedulers(port_params, reference_stream,
                                                   policy, depth):
    sched = {"pause": PauseDecodePolicy, "overlap": OverlapPolicy,
             "adaptive": AdaptivePolicy}[policy]()
    got = _run(port_params, Mode.LLM42, neighbours=3, scheduler=sched,
               spec_depth=depth).committed
    assert got == reference_stream


@pytest.mark.parametrize("neighbours", [1, 6])
def test_llm42_streams_identical_across_traffic(port_params, reference_stream,
                                                neighbours):
    assert _run(port_params, Mode.LLM42, neighbours=neighbours).committed == reference_stream


def test_llm42_chunked_prefill_matches_exclusive(port_params, reference_stream):
    assert _run(port_params, Mode.LLM42, neighbours=2,
                prefill_chunk=4).committed == reference_stream


def test_llm42_rolls_back_under_demo_policy(port_params):
    """Alone (B = 1, 16 splits) the fast path flips tokens that the verifier
    rejects, so the reference stream above went through rollbacks."""
    r = _run(port_params, Mode.LLM42)
    assert r.num_rollbacks > 0 and r.num_recomputed_tokens > 0


@pytest.mark.parametrize("neighbours", [3, 6])
def test_batch_invariant_streams_identical_across_traffic(port_params, neighbours):
    """BATCH_INVARIANT runs every pass under the commit schedule, so the
    stream cannot depend on the decode batch's size."""
    alone = _run(port_params, Mode.BATCH_INVARIANT, max_new=16).committed
    assert _run(port_params, Mode.BATCH_INVARIANT, neighbours=neighbours,
                max_new=16).committed == alone


def test_nondet_diverges_across_traffic(port_params):
    alone = _run(port_params, Mode.NONDET, max_new=48).committed
    crowded = _run(port_params, Mode.NONDET, neighbours=6, max_new=48).committed
    assert alone != crowded


def test_prefix_cache_hit_keeps_stream(port_params):
    """A second identical deterministic request maps its prompt's whole
    blocks to the first one's cached KV and still commits the same stream."""
    eng = Engine(CFG, port_params, mode=Mode.LLM42, policy=DEMO_POLICY, window=6,
                 group=2, max_batch=2, capacity=128, block_size=4)
    prompt = list(range(1, 18))
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=prompt, sampling=SamplingParams(
            max_new_tokens=12, is_deterministic=True)))
        eng.run()
    a, b = eng.finished
    assert eng.mem_stats()["prefix_hit_tokens"] > 0
    assert a.committed == b.committed


def test_engine_refuses_unported_options(port_params):
    """Tensor parallelism and the sliding-window family still wait; the
    gathered lane and seeded sampling are ported (tests/test_torch_gathered.py,
    tests/test_torch_sampler.py)."""
    import dataclasses

    with pytest.raises(NotImplementedError):
        Engine(CFG, port_params, tp=2)
    with pytest.raises(NotImplementedError):
        Engine(dataclasses.replace(CFG, attn_kind="sliding"), port_params)
    eng = Engine(CFG, port_params, capacity=64, paged_attention=False)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], sampling=SamplingParams(
        max_new_tokens=4, temperature=0.8)))
    assert len(eng.run()[0].committed) == 4


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "6"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert "finished 3 requests, 18 tokens committed" in out.stdout
    assert "not a device time" in out.stdout


def test_random_weights_serve_in_every_mode():
    params = init_params(CFG, torch.Generator().manual_seed(3), "cpu")
    for mode in Mode:
        eng = Engine(CFG, params, mode=mode, capacity=64)
        for i, p in enumerate(_prompts(3, seed=5, length=9)):
            eng.submit(Request(rid=i, prompt=p, sampling=SamplingParams(
                max_new_tokens=5, is_deterministic=i != 1)))
        done = eng.run()
        assert sorted(len(r.committed) for r in done) == [5, 5, 5]


def test_preemption_restore_keeps_streams(port_params):
    """A pool too small for all four requests forces preemption; restores
    replay the committed stream, so every stream matches an unconstrained
    run bitwise."""
    def run(num_blocks):
        eng = Engine(CFG, port_params, mode=Mode.LLM42, policy=DEMO_POLICY,
                     window=4, group=2, max_batch=4, capacity=64, block_size=4,
                     num_blocks=num_blocks)
        for i, p in enumerate(_prompts(4, seed=9, length=10)):
            eng.submit(Request(rid=i, prompt=p, sampling=SamplingParams(
                max_new_tokens=16, is_deterministic=i % 2 == 0)))
        return eng, {r.rid: r.committed for r in eng.run()}

    _, roomy = run(None)
    tight_eng, tight = run(24)
    assert tight_eng.num_preemptions > 0 and tight_eng.num_restores > 0
    assert {rid: tight[rid] for rid in (0, 2)} == {rid: roomy[rid] for rid in (0, 2)}
