"""The gathered-view lane (``Engine(paged_attention=False)``) on the CPU.

The lane copies each row's blocks into a dense view, runs the forward on it
(``models.layers.attention_cached``; W == 1 through
``kernels.ops.decode_attention``) and scatters the view back.  Held here at
smoke size (``llama3-smoke``, plain kernels):

* LLM42 committed streams of deterministic requests, greedy and seeded,
  bitwise equal to the paged lane's across schedulers {default, overlap} x
  spec depth {1, 4} and block sizes {8, 64}: the port's counterpart of
  ``tests/test_paged_attention.py::TestFusedStepBitwiseIdentity``;
* against the JAX engine with ``paged_attention=False`` on shared weights:
  committed tokens equal wherever the verifier's top-1/top-2 margin clears
  ``MARGIN_TOL`` (f32 logits of the two frameworks agree to ~1e-5); a
  near-tie ends that request's comparison and is reported;
* every W == 1 call's ``lengths = start_pos + 1`` mask equals the ``pos``
  mask of the view it reads, through rollbacks and a prefix-cache hit, and
  those calls reach ``ops.decode_attention``, never the paged kernels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import llama3_8b
from repro_torch.core.determinism import Mode, ReductionPolicy
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.base import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import OverlapPolicy

CFG = llama3_8b.smoke_config()
#: the divergence demo's aggressive fast path: rollbacks actually happen
DEMO_POLICY = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                              combine_dtype="bfloat16")
MARGIN_TOL = 1e-3
DET = (0, 2, 3)


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
def params():
    return init_params(CFG, torch.Generator().manual_seed(1), "cpu")


def _requests():
    """Four requests: 0 greedy and 2, 3 seeded (3 with top-k) are
    deterministic; 1 is fast-path traffic beside them."""
    return [Request(rid=i, prompt=[(5 * i + j) % CFG.vocab_size for j in range(9)],
                    sampling=SamplingParams(
                        max_new_tokens=12, is_deterministic=i in DET, seed=70 + i,
                        temperature=0.8 if i >= 2 else 0.0,
                        top_k=50 if i == 3 else 0))
            for i in range(4)]


def _run(params, *, paged, mode=Mode.LLM42, scheduler=None, spec_depth=1,
         block_size=16):
    eng = Engine(CFG, params, mode=mode, policy=DEMO_POLICY, window=5, group=2,
                 max_batch=8, capacity=128, scheduler=scheduler,
                 spec_depth=spec_depth, block_size=block_size,
                 paged_attention=paged)
    for r in _requests():
        eng.submit(r)
    return {r.rid: r for r in eng.run()}


@pytest.mark.parametrize("scheduler,spec_depth,block_size", [
    ("default", 1, 16), ("default", 4, 16), ("overlap", 1, 16),
    ("overlap", 4, 16), ("default", 1, 8), ("default", 1, 64),
])
def test_llm42_streams_equal_paged_lane(params, scheduler, spec_depth, block_size):
    kw = dict(spec_depth=spec_depth, block_size=block_size)
    sched = (lambda: OverlapPolicy()) if scheduler == "overlap" else (lambda: None)
    gathered = _run(params, paged=False, scheduler=sched(), **kw)
    paged = _run(params, paged=True, scheduler=sched(), **kw)
    for rid in DET:
        assert len(gathered[rid].committed) == 12
        assert gathered[rid].committed == paged[rid].committed, rid
    assert sum(gathered[rid].num_rollbacks for rid in DET) > 0


@pytest.mark.parametrize("mode", list(Mode))
def test_gathered_lane_serves_every_mode(params, mode):
    done = _run(params, paged=False, mode=mode)
    assert sorted(len(r.committed) for r in done.values()) == [12] * 4
    assert all(0 <= t < CFG.vocab_size for r in done.values() for t in r.committed)


def test_gathered_lane_matches_jax_engine(params):
    """Shared weights: the port's random weights, handed to the JAX engine
    through numpy (the two trees have the same keys and layouts)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core.determinism import Mode as JMode
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling

    jcfg = get_smoke_config("llama3-8b")
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    tparams = params_from_numpy(CFG, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, CFG.vocab_size, 12).tolist() for _ in range(2)]
    kw = dict(window=4, group=2, max_batch=2, capacity=64, paged_attention=False)
    jeng = JEngine(jcfg, jparams, mode=JMode.LLM42, **kw)
    teng = Engine(CFG, tparams, mode=Mode.LLM42, audit=True, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, sampling=JSampling(
            max_new_tokens=6, is_deterministic=True)))
        teng.submit(Request(rid=i, prompt=p, sampling=SamplingParams(
            max_new_tokens=6, is_deterministic=True)))
    want = {r.rid: r.committed for r in jeng.run()}
    got = {r.rid: r.committed for r in teng.run()}
    margins = {(rec.rid, rec.index): rec.margin for rec in teng.obs.audit.records}
    near_ties = []
    for rid in want:
        assert len(got[rid]) == len(want[rid]) == 6
        for i, (a, b) in enumerate(zip(got[rid], want[rid])):
            if margins[(rid, i)] < MARGIN_TOL:
                near_ties.append((rid, i, margins[(rid, i)]))
                break
            assert a == b, f"rid {rid} token {i}: port {a}, JAX {b}"
    print(f"near-ties that ended a comparison: {near_ties}")


def test_decode_length_mask_equals_pos_mask(params, monkeypatch):
    """Through rollbacks and a prefix-cache hit, the W == 1 length mask is
    the pos mask of the view, and decode never reaches the paged kernels."""
    calls = []
    original = transformer.attention_cached

    def checked(p, cfg, x, cache, start_pos, schedule, window=0):
        out = original(p, cfg, x, cache, start_pos, schedule, window)
        if x.shape[1] == 1:
            C = cache["pos"].shape[1]
            by_len = torch.arange(C)[None, :] < (start_pos[:, None] + 1)
            by_pos = (cache["pos"] >= 0) & (cache["pos"] <= start_pos[:, None])
            calls.append(bool(torch.equal(by_len, by_pos)))
        return out

    def refuse(*args, **kwargs):
        raise AssertionError("the gathered lane reached a paged kernel")

    n_decode = [0]
    decode = ops.decode_attention

    def counted(*args, **kwargs):
        n_decode[0] += 1
        return decode(*args, **kwargs)

    monkeypatch.setattr(transformer, "attention_cached", checked)
    monkeypatch.setattr(ops, "paged_attention", refuse)
    monkeypatch.setattr(ops, "decode_attention", counted)
    eng = Engine(CFG, params, mode=Mode.LLM42, policy=DEMO_POLICY, window=6,
                 group=2, max_batch=2, capacity=128, block_size=4,
                 paged_attention=False)
    prompt = list(range(1, 18))
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=prompt, sampling=SamplingParams(
            max_new_tokens=12, is_deterministic=True)))
        eng.run()
    a, b = eng.finished
    assert eng.mem_stats()["prefix_hit_tokens"] > 0
    assert a.num_rollbacks + b.num_rollbacks > 0
    assert a.committed == b.committed
    assert calls and all(calls)
    assert n_decode[0] == len(calls) and len(calls) % CFG.num_layers == 0
