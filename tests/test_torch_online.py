"""The port's costed clock on the CPU: cost model, online runner, workloads.

* ``serving.costmodel`` against the JAX package's, exactly: ``step_time``,
  ``simulate`` and ``simulate_streams`` on one event log from a port run
  plus synthetic ``overlap``, ``prefill_chunk``, ``fused``, ``tp=2`` and
  sync-verify events, at the full width of every ported config and its
  sliding-window variant (the ring's read context, MoE's active FLOPs), on
  ``V5E`` and on the port's ``H100`` fields.
* ``serving.online.run_online`` in NONDET against the JAX runner on
  shared smoke weights, requests and arrivals: the same latencies, TTFTs,
  total time and event log (host wall times aside).  NONDET has no
  rollbacks, so the schedule follows the lengths alone; the tokens
  themselves are the fast path's and may differ across frameworks.
* The port's versions of ``tests/test_online.py::TestOnlineRunner``, and
  LLM42 streams under Poisson arrivals equal to the same requests alone.
* ``training.data``'s workload helpers against the JAX ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import Mode
from repro_torch.models.base import init_params
from repro_torch.serving import costmodel
from repro_torch.serving.engine import Engine
from repro_torch.serving.online import percentile, run_online
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import OverlapPolicy
from repro_torch.training import data

CFG = configs.get_smoke_config("llama3-8b")
FULL = configs.get_config("llama3-8b")
DENSE = list(configs.DASHED)
#: every ported config, with the sliding-window variants (``:long``)
ALL = DENSE + [f"{a}:long" for a in DENSE if configs.supports_long(a)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _reqs(n, det_rids=(), max_new=12, eos=None):
    return [Request(
        rid=i, prompt=[(3 * i + j) % CFG.vocab_size for j in range(8)],
        sampling=SamplingParams(max_new_tokens=max_new,
                                is_deterministic=i in det_rids,
                                seed=50 + i, eos_id=eos),
    ) for i in range(n)]


# ---------------------------------------------------------------------------
# cost model parity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def event_log(params):
    """A port LLM42 run's events (overlap scheduler: composite iterations,
    deferred verifies) plus synthetic events of every kind the model
    prices."""
    eng = Engine(CFG, params, mode=Mode.LLM42, window=5, group=2, max_batch=4,
                 capacity=128, scheduler=OverlapPolicy(), prefill_chunk=4)
    for r in _reqs(4, det_rids={0, 2}, max_new=10):
        eng.submit(r)
    eng.run()
    events = [dict(ev) for ev in eng.events]
    dec = {"kind": "decode", "batch": 5, "ctx_sum": 900,
           "schedule": (4, 4, "bfloat16", False)}
    ver = {"kind": "verify", "group": 2, "window": 8, "ctx_sum": 700}
    chunk = {"kind": "prefill_chunk", "padded": 64, "start": 128, "tokens": 50}
    synthetic = [
        {"kind": "overlap", "decode": dec, "prefill": chunk, "verify": ver,
         "verifies": [dict(ver, ctx_sum=300)]},
        {"kind": "overlap", "decode": dec, "verify": dict(ver, fused=True),
         "invariant": True},
        {"kind": "overlap", "decode": dec, "verify": ver, "tp": 2},
        dict(chunk, fused=True),
        {"kind": "prefill", "padded": 1024, "tokens": 1000},
        dict(dec, tp=2),
        dict(dec, invariant=True),
        dict(ver, deferred=True),
        ver,  # a sync verify: blocks the main stream
        {"kind": "preempt", "dropped_tokens": 12},
        {"kind": "restore"},
        {"kind": "cache_hit", "tokens": 32},
        dict(chunk, replay=True),
    ]
    assert len(events) > 10 and any(ev["kind"] == "overlap" for ev in events)
    return events + synthetic


def _jax_hw(hw):
    from repro.serving import costmodel as jcm

    return jcm.Hardware(**dataclasses.asdict(hw))


@pytest.mark.parametrize("arch", ALL)
def test_cost_model_equals_jax(event_log, arch):
    pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.serving import costmodel as jcm

    arch, _, long = arch.partition(":")
    if long:
        cfg, jcfg = configs.get_long_config(arch), jconfigs.get_long_config(arch)
    else:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for hw in (costmodel.V5E, costmodel.H100):
        jhw = _jax_hw(hw)
        assert [costmodel.step_time(cfg, ev, hw) for ev in event_log] == [
            jcm.step_time(jcfg, ev, jhw) for ev in event_log]
        for inv in (False, True):
            assert costmodel.simulate(cfg, event_log, hw, invariant_mode=inv) == \
                jcm.simulate(jcfg, event_log, jhw, invariant_mode=inv)
            got = costmodel.simulate_streams(cfg, event_log, hw, invariant_mode=inv)
            want = jcm.simulate_streams(jcfg, event_log, jhw, invariant_mode=inv)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert costmodel.throughput_tokens_per_s(cfg, event_log, 100, hw) == \
            jcm.throughput_tokens_per_s(jcfg, event_log, 100, jhw)
    assert costmodel.memory_report(event_log) == jcm.memory_report(event_log)
    assert costmodel.flatten_events(event_log) == jcm.flatten_events(event_log)
    for fn in ("kv_bytes_per_token", "state_bytes", "flops_per_token"):
        assert getattr(costmodel, fn)(cfg) == getattr(jcm, fn)(jcfg)
    assert costmodel.kv_block_bytes(cfg, 16) == jcm.kv_block_bytes(jcfg, 16)
    assert costmodel.pool_hbm_bytes(cfg, 100, 8, 16) == jcm.pool_hbm_bytes(jcfg, 100, 8, 16)
    assert costmodel.dense_hbm_bytes(cfg, 8, 512) == jcm.dense_hbm_bytes(jcfg, 8, 512)
    assert dataclasses.asdict(costmodel.V5E) == dataclasses.asdict(jcm.V5E)


def test_h100_entry_is_the_cards():
    """The port's default clock is the H100 entry: the data-sheet peaks,
    the measured all-reduce rate, and no field left at the v5e value
    except those marked unmeasured."""
    hw = costmodel.H100
    assert (hw.peak_flops, hw.hbm_bw) == (989e12, 3.35e12)
    assert hw.ici_bw == 8.49e9  # the card's all-reduce at 8 rows over 4 cards
    assert hw.launch_overhead_s == pytest.approx(5.41e-6, rel=1e-3)
    assert hw.bi_compute_frac != costmodel.V5E.bi_compute_frac
    assert Engine.__init__.__kwdefaults__["hw"] is costmodel.H100
    assert run_online.__kwdefaults__["hw"] is costmodel.H100


# ---------------------------------------------------------------------------
# online runner
# ---------------------------------------------------------------------------


def _strip_wall(ev):
    if isinstance(ev, dict):
        return {k: _strip_wall(v) for k, v in ev.items() if k != "wall"}
    if isinstance(ev, (list, tuple)):
        return type(ev)(_strip_wall(v) for v in ev)
    return ev


def test_run_online_nondet_equals_jax():
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.core.determinism import Mode as JMode
    from repro.models import init_params as jax_init
    from repro.serving import costmodel as jcm
    from repro.serving.engine import Engine as JEngine
    from repro.serving.online import run_online as jrun
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling

    from repro_torch.models.convert import params_from_numpy

    jcfg = jconfigs.get_smoke_config("llama3-8b")
    jp = jax_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(CFG, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    lens = [(9, 6), (14, 5), (6, 7), (11, 6)]
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist() for n, _ in lens]
    arrivals = [0.0, 0.004, 0.006, 0.03]

    def reqs(R, S):
        return [R(rid=i, prompt=prompts[i], sampling=S(max_new_tokens=o))
                for i, (_, o) in enumerate(lens)]

    kw = dict(max_batch=4, capacity=64)
    jeng = JEngine(jcfg, jp, mode=JMode.NONDET, **kw)
    want = jrun(jeng, jconfigs.get_config("llama3-8b"),
                list(zip(reqs(JRequest, JSampling), arrivals)), hw=jcm.V5E)
    teng = Engine(CFG, tp, mode=Mode.NONDET, **kw)
    got = run_online(teng, FULL, list(zip(reqs(Request, SamplingParams), arrivals)),
                     hw=costmodel.V5E)
    assert got.latencies == want.latencies
    assert got.ttfts == want.ttfts
    assert got.total_time == want.total_time
    assert got.out_tokens == want.out_tokens
    assert _strip_wall(teng.events) == _strip_wall(jeng.events)


class TestOnlineRunner:
    """``tests/test_online.py::TestOnlineRunner`` on the port (cost model at
    the smoke config's scale, the port's default H100 entry)."""

    def test_latency_accounting(self, params):
        eng = Engine(CFG, params, mode=Mode.NONDET, max_batch=4, capacity=128)
        res = run_online(eng, CFG, list(zip(_reqs(4), [0.0, 0.0, 5.0, 5.0])))
        assert len(res.latencies) == 4
        assert all(v > 0 for v in res.latencies.values())
        assert all(res.ttfts[r] <= res.latencies[r] for r in res.ttfts)
        # the late arrivals cannot have been served before t=5
        assert res.total_time >= 5.0

    def test_clock_is_deterministic(self, params):
        def once():
            eng = Engine(CFG, params, mode=Mode.LLM42, window=5, group=2,
                         max_batch=4, capacity=128)
            res = run_online(eng, CFG, list(zip(_reqs(4, det_rids={0}),
                                                [0.0, 0.1, 0.2, 0.3])))
            return res.total_time, sorted(res.latencies.items())

        assert once() == once()

    def test_percentile(self):
        assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 3.0
        assert percentile([5.0], 99) == 5.0
        assert np.isnan(percentile([], 50))

    def test_exhausting_max_iters_raises(self, params):
        eng = Engine(CFG, params, mode=Mode.NONDET, max_batch=4, capacity=128)
        with pytest.raises(RuntimeError, match="partial"):
            run_online(eng, CFG, list(zip(_reqs(2), [0.0, 0.0])), max_iters=3)

    def test_exhausting_max_iters_warn_mode(self, params):
        eng = Engine(CFG, params, mode=Mode.NONDET, max_batch=4, capacity=128)
        with pytest.warns(RuntimeWarning, match="run_online exhausted"):
            res = run_online(eng, CFG, list(zip(_reqs(2), [0.0, 0.0])),
                             max_iters=3, on_exhaust="warn")
        assert len(res.latencies) < 2  # partial, and flagged as such

    def test_clock_rides_engine_streams(self, params):
        """The discrete-event clock IS the engine's main-stream clock."""
        eng = Engine(CFG, params, mode=Mode.LLM42, window=5, group=2,
                     max_batch=4, capacity=128)
        res = run_online(eng, CFG, list(zip(_reqs(3, det_rids={0}), [0.0, 0.1, 0.2])))
        assert res.total_time == pytest.approx(eng.runtime.now)
        assert eng.runtime.main.busy > 0.0
        snap = res.metrics
        assert snap["streams.main_busy"] == eng.runtime.main.busy > 0.0
        assert snap["streams.makespan"] == eng.runtime.makespan
        assert snap["streams.verify_busy"] > 0.0
        assert snap["streams.verify_backlog"] == eng.runtime.verify_backlog


def test_llm42_online_streams_equal_solo_runs(params):
    """ShareGPT-length requests under Poisson arrivals on the full config's
    H100 clock: the batch changes while requests are in flight, and each
    deterministic request commits what it commits alone."""
    lens = data.sample_workload(data.SHAREGPT, 6, seed=2, max_in=40, max_out=10)
    arrivals = data.poisson_arrivals(6, qps=200.0, seed=2)

    def reqs():
        r = np.random.default_rng(2)
        return [Request(rid=i, prompt=r.integers(0, CFG.vocab_size, n).tolist(),
                        sampling=SamplingParams(max_new_tokens=o,
                                                is_deterministic=i % 2 == 0,
                                                seed=30 + i))
                for i, (n, o) in enumerate(lens)]

    kw = dict(mode=Mode.LLM42, window=4, group=2, max_batch=4, capacity=128)
    eng = Engine(CFG, params, **kw)
    res = run_online(eng, FULL, list(zip(reqs(), arrivals)))
    assert len(res.latencies) == 6
    assert all(res.latencies[r] >= res.ttfts[r] > 0 for r in res.latencies)
    batches = {ev["batch"] for ev in costmodel.flatten_events(eng.events)
               if ev["kind"] == "decode"}
    assert len(batches) >= 3, batches
    online = {r.rid: r.committed for r in eng.finished}
    for req in reqs():
        if not req.sampling.is_deterministic:
            continue
        solo = Engine(CFG, params, **kw)
        solo.submit(req)
        assert solo.run()[0].committed == online[req.rid], req.rid


def test_bind_cost_model_and_verify_latency(params):
    """``verify_latency_ms`` puts the engine on the costed clock at
    construction; verdicts then land that long after their pass."""
    eng = Engine(CFG, params, mode=Mode.LLM42, window=4, group=2, max_batch=4,
                 capacity=128, verify_latency_ms=10.0, cost_cfg=FULL)
    assert not eng.runtime.logical and eng.runtime.latency == 0.010
    for r in _reqs(3, det_rids={0, 1}, max_new=8):
        eng.submit(r)
    eng.run()
    assert eng.runtime.makespan > 0.010
    logical = Engine(CFG, params, capacity=128)
    assert logical.runtime.logical
    logical.bind_cost_model(FULL, costmodel.V5E, invariant=True)
    assert logical.hw is costmodel.V5E and not logical.runtime.logical
    logical.step()
    with pytest.raises(AssertionError, match="before stepping"):
        logical.bind_cost_model(FULL)


def test_workload_helpers_equal_jax():
    pytest.importorskip("jax")
    from repro.training import data as jdata

    assert dataclasses.asdict(data.SHAREGPT) == dataclasses.asdict(jdata.SHAREGPT)
    assert dataclasses.asdict(data.ARXIV) == dataclasses.asdict(jdata.ARXIV)
    for spec, jspec in ((data.SHAREGPT, jdata.SHAREGPT), (data.ARXIV, jdata.ARXIV)):
        assert data.sample_workload(spec, 50, seed=4, max_in=256, max_out=64) == \
            jdata.sample_workload(jspec, 50, seed=4, max_in=256, max_out=64)
        assert data._lognormal_params(spec.in_mean, spec.in_median) == \
            jdata._lognormal_params(jspec.in_mean, jspec.in_median)
    assert data.poisson_arrivals(20, 3.5, seed=1) == jdata.poisson_arrivals(20, 3.5, seed=1)
    assert data.fixed_workload(3, 8, 4) == jdata.fixed_workload(3, 8, 4)
