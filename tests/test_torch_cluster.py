"""The port's cluster front end on the CPU (smoke ``llama3-8b``, plain kernels).

* The port's versions of ``tests/test_cluster.py``: the router's
  least-loaded spread with index tie-breaks, affinity below the load
  guard, the guard's divert with a block transfer, transferred blocks
  bitwise equal and resident but evictable, no transfer onto a longer
  prefix, a probe that leaves the LRU state alone, ``copy`` and
  ``recompute`` committing the same streams; the aggregate result and the
  ``cluster.*`` gauges, the makespan covering late arrivals, the merged
  trace with one pid a replica, ``max_iters`` exhaustion, one replica
  equal to the single-engine online runner, and bad router policies.
* Against the JAX cluster on shared weights (``params_from_numpy``) and one
  arrival trace at 2 replicas in NONDET mode (no rollbacks, so the
  schedules follow the lengths alone): the same assignment, router
  counters, latencies, TTFTs and event logs on the ``V5E`` clock.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.cluster import Cluster, Router, run_online, transfer_prefix
from repro_torch.core.determinism import Mode
from repro_torch.models.base import init_params
from repro_torch.obs import validate_chrome_trace
from repro_torch.serving import blockpool, costmodel
from repro_torch.serving.engine import Engine
from repro_torch.serving.online import run_online as single_online
from repro_torch.serving.request import Request, SamplingParams

CFG = configs.get_smoke_config("llama3-8b")
FULL = configs.get_config("llama3-8b")
SHARED = list(range(100, 132))  # two full 16-token blocks
ROUTER_COUNTERS = ("assignments", "affinity_hits", "affinity_misses", "diverted",
                   "transfers", "transferred_tokens")


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


def _req(i, prompt, max_new=8, det=True, R=Request, S=SamplingParams):
    return R(rid=i, prompt=prompt,
             sampling=S(max_new_tokens=max_new, is_deterministic=det, seed=50 + i))


def _maker(params, **kw):
    def make_engine(idx):
        return Engine(CFG, params, mode=Mode.LLM42, window=5, group=2, max_batch=2,
                      capacity=128, **kw)
    return make_engine


def _warm(replica, rid=0):
    """Run one shared-prefix request on ``replica`` to fill its radix."""
    replica.engine.submit(_req(rid, SHARED + [200]))
    replica.engine.run()


def _streams(finished):
    return {r.rid: tuple(r.committed) for r in finished}


class TestRouter:
    def test_least_loaded_spread_and_index_tiebreak(self, params):
        cluster = Cluster(_maker(params), 3)
        # no prefixes anywhere: misses go least-loaded, ties to lowest idx
        tgts = []
        for i in range(5):
            t = cluster.router.route(_req(i, [900 + i] * 20), now=0)
            t.engine.submit(_req(i, [900 + i] * 20))
            tgts.append(t.idx)
        assert tgts == [0, 1, 2, 0, 1]
        assert cluster.router.affinity_misses == 5

    def test_affinity_beats_load_below_guard(self, params):
        cluster = Cluster(_maker(params), 2, imbalance=2)
        r0 = cluster.replicas[0]
        _warm(r0)
        assert r0.prefix_blocks(SHARED + [201]) == 2
        # load difference 1 < imbalance 2: affinity wins despite the load
        r0.engine.submit(_req(1, [700] * 20))
        t = cluster.router.route(_req(2, SHARED + [202]), now=10)
        assert t.idx == 0
        assert cluster.router.affinity_hits == 1
        assert cluster.router.diverted == 0

    def test_load_guard_diverts_and_transfers(self, params):
        cluster = Cluster(_maker(params), 2, transfer="copy", imbalance=2)
        r0, r1 = cluster.replicas
        _warm(r0)
        for i in range(1, 4):  # pile load on the prefix holder
            r0.engine.submit(_req(i, [300 + i] * 40))
        t = cluster.router.route(_req(9, SHARED + [202]), now=1000)
        assert t.idx == 1
        assert cluster.router.diverted == 1
        assert cluster.router.transfers == 1
        assert cluster.router.transferred_tokens == 2 * 16
        assert r1.prefix_blocks(SHARED + [203]) == 2
        assert r1.transfers_in == 1 and r1.transferred_tokens_in == 2 * 16

    def test_transferred_blocks_bitwise_equal(self, params):
        cluster = Cluster(_maker(params), 2)
        r0, r1 = cluster.replicas
        _warm(r0)
        moved = transfer_prefix(r0, r1, SHARED, now=50)
        assert moved == 2 * 16
        sb = r0.engine.prefix_cache.match(SHARED, 0)
        db = r1.engine.prefix_cache.match(SHARED, 0)
        lay = r0.engine.pool.layout
        checked = 0
        for s_leaf, d_leaf, kind in zip(blockpool._leaves(r0.engine.pool.data),
                                        blockpool._leaves(r1.engine.pool.data),
                                        blockpool._leaves(lay.kinds)):
            if kind != "paged":
                continue
            assert torch.equal(s_leaf[:, sb], d_leaf[:, db])
            checked += 1
        assert checked == 3  # k, v, pos
        # blocks landed resident but evictable: refcount 0, cached
        alloc = r1.engine.pool.alloc_blocks
        for bid in db:
            assert alloc.refs[bid] == 0
            assert bid in alloc.cached

    def test_transfer_noop_when_dst_has_longer_prefix(self, params):
        cluster = Cluster(_maker(params), 2)
        r0, r1 = cluster.replicas
        _warm(r1)
        assert transfer_prefix(r0, r1, SHARED, now=0) == 0

    def test_peek_probe_does_not_perturb_lru(self, params):
        eng = _maker(params)(0)
        eng.submit(_req(0, SHARED + [200]))
        eng.run()
        pc = eng.prefix_cache
        before = [(n.bid, n.last_use, n.seq) for n in _walk(pc.root)]
        stats_before = dict(pc.stats())
        assert pc.peek(SHARED + [999]) == 2
        assert [(n.bid, n.last_use, n.seq) for n in _walk(pc.root)] == before
        assert dict(pc.stats()) == stats_before

    def test_recompute_policy_commits_same_streams(self, params):
        def once(transfer):
            cluster = Cluster(_maker(params), 2, transfer=transfer, imbalance=1)
            reqs = [_req(i, SHARED + [200 + i]) for i in range(6)]
            run_online(cluster, CFG, [(r, 0.0) for r in reqs])
            return _streams(cluster.finished)

        assert once("copy") == once("recompute")


def _walk(node):
    out, stack = [], [node]
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        if n.bid >= 0:
            out.append(n)
    out.sort(key=lambda n: n.seq)
    return out


class TestClusterRun:
    def test_aggregate_result_and_metrics(self, params):
        cluster = Cluster(_maker(params), 2)
        reqs = [_req(i, SHARED + [200 + i], det=(i % 2 == 0)) for i in range(4)]
        res = run_online(cluster, CFG, [(r, 0.05 * i) for i, r in enumerate(reqs)])
        assert len(res.latencies) == 4
        assert len(res.ttfts) == 4
        assert all(res.ttfts[r] <= res.latencies[r] for r in res.ttfts)
        assert res.out_tokens == sum(r.num_output for r in cluster.finished)
        assert res.throughput > 0
        # goodput with an infinite SLO is plain throughput; with a zero SLO
        # nothing qualifies
        assert res.goodput(float("inf")) == pytest.approx(res.throughput)
        assert res.goodput(0.0) == pytest.approx(0.0)
        m = res.metrics
        assert m["cluster.replicas"] == 2
        assert m["cluster.router.assignments"] == 4
        assert "cluster.replica.0.occupancy" in m
        assert "cluster.replica.1.load" in m
        assert "cluster.replica.1.transfers_in" in m
        assert len(res.replica_metrics) == 2

    def test_makespan_covers_late_arrivals(self, params):
        cluster = Cluster(_maker(params), 2)
        reqs = [_req(i, [400 + i] * 12) for i in range(3)]
        res = run_online(cluster, CFG, [(reqs[0], 0.0), (reqs[1], 0.0), (reqs[2], 5.0)])
        assert res.total_time >= 5.0
        assert len(res.latencies) == 3

    def test_merged_trace_has_one_pid_per_replica(self, params):
        cluster = Cluster(_maker(params, trace=True), 2)
        reqs = [_req(i, SHARED + [200 + i]) for i in range(4)]
        run_online(cluster, CFG, [(r, 0.0) for r in reqs])
        trace = cluster.chrome_trace()
        assert not validate_chrome_trace(trace)
        assert {e["pid"] for e in trace["traceEvents"]} == {0, 1}
        names = {(e["pid"], e["args"]["name"]) for e in trace["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        assert names == {(0, "llm42-replica-0"), (1, "llm42-replica-1")}

    def test_exhausting_max_iters_raises(self, params):
        cluster = Cluster(_maker(params), 2)
        reqs = [_req(i, [500 + i] * 12, max_new=12) for i in range(4)]
        with pytest.raises(RuntimeError, match="partial"):
            run_online(cluster, CFG, [(r, 0.0) for r in reqs], max_iters=2)

    def test_single_replica_matches_plain_online_runner(self, params):
        """A 1-replica cluster is the single-engine online runner: same
        committed streams, same clock (both on the port's H100 default)."""
        arrivals = [0.0, 0.1, 0.2]
        eng = _maker(params)(0)
        single = single_online(eng, CFG, list(zip(
            [_req(i, SHARED + [200 + i]) for i in range(3)], arrivals)))
        cluster = Cluster(_maker(params), 1)
        res = run_online(cluster, CFG, list(zip(
            [_req(i, SHARED + [200 + i]) for i in range(3)], arrivals)))
        assert _streams(eng.finished) == _streams(cluster.finished)
        assert res.total_time == pytest.approx(single.total_time)
        assert res.latencies == single.latencies and res.ttfts == single.ttfts


@pytest.mark.parametrize("what", ["engine", "cluster"])
def test_dropped_object_is_freed_without_a_collection(params, what):
    """A dropped ``Engine``, or a ``Cluster`` of 2 replicas, is freed at
    once, with the cyclic collector off: the pull gauges of its own metrics
    registry reach it through weak references, so neither it nor its pool
    lives in a reference cycle.  One engine runs first, outside the
    window: torch's first ``use_deterministic_algorithms`` call imports a
    module and leaves that call's frames alive."""
    import gc
    import weakref

    warm = _maker(params)(0)
    warm.submit(_req(0, SHARED[:8], max_new=3))
    warm.run()
    del warm
    gc.collect()
    gc.disable()
    try:
        if what == "engine":
            obj = _maker(params)(0)
            obj.submit(_req(1, SHARED[:8], max_new=3))
            obj.run()
            gauges, pulled = obj.obs.metrics, "engine.peak_running"
        else:
            obj = Cluster(_maker(params), 2)
            run_online(obj, FULL, [(_req(i, SHARED[:8] + [i], max_new=3), 0.0)
                                   for i in range(2)])
            gauges, pulled = obj.metrics, "cluster.replicas"
        assert gauges.snapshot()[pulled] > 0  # read through the live owner
        ref = weakref.ref(obj)
        del obj
        assert ref() is None
        assert gauges.snapshot()[pulled] == 0  # a gone owner reads as 0
    finally:
        gc.enable()


@pytest.mark.parametrize("kw", [{"transfer": "teleport"}, {"imbalance": 0}])
def test_router_rejects_bad_policy(params, kw):
    replicas = Cluster(_maker(params), 1).replicas
    with pytest.raises(AssertionError):
        Router(replicas, **kw)


def _strip_wall(ev):
    if isinstance(ev, dict):
        return {k: _strip_wall(v) for k, v in ev.items() if k != "wall"}
    if isinstance(ev, (list, tuple)):
        return type(ev)(_strip_wall(v) for v in ev)
    return ev


def test_cluster_equals_jax_cluster():
    """Two NONDET replicas on shared weights, one arrival trace with a shared
    2-block prefix and ``imbalance=1``, so the guard diverts and blocks
    move: the port's assignment, router counters, per-replica transfer
    counts, latencies, TTFTs, makespan and event logs equal the JAX
    cluster's on the ``V5E`` clock."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.cluster import Cluster as JCluster, run_online as jrun
    from repro.core.determinism import Mode as JMode
    from repro.models import init_params as jax_init
    from repro.serving import costmodel as jcm
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling

    from repro_torch.models.convert import params_from_numpy

    jcfg = jconfigs.get_smoke_config("llama3-8b")
    jp = jax_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(CFG, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    tails = [rng.integers(0, CFG.vocab_size, 4).tolist() for _ in range(4)]
    arrivals = [0.0, 0.03, 0.031, 0.032]
    kw = dict(window=5, group=2, max_batch=2, capacity=128)

    def run(C, E, params, mode, R, S, run_fn, **hw):
        cluster = C(lambda idx: E(cfg_of[C], params, mode=mode, **kw), 2, imbalance=1)
        reqs = [_req(i, SHARED + t, max_new=5, det=False, R=R, S=S)
                for i, t in enumerate(tails)]
        res = run_fn(cluster, full_of[C], list(zip(reqs, arrivals)), **hw)
        return cluster, res

    cfg_of = {JCluster: jcfg, Cluster: CFG}
    full_of = {JCluster: jconfigs.get_config("llama3-8b"), Cluster: FULL}
    jcl, want = run(JCluster, JEngine, jp, JMode.NONDET, JRequest, JSampling, jrun,
                    hw=jcm.V5E)
    tcl, got = run(Cluster, Engine, tp, Mode.NONDET, Request, SamplingParams, run_online,
                   hw=costmodel.V5E)
    assert got.assignment == want.assignment
    counters = {k: getattr(tcl.router, k) for k in ROUTER_COUNTERS}
    assert counters == {k: getattr(jcl.router, k) for k in ROUTER_COUNTERS}
    assert counters["diverted"] >= 1 and counters["transfers"] >= 1
    assert [r.transfers_in for r in tcl.replicas] == [r.transfers_in for r in jcl.replicas]
    assert got.latencies == want.latencies
    assert got.ttfts == want.ttfts
    assert got.total_time == want.total_time
    assert got.out_tokens == want.out_tokens
    for t_rep, j_rep in zip(tcl.replicas, jcl.replicas):
        assert _strip_wall(t_rep.engine.events) == _strip_wall(j_rep.engine.events)
