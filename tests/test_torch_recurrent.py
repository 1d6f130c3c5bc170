"""Recurrent state on the CPU: rwkv6, the state pool, ``verify_recurrent``
and the engine's recurrent paths.

* ``models.rwkv6``: ``time_mix`` (with its per-position states) and
  ``channel_mix`` against the JAX package's on shared inputs, under the
  commit schedule (fixed-tree step reductions) and a split schedule (the
  library reductions), and the whole rwkv6-smoke ``forward`` with
  ``collect_states``: logits, final states and per-position states within
  ``RWKV_TOL`` (f32 on both sides, each summed in its own order).
* ``serving.statepool`` on rwkv trees, after ``tests/test_statepool.py``'s
  ``TestStateTrees``: gather/scatter round trip, ``select_index``,
  checkpoint/restore into the live pool and the anchor, and the duplicate
  slot assertion.
* ``core.verifier``'s ``verify_recurrent`` against the JAX body on the same
  pool, anchor and windows (a partial and a full match, a pad row):
  verdicts equal, commit rows and the advanced anchor within ``RWKV_TOL``,
  the live state written back unchanged.
* The engine on rwkv6-smoke, after ``TestRecurrentDepth``: overlap at
  spec_depth 2 and 4 with a verify latency commits the pause run's
  streams, the state pool reaching depth 2 / 3, with rollbacks; LLM42 and
  BATCH_INVARIANT streams identical alone and beside neighbours; a
  preempted and restored request commits its un-preempted stream; an
  exclusive or chunked prefill's commit point is the state of its last
  real position, pads never consumed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import (
    VERIFY_SCHEDULE, Mode, ReductionPolicy, Schedule,
)
from repro_torch.core.verifier import make_verify_body
from repro_torch.models import rwkv6, transformer
from repro_torch.models.base import init_params, iter_specs, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import kv_cache, statepool
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import OverlapPolicy, PauseDecodePolicy

CFG = configs.get_smoke_config("rwkv6-3b")
RWKV_TOL = 5e-5
FAST = Schedule(splits=4, kv_splits=4, combine_dtype="float32")
DRIFTY = ReductionPolicy(thresholds=((2, 16), (4, 8), (16, 4)), combine_dtype="bfloat16")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(cfg, seed):
    """Numpy weights for ``cfg``: normal * each matrix's fan-in^-0.5 (the
    spec's scale where it has one: the mixes, decay and bonus), norms ones."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, spec in iter_specs(param_specs(cfg)):
        if spec.init == "ones":
            arr = np.ones(spec.shape, np.float32)
        else:
            scale = spec.scale if spec.scale is not None else spec.shape[-2] ** -0.5
            arr = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def _shared_layer(seed=0):
    """Layer 0's ``rwkv`` weights from numpy, on both sides."""
    jax = pytest.importorskip("jax")

    tree = np_params(CFG, seed)
    tp = params_from_numpy(CFG, tree, "cpu")
    jl = {k: jax.numpy.asarray(v[0]) for k, v in tree["blocks"]["0"]["rwkv"].items()}
    tl = {k: v[0] for k, v in tp["blocks"]["0"]["rwkv"].items()}
    return jl, tl


def _inputs(seed, B=3, W=5):
    rng = np.random.default_rng(seed)
    H, hd = CFG.d_model // CFG.rwkv_head_dim, CFG.rwkv_head_dim
    x = rng.standard_normal((B, W, CFG.d_model)).astype(np.float32)
    prev = rng.standard_normal((B, CFG.d_model)).astype(np.float32)
    wkv = (0.3 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    return x, prev, wkv


def _jax_schedule(schedule):
    from repro.core.determinism import Schedule as JSchedule

    return JSchedule(*schedule)


@pytest.mark.parametrize("schedule", [VERIFY_SCHEDULE, FAST], ids=["commit", "split"])
def test_time_mix_matches_jax(schedule):
    import jax.numpy as jnp
    from repro.models import rwkv6 as jr

    jl, tl = _shared_layer()
    x, prev, wkv = _inputs(1)
    jo, js, jw, jpp = jr.time_mix(jl, CFG, jnp.asarray(x), jnp.asarray(prev),
                                  jnp.asarray(wkv), _jax_schedule(schedule), True)
    wkv_t = torch.from_numpy(wkv)
    to, ts, tw, tpp = rwkv6.time_mix(tl, CFG, torch.from_numpy(x), torch.from_numpy(prev),
                                     wkv_t, schedule, collect_states=True)
    assert torch.equal(wkv_t, torch.from_numpy(wkv)), "the input state was written"
    assert tpp.shape == (3, 5) + wkv.shape[1:]
    for got, want in ((to, jo), (ts, js), (tw, jw), (tpp, jpp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RWKV_TOL, rtol=0)
    assert torch.equal(tpp[:, -1], tw)


def test_channel_mix_matches_jax():
    import jax.numpy as jnp
    from repro.models import rwkv6 as jr

    jl, tl = _shared_layer(3)
    x, prev, _ = _inputs(4)
    jo, js = jr.channel_mix(jl, CFG, jnp.asarray(x), jnp.asarray(prev),
                            _jax_schedule(VERIFY_SCHEDULE))
    to, ts = rwkv6.channel_mix(tl, CFG, torch.from_numpy(x), torch.from_numpy(prev),
                               VERIFY_SCHEDULE)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=RWKV_TOL, rtol=0)
    assert np.array_equal(ts.numpy(), np.asarray(js))


def _state_cache(B):
    return {"blocks": {"0": {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
                             transformer.cache_spec(CFG, B, 8)["blocks"]["0"].items()}}}


def test_forward_with_states_matches_jax():
    """A 7-token pass then a 1-token pass from its states (B = 2), with
    ``collect_states``: logits, the cache's final states and the
    per-position states."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.determinism import VERIFY_SCHEDULE as JV
    from repro.models import transformer as jt

    jcfg = jconfigs.get_smoke_config("rwkv6-3b")
    tree = np_params(CFG, 6)
    tp = params_from_numpy(CFG, tree, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    toks = np.random.default_rng(7).integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    jc = jt.init_cache(jcfg, 2, 8)
    tc = _state_cache(2)
    for s, e in ((0, 7), (7, 8)):
        start = np.full(2, s, np.int32)
        jl, jc, jpp = jt.forward(jp, jcfg, jnp.asarray(toks[:, s:e]), cache=jc,
                                 start_pos=jnp.asarray(start), schedule=JV,
                                 collect_states=True)
        tl, tc, tpp = transformer.forward(tp, CFG, torch.from_numpy(toks[:, s:e]), cache=tc,
                                          start_pos=torch.from_numpy(start),
                                          schedule=VERIFY_SCHEDULE, collect_states=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=RWKV_TOL, rtol=0)
        for k in ("tm_shift", "cm_shift", "wkv"):
            np.testing.assert_allclose(tc["blocks"]["0"][k].numpy(),
                                       np.asarray(jc["blocks"]["0"][k]), atol=RWKV_TOL, rtol=0)
            np.testing.assert_allclose(tpp["blocks"]["0"][k].numpy(),
                                       np.asarray(jpp["blocks"]["0"][k]), atol=RWKV_TOL, rtol=0)
    assert tpp["blocks"]["0"]["wkv"].shape[:3] == (CFG.num_layers, 2, 1)


# ---------------------------------------------------------------------------
# the state pool's trees (after tests/test_statepool.py::TestStateTrees)
# ---------------------------------------------------------------------------


def test_state_spec_keeps_only_recurrent_leaves():
    spec = statepool.state_spec(CFG, batch=3)
    assert set(spec["blocks"]["0"]) == {"tm_shift", "cm_shift", "wkv"}
    assert spec["blocks"]["0"]["wkv"][0] == (CFG.num_layers, 3, 4, 64, 64)
    kimi = configs.get_smoke_config("kimi-k2-1t-a32b")
    assert statepool.state_spec(kimi, 3) == {"head_layers": {"0": None},
                                             "blocks": {"0": None}}
    pool = statepool.StatePool(kimi, num_slots=4, depth=2)
    assert not pool.active and pool.anchor is None and pool.ring == []
    assert pool.restore({"x": 1}, 0, 0) == {"x": 1}


def test_gather_scatter_roundtrip():
    state = statepool.init_state(CFG, 4, "cpu")
    rows = statepool.gather_rows(state, [1, 3])
    bumped = {"blocks": {"0": {k: v + 1.0 for k, v in rows["blocks"]["0"].items()}}}
    statepool.scatter_rows(state, [1, 3], bumped)
    back = statepool.gather_rows(state, [1, 3])
    for k, v in back["blocks"]["0"].items():
        assert torch.equal(v, bumped["blocks"]["0"][k])
    rest = statepool.gather_rows(state, [0, 2])
    assert all(bool((v == 0).all()) for v in rest["blocks"]["0"].values())


def test_scatter_refuses_a_real_slot_twice():
    """Pad rows may all write the scratch slot (the last row); a real slot
    written twice by one ``index_put_`` would take either row on CUDA."""
    state = statepool.init_state(CFG, 4, "cpu")
    rows = statepool.gather_rows(state, [3, 3, 1])
    statepool.scatter_rows(state, [3, 3, 1], rows)  # scratch twice: allowed
    with pytest.raises(AssertionError, match="real slot"):
        statepool.scatter_rows(state, [1, 1, 0], rows)
    pool = kv_cache.CachePool(CFG, 3, 64, device=torch.device("cpu"))
    with pytest.raises(AssertionError, match="real slot"):
        kv_cache.slot_index(pool.data, pool.layout, [0, 0], torch.device("cpu"))


def test_select_index_picks_per_row_positions():
    """per_pos[.., b, j] = the state after window input j of row b; the
    selection is per row; attention placeholders stay None."""
    L, B, W = 2, 3, 4
    pp = {"blocks": {"0": {"wkv": torch.arange(L * B * W * 5, dtype=torch.float32)
                           .reshape(L, B, W, 5)}},
          "head_layers": {"0": None}}
    idx = torch.tensor([0, 2, 3])
    rows = statepool.select_index(pp, idx)
    assert rows["head_layers"]["0"] is None
    for b in range(B):
        assert torch.equal(rows["blocks"]["0"]["wkv"][:, b],
                           pp["blocks"]["0"]["wkv"][:, b, int(idx[b])])


def test_checkpoint_and_restore_roundtrip():
    """A window checkpoint in the ring comes back through ``restore`` into
    both the live pool and the anchor; ``reanchor`` moves the anchor only."""
    pool = statepool.StatePool(CFG, num_slots=2, depth=2, device=torch.device("cpu"))
    assert pool.active
    cache = kv_cache.CachePool(CFG, 2, 16, device=torch.device("cpu"))
    rows = statepool.rows_from_cache(cache.data, [1])
    marked = {"blocks": {"0": {k: v + 7.0 for k, v in rows["blocks"]["0"].items()}}}
    pool.checkpoint([1], [1], marked)
    pool.reanchor(1, 1)
    live = statepool.rows_from_cache(cache.data, [1])
    assert all(bool((v == 0).all()) for v in live["blocks"]["0"].values())
    pool.restore(cache.data, slot=1, ring_idx=1)
    live = statepool.rows_from_cache(cache.data, [1])
    anchored = statepool.gather_rows(pool.anchor, [1])
    for k, want in marked["blocks"]["0"].items():
        assert torch.equal(live["blocks"]["0"][k], want)
        assert torch.equal(anchored["blocks"]["0"][k], want)
    other = statepool.rows_from_cache(cache.data, [0])
    assert all(bool((v == 0).all()) for v in other["blocks"]["0"].values())


# ---------------------------------------------------------------------------
# verify_recurrent against the JAX body
# ---------------------------------------------------------------------------


def test_verify_recurrent_matches_jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.verifier import make_verify_body as jax_body
    from repro.serving import kv_cache as jkv

    jcfg = jconfigs.get_smoke_config("rwkv6-3b")
    tree = np_params(CFG, 8)
    tp = params_from_numpy(CFG, tree, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    G, W, slots_n = 3, 5, 3
    rng = np.random.default_rng(9)
    spec = statepool.state_spec(CFG, slots_n + 1)["blocks"]["0"]
    live_np = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
               for k, (s, _) in spec.items()}
    anchor_np = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
                 for k, (s, _) in spec.items()}
    jpool = jkv.CachePool(jcfg, slots_n, 64)
    jdata = {"blocks": {"0": {k: jnp.asarray(v) for k, v in live_np.items()}}}
    janchor = {"blocks": {"0": {k: jnp.asarray(v) for k, v in anchor_np.items()}}}
    tpool = kv_cache.CachePool(CFG, slots_n, 64, device=torch.device("cpu"))
    for k, v in live_np.items():
        tpool.data["blocks"]["0"][k].copy_(torch.from_numpy(v))
    tanchor = {"blocks": {"0": {k: torch.from_numpy(v.copy()) for k, v in anchor_np.items()}}}

    slots = [2, 0, slots_n]  # two rows and a pad row on the scratch slot
    starts = [9, 4, 0]
    jbody = jax_body(jcfg, G, W, jpool.layout, paged=False)
    jtables = jnp.full((G, jpool.layout.blocks_per_table), -1, jnp.int32)
    greedy = dict(seeds=np.zeros(G, np.int32), temps=np.zeros(G, np.float32),
                  out_base=np.zeros(G, np.int32), top_ks=np.zeros(G, np.int32))

    def jrun(inputs, cand, cand_len):
        return jbody(jp, jdata, janchor, jnp.asarray(slots, jnp.int32), jtables,
                     jnp.asarray(starts, jnp.int32), jnp.asarray(inputs),
                     jnp.asarray(cand), jnp.asarray(cand_len, jnp.int32),
                     *(jnp.asarray(a) for a in greedy.values()))

    # candidates that the verifier accepts: row 0 up to index 2, row 1 all
    cond = np.array([[17], [33], [0]], np.int32)
    cand = np.zeros((G, W - 1), np.int32)
    for j in range(W - 1):
        out = jrun(np.concatenate([cond, cand], axis=1), cand,
                   np.array([W - 1, W - 1, 0]))
        cand[:2, j] = np.asarray(out[5])[:2, j]
    cand[0, 2] = (cand[0, 2] + 1) % CFG.vocab_size
    cand[2] = -1
    cand_len = np.array([W - 1, W - 1, 0], np.int32)
    inputs = np.concatenate([cond, np.maximum(cand, 0)], axis=1)
    (jdata2, janchor2, jcommit, jn, jtok, jv, _) = jrun(inputs, cand, cand_len)

    tbody = make_verify_body(CFG, G, W, tpool.layout, paged=False)
    before = {k: v.clone() for k, v in tpool.data["blocks"]["0"].items()}
    (pool2, anchor2, tcommit, tn, ttok, tv, _) = tbody(
        tp, tpool.data, tanchor, slots, tpool.table_array([[], [], []]),
        torch.tensor(starts, dtype=torch.int32), torch.from_numpy(inputs),
        torch.from_numpy(cand), torch.from_numpy(cand_len), [0] * G, [0.0] * G,
        [0] * G, [0] * G)
    assert tn.tolist() == np.asarray(jn).tolist() == [2, W - 1, 0]
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tv[:2].tolist() == np.asarray(jv)[:2].tolist()
    for k in spec:
        np.testing.assert_allclose(tcommit["blocks"]["0"][k][:, :2].numpy(),
                                   np.asarray(jcommit["blocks"]["0"][k])[:, :2],
                                   atol=RWKV_TOL, rtol=0)
        got_anchor = anchor2["blocks"]["0"][k][:, [2, 0]].numpy()
        want_anchor = np.asarray(janchor2["blocks"]["0"][k])[:, [2, 0]]
        np.testing.assert_allclose(got_anchor, want_anchor, atol=RWKV_TOL, rtol=0)
        # the live state goes back unchanged, in both packages
        assert torch.equal(pool2["blocks"]["0"][k], before[k])
        assert np.array_equal(np.asarray(jdata2["blocks"]["0"][k]), live_np[k])
        # the anchor's untouched real slot keeps its rows
        assert np.array_equal(anchor2["blocks"]["0"][k][:, 1].numpy(), anchor_np[k][:, 1])


# ---------------------------------------------------------------------------
# the engine (after tests/test_statepool.py::TestRecurrentDepth)
# ---------------------------------------------------------------------------

_PARAMS = {}


def _params():
    if "p" not in _PARAMS:
        _PARAMS["p"] = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    return _PARAMS["p"]


def _reqs(rids, det, max_new=14):
    return [Request(rid=i, prompt=[(5 * i + j) % CFG.vocab_size for j in range(9)],
                    sampling=SamplingParams(max_new_tokens=max_new,
                                            is_deterministic=(i in det), seed=70 + i))
            for i in rids]


def _run(scheduler=None, depth=1, rids=(0, 1, 2, 3), mode=Mode.LLM42, preempt_at=None,
         **kw):
    eng = Engine(CFG, _params(), mode=mode, policy=DRIFTY, window=5, group=2,
                 max_batch=8, capacity=256, scheduler=scheduler, spec_depth=depth, **kw)
    for r in _reqs(rids, {0, 2}):
        eng.submit(r)
    if preempt_at is None:
        return {r.rid: r for r in eng.run()}, eng
    while eng.step():
        if eng._now == preempt_at:
            victim = next(r for r in eng.running if r.rid == 0)
            assert eng.preempt(victim)
    return {r.rid: r for r in eng.finished}, eng


_BASE = {}


def _pause_run():
    if "b" not in _BASE:
        _BASE["b"] = _run(PauseDecodePolicy())[0]
    return _BASE["b"]


def _overlap_run(depth, latency):
    """``_run`` under the overlap scheduler, once per (depth, latency):
    the spec-depth and the preemption tests read the same run."""
    if (depth, latency) not in _BASE:
        _BASE[depth, latency] = _run(OverlapPolicy(), depth=depth, verify_latency_ms=latency)
    return _BASE[depth, latency]


@pytest.mark.parametrize("depth,latency,min_depth", [(2, 20.0, 2), (4, 50.0, 3)])
def test_spec_depth_commits_the_pause_streams(depth, latency, min_depth):
    base = _pause_run()
    got, eng = _overlap_run(depth, latency)
    for rid in (0, 2):
        assert got[rid].committed == base[rid].committed, rid
    assert eng.statepool.peak_depth >= min_depth
    assert sum(r.num_rollbacks for r in got.values()) > 0
    assert eng.prefix_cache is None and not eng.pool.paged


@pytest.mark.parametrize("mode", [Mode.LLM42, Mode.BATCH_INVARIANT], ids=lambda m: m.value)
def test_streams_alone_and_beside_neighbours(mode):
    alone, _ = _run(rids=(0, 2), mode=mode)
    crowd, _ = _run(rids=(0, 1, 2, 3), mode=mode)
    for rid in (0, 2):
        assert len(alone[rid].committed) == 14
        assert alone[rid].committed == crowd[rid].committed, rid


def test_preempt_and_restore_keep_the_stream():
    """A request evicted mid-run (its slot's live state wiped for the
    replay) is restored by recompute: it commits the stream of the run
    without the eviction."""
    base, _ = _overlap_run(2, 20.0)
    got, eng = _run(OverlapPolicy(), depth=2, verify_latency_ms=20.0, preempt_at=6)
    assert eng.num_preemptions == 1 and eng.num_restores == 1
    assert eng.statepool.num_preempts == 1
    for rid in (0, 2):
        assert got[rid].committed == base[rid].committed, rid


@pytest.mark.parametrize("chunk", [0, 4], ids=["exclusive", "chunked"])
def test_prefill_keeps_the_state_of_the_last_real_position(chunk):
    """A 9-token prompt prefilled at its bucket of 16 (7 pad positions) or
    in chunks of 4 (the last holding 1 real token and 3 pads): the commit
    point the prefill leaves in the anchor (the slot's live state at the
    prefill's end, which the same iteration's decode then advances) is the
    state of an unpadded pass over the prompt (within ``RWKV_TOL``: the
    GEMMs see other row counts), never a state that consumed a pad."""
    eng = Engine(CFG, _params(), mode=Mode.LLM42, window=5, group=2, max_batch=4,
                 capacity=64, prefill_chunk=chunk)
    req = _reqs([0], {0}, max_new=4)[0]
    eng.submit(req)
    while not req.committed:
        eng.step()
    anchor = statepool.gather_rows(eng.statepool.anchor, [req.slot])["blocks"]["0"]
    cache = _state_cache(1)
    transformer.forward(_params(), CFG, torch.tensor([req.prompt]), cache=cache,
                        start_pos=torch.zeros(1, dtype=torch.int32),
                        schedule=VERIFY_SCHEDULE)
    for k, want in cache["blocks"]["0"].items():
        np.testing.assert_allclose(anchor[k].numpy(), want.numpy(), atol=RWKV_TOL, rtol=0)
