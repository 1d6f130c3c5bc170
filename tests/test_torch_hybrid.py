"""The hybrid family on the CPU: jamba's configs, ``models.mamba``, the
stacked block period, attention biases and the engine on jamba-smoke.

* The three jamba configs (published, ``long_config`` jamba-1.5-large-sw4k
  and ``smoke_config`` jamba-smoke) equal the JAX package's field for
  field, with the same layer and FFN kinds and block period (8 for the
  published config, 2 for smoke), and the JAX tree converts to the port's
  (``blocks/0`` .. ``blocks/{period - 1}``) leaf for leaf.
* ``mamba_layer`` against the JAX package's at W = 1 and W = 8, from zeros
  and from a given state, with and without ``collect_states``, under the
  commit schedule (fixed-tree conv and scan sums) and a split schedule
  (``einsum``), within ``FWD_TOL``; its commit-schedule rows do not follow
  B.
* The jamba-smoke ``forward`` (a prefill, then a decode from its cache,
  both with ``collect_states``) against JAX's: logits, the attention KV,
  the mamba states and the per-position states.
* The engine on jamba-smoke: LLM42 greedy streams on the paged lane
  against the JAX engine on shared weights (compared up to the first
  near-tie, reported); LLM42 and BATCH_INVARIANT streams alone and beside
  3 neighbours on both lanes; overlap at spec_depth 2 == pause; a
  preempted and restored request; chunked prefill == exclusive; the
  sliding ``long_config`` at smoke widths across a ring wrap.
* A ``use_bias`` config's forward against JAX's on non-zero biases.

JAX runs on the CPU; no Pallas kernel is on this path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import (
    VERIFY_SCHEDULE, Mode, ReductionPolicy, Schedule,
)
from repro_torch.models import mamba, transformer
from repro_torch.models.base import iter_specs, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import statepool
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import OverlapPolicy, PauseDecodePolicy

ARCH = "jamba-1.5-large-398b"
CFG = configs.get_smoke_config(ARCH)
#: f32 on both sides, each framework summing in its own order
FWD_TOL = 1e-4
#: a verifier margin 10x the logits' disagreement cannot flip a token
MARGIN_TOL = 1e-3
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
    spec's scale where it has one), ``ones`` leaves ones, ``zeros`` leaves
    small normals (so the conv, dt and attention biases are exercised)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, spec in iter_specs(param_specs(cfg)):
        if spec.init == "ones":
            arr = np.ones(spec.shape, np.float32)
        elif spec.init == "zeros":
            arr = (0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        else:
            scale = spec.scale if spec.scale is not None else spec.shape[-2] ** -0.5
            arr = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


@pytest.fixture(scope="module")
def shared():
    """(numpy tree, JAX params, port params) of one numpy tree."""
    jax = pytest.importorskip("jax")

    tree = np_params(CFG, 3)
    return (tree, jax.tree_util.tree_map(jax.numpy.asarray, tree),
            params_from_numpy(CFG, tree, "cpu"))


def _close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


def _jsched(schedule):
    from repro.core.determinism import Schedule as JSchedule

    return JSchedule(*schedule)


# ---------------------------------------------------------------------------
# configs and the param tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("getter,period", [
    ("get_config", 8), ("get_long_config", 8), ("get_smoke_config", 2)])
def test_configs_match_jax(getter, period):
    pytest.importorskip("jax")
    from repro import configs as jconfigs

    cfg, jcfg = getattr(configs, getter)(ARCH), getattr(jconfigs, getter)(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.block_period() == jcfg.block_period() == period
    n = cfg.num_layers
    assert [cfg.layer_kind(i) for i in range(n)] == [jcfg.layer_kind(i) for i in range(n)]
    assert [cfg.ffn_kind(i) for i in range(n)] == [jcfg.ffn_kind(i) for i in range(n)]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert set(param_specs(cfg)["blocks"]) == {str(p) for p in range(period)}


def test_convert_round_trip():
    """The JAX package's initialized tree converts leaf for leaf, keys and
    values, into the port's stacked-period tree."""
    jax = pytest.importorskip("jax")
    from repro.models import init_params as jax_init

    jp = jax_init(configs.get_smoke_config(ARCH), jax.random.key(1))
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(CFG, np_tree, "cpu")
    jpaths = {tuple(getattr(k, "key", k) for k in path)
              for path, _ in jax.tree_util.tree_leaves_with_path(jp)}
    assert jpaths == {path for path, _ in iter_specs(param_specs(CFG))}
    for path, _ in iter_specs(param_specs(CFG)):
        want, got = np_tree, tp
        for k in path:
            want, got = want[k], got[k]
        assert np.array_equal(got.numpy(), want), path
    assert set(tp["blocks"]["0"]) == {"attn", "ffn", "norm0", "norm1"}
    assert set(tp["blocks"]["1"]) == {"mamba", "moe", "norm0", "norm1"}


# ---------------------------------------------------------------------------
# mamba_layer
# ---------------------------------------------------------------------------


def _mamba_inputs(seed, B, W):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, W, CFG.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, CFG.d_conv - 1, CFG.d_inner)).astype(np.float32)
    ssm = (0.3 * rng.standard_normal((B, CFG.d_inner, CFG.d_state))).astype(np.float32)
    return x, {"conv": conv, "ssm": ssm}


@pytest.mark.parametrize("schedule", [VERIFY_SCHEDULE, FAST], ids=["commit", "split"])
@pytest.mark.parametrize("W", [1, 8])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("collect", [False, True], ids=["final", "per_pos"])
def test_mamba_layer_matches_jax(shared, schedule, W, with_state, collect):
    import jax.numpy as jnp
    from repro.models import mamba as jm

    tree, _, tp = shared
    jl = {k: jnp.asarray(v[0]) for k, v in tree["blocks"]["1"]["mamba"].items()}
    tl = {k: v[0] for k, v in tp["blocks"]["1"]["mamba"].items()}
    x, st = _mamba_inputs(10 + W, 3, W)
    jst = {k: jnp.asarray(v) for k, v in st.items()} if with_state else None
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()} if with_state else None
    jo, jnew, jpp = jm.mamba_layer(jl, CFG, jnp.asarray(x), jst, _jsched(schedule), collect)
    to, tnew, tpp = mamba.mamba_layer(tl, CFG, torch.from_numpy(x), tst, schedule, collect)
    _close(to, jo)
    for k in ("conv", "ssm"):
        _close(tnew[k], jnew[k])
    if with_state:
        assert all(np.array_equal(tst[k].numpy(), st[k]) for k in st), "state written"
    assert (tpp is None) == (not collect)
    if collect:
        assert tpp["conv"].shape == (3, W, CFG.d_conv - 1, CFG.d_inner)
        assert tpp["ssm"].shape == (3, W, CFG.d_inner, CFG.d_state)
        for k in ("conv", "ssm"):
            _close(tpp[k], jpp[k])
            assert torch.equal(tpp[k][:, -1], tnew[k])


@pytest.mark.parametrize("W", [1, 8])
def test_mamba_commit_rows_follow_no_batch(shared, W, monkeypatch):
    """Under the commit schedule a row's output and per-position states are
    the same bits at B = 1, 3 and 7: the fixed-tree conv and scan sums.
    The CPU's f32 matmul, which the GEMMs' plain versions call, is not
    M-invariant, so here the projections run one row at a time (the commit
    GEMM's rows do not follow M on the card, where chip_smoke.py checks the
    whole layer at Jamba's widths)."""
    from repro_torch.core.determinism import matmul

    def by_row(x, w, schedule):
        rows = x.reshape(-1, x.shape[-1])
        out = torch.cat([matmul(r[None], w, schedule) for r in rows])
        return out.reshape(*x.shape[:-1], w.shape[1])

    monkeypatch.setattr(mamba, "matmul", by_row)
    _, _, tp = shared
    tl = {k: v[0] for k, v in tp["blocks"]["1"]["mamba"].items()}
    x, st = _mamba_inputs(20 + W, 7, W)
    outs = {}
    for B in (1, 3, 7):
        state = {k: torch.from_numpy(v[:B].copy()) for k, v in st.items()}
        o, _, pp = mamba.mamba_layer(tl, CFG, torch.from_numpy(x[:B]), state,
                                     VERIFY_SCHEDULE, True)
        outs[B] = (o[0], pp["conv"][0], pp["ssm"][0])
    for B in (3, 7):
        for got, want in zip(outs[B], outs[1]):
            assert torch.equal(got, want), B


# ---------------------------------------------------------------------------
# the whole smoke forward
# ---------------------------------------------------------------------------


def test_forward_with_states_matches_jax(shared):
    """A 7-token prefill then a 1-token decode from its cache (B = 2) with
    ``collect_states``: logits, the attention K/V of the period's attention
    layers, the mamba states and the per-position states."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.determinism import VERIFY_SCHEDULE as JV
    from repro.models import transformer as jt

    _, jp, tp = shared
    jcfg = jconfigs.get_smoke_config(ARCH)
    toks = np.random.default_rng(7).integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    jc = jt.init_cache(jcfg, 2, 16)
    tc = {"blocks": {p: {k: (torch.full(s, -1, dtype=d) if d == torch.int32
                             else torch.zeros(s, dtype=d)) for k, (s, d) in leaves.items()}
                     for p, leaves in transformer.cache_spec(CFG, 2, 16)["blocks"].items()}}
    # jitted, as the reference's engine runs it (op by op every primitive
    # compiles on its own)
    fwd = jax.jit(lambda p, x, c, st: jt.forward(p, jcfg, x, cache=c, start_pos=st,
                                                 schedule=JV, collect_states=True))
    for s, e in ((0, 7), (7, 8)):
        start = np.full(2, s, np.int32)
        jl, jc, jpp = fwd(jp, jnp.asarray(toks[:, s:e]), jc, jnp.asarray(start))
        tl, tc, tpp = transformer.forward(tp, CFG, torch.from_numpy(toks[:, s:e]),
                                          cache=tc, start_pos=torch.from_numpy(start),
                                          schedule=VERIFY_SCHEDULE, collect_states=True)
        _close(tl, jl)
        assert tpp["blocks"]["0"] is None
        for k in ("k", "v", "pos"):
            _close(tc["blocks"]["0"][k], jc["blocks"]["0"][k])
        for k in ("conv", "ssm"):
            _close(tc["blocks"]["1"][k], jc["blocks"]["1"][k])
            _close(tpp["blocks"]["1"][k], jpp["blocks"]["1"][k])
    assert tpp["blocks"]["1"]["ssm"].shape[:3] == (CFG.num_layers // 2, 2, 1)


def test_bias_forward_matches_jax():
    """A ``use_bias`` config (llama3-8b smoke with biases) on non-zero
    ``bq``, ``bk``, ``bv``: a prefill and a decode against JAX's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.determinism import VERIFY_SCHEDULE as JV
    from repro.models import transformer as jt

    cfg = dataclasses.replace(configs.get_smoke_config("llama3-8b"), use_bias=True)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("llama3-8b"), use_bias=True)
    tree = np_params(cfg, 5)
    assert "bq" in tree["blocks"]["0"]["attn"]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(cfg, tree, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jc = jt.init_cache(jcfg, 2, 8)
    tc = {"blocks": {"0": {k: (torch.full(s, -1, dtype=d) if d == torch.int32
                               else torch.zeros(s, dtype=d)) for k, (s, d) in
                           transformer.cache_spec(cfg, 2, 8)["blocks"]["0"].items()}}}
    fwd = jax.jit(lambda p, x, c, st: jt.forward(p, jcfg, x, cache=c, start_pos=st,
                                                 schedule=JV))
    for s, e in ((0, 5), (5, 6)):
        start = np.full(2, s, np.int32)
        jl, jc, _ = fwd(jp, jnp.asarray(toks[:, s:e]), jc, jnp.asarray(start))
        tl, tc, _ = transformer.forward(tp, cfg, torch.from_numpy(toks[:, s:e]), cache=tc,
                                        start_pos=torch.from_numpy(start),
                                        schedule=VERIFY_SCHEDULE)
        _close(tl, jl)


# ---------------------------------------------------------------------------
# the engine on jamba-smoke
# ---------------------------------------------------------------------------


def _reqs(rids, det=(0, 2), max_new=10, plen=9, cfg=CFG):
    return [Request(rid=i, prompt=[(5 * i + j + 1) % cfg.vocab_size for j in range(plen)],
                    sampling=SamplingParams(max_new_tokens=max_new,
                                            is_deterministic=i in det, seed=70 + i,
                                            temperature=0.8 if i == 2 else 0.0))
            for i in rids]


def _run(params, *, cfg=CFG, rids=(0, 1, 2, 3), mode=Mode.LLM42, preempt_at=None,
         reqs=None, **kw):
    kw = dict(dict(policy=DRIFTY, window=5, group=2, max_batch=4, capacity=128), **kw)
    eng = Engine(cfg, params, mode=mode, **kw)
    for r in reqs or _reqs(rids, cfg=cfg):
        eng.submit(r)
    if preempt_at is None:
        return {r.rid: r.committed for r in eng.run()}, eng
    while eng.step():
        if eng._now == preempt_at:
            assert eng.preempt(next(r for r in eng.running if r.rid == 0))
    return {r.rid: r.committed for r in eng.finished}, eng


def test_engine_matches_jax_engine(shared):
    """LLM42, greedy, paged, the pause scheduler (the fewest shape classes
    for the JAX engine to jit): 2 requests of 8 new tokens on shared
    weights commit the same tokens up to the first near-tie."""
    from repro import configs as jconfigs
    from repro.core.determinism import Mode as JMode
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling
    from repro.serving.scheduler import PauseDecodePolicy as JPause

    _, jp, tp = shared
    kw = dict(window=4, group=2, max_batch=2, capacity=64)
    jeng = JEngine(jconfigs.get_smoke_config(ARCH), jp, mode=JMode.LLM42,
                   scheduler=JPause(), **kw)
    teng = Engine(CFG, tp, mode=Mode.LLM42, audit=True, scheduler=PauseDecodePolicy(),
                  **kw)
    assert teng.pool.paged and teng.has_recurrent_state and teng.prefix_cache is None
    for r in _reqs((0, 1), det=(0, 1), max_new=8):
        r.sampling.temperature = 0.0
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


@pytest.fixture(scope="module")
def alone_runs(shared):
    """The deterministic requests 0 and 2 alone, per (mode, lane), each run
    once: a lane's run is also the other lane's comparison."""
    runs = {}

    def get(mode, paged):
        if (mode, paged) not in runs:
            runs[mode, paged] = _run(shared[2], rids=(0, 2), mode=mode, paged_attention=paged)
        return runs[mode, paged]

    return get


@pytest.fixture(scope="module")
def overlap_run(shared):
    """Overlap at spec_depth 2 with a 20 ms verify latency: the spec-depth
    test's run and the preemption test's reference."""
    return _run(shared[2], scheduler=OverlapPolicy(), spec_depth=2, verify_latency_ms=20.0)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gathered"])
@pytest.mark.parametrize("mode", [Mode.LLM42, Mode.BATCH_INVARIANT], ids=lambda m: m.value)
def test_streams_alone_and_beside_neighbours(shared, alone_runs, mode, paged):
    """The greedy (0) and seeded (2) deterministic requests commit the same
    stream alone and beside 3 neighbours, and the lanes agree."""
    _, _, tp = shared
    alone, _ = alone_runs(mode, paged)
    crowd, eng = _run(tp, rids=(0, 1, 2, 3, 4), mode=mode, paged_attention=paged)
    assert eng.pool.paged
    for rid in (0, 2):
        assert len(alone[rid]) == 10
        assert alone[rid] == crowd[rid], rid
    if mode == Mode.LLM42:
        other, _ = alone_runs(mode, not paged)
        assert other[0] == alone[0] and other[2] == alone[2]


def test_spec_depth_two_overlap_equals_pause(shared, overlap_run):
    _, _, tp = shared
    base, _ = _run(tp, scheduler=PauseDecodePolicy())
    got, eng = overlap_run
    for rid in (0, 2):
        assert got[rid] == base[rid], rid
    assert eng.statepool.peak_depth >= 2


def test_preempt_and_restore_keep_the_stream(shared, overlap_run):
    """A request evicted mid-run (its slot's mamba state wiped, its KV
    blocks freed) is restored by recompute and commits the stream of the
    run without the eviction."""
    _, _, tp = shared
    base, _ = overlap_run
    got, eng = _run(tp, scheduler=OverlapPolicy(), spec_depth=2, verify_latency_ms=20.0,
                    preempt_at=6)
    assert eng.num_preemptions == 1 and eng.num_restores == 1
    for rid in (0, 2):
        assert got[rid] == base[rid], rid


def test_chunked_prefill_equals_exclusive(shared):
    """Chunks of 4 (a 13-token prompt: the last chunk 1 real token and 3
    pads) commit the exclusive prefill's streams; the state pool's anchor
    holds the state of the last real position either way."""
    _, _, tp = shared
    reqs = lambda: _reqs((0, 1, 2), plen=13)  # noqa: E731
    base, e0 = _run(tp, reqs=reqs())
    got, e4 = _run(tp, reqs=reqs(), prefill_chunk=4)
    for rid in (0, 2):
        assert got[rid] == base[rid], rid
    assert any(ev["kind"] == "prefill_chunk" for ev in e4.events)


def test_sliding_long_config_at_smoke_width():
    """jamba-1.5-large-sw4k cut to smoke widths and a 16-token window:
    rings and mamba state in slot leaves (no paged lane); 24-token prompts
    and 12 new tokens wrap the ring; streams alone == beside neighbours."""
    cfg = dataclasses.replace(configs.get_long_config(ARCH), **{
        f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)
        if f.name not in ("name", "attn_kind", "window", "max_seq_len")},
        window=16, max_seq_len=512)
    assert cfg.attn_kind == "sliding" and cfg.block_period() == 2
    tp = params_from_numpy(cfg, np_params(cfg, 4), "cpu")
    alone, eng = _run(tp, cfg=cfg, reqs=_reqs((0, 2), plen=24, max_new=12, cfg=cfg))
    crowd, _ = _run(tp, cfg=cfg, reqs=_reqs((0, 1, 2, 3), plen=24, max_new=12, cfg=cfg))
    assert not eng.pool.paged and eng.has_recurrent_state
    spec = statepool.state_spec(cfg, 2)["blocks"]
    assert spec["0"] is None and set(spec["1"]) == {"conv", "ssm"}
    for rid in (0, 2):
        assert len(alone[rid]) == 12 and alone[rid] == crowd[rid], rid
