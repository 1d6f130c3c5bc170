"""Sliding-window rings and the q-chunked attention on the CPU.

* ``_chunked_attend`` against the JAX package's at T = 700 (the pad path),
  window 0 and 64, kv_splits 1 and 4 (bf16 combine), within ``ATTN_TOL``
  (``_close``: under the bf16 combine an element may differ by a partial's
  rounding flip instead, up to ``BF16_FLIP`` of max|ref|, with the mean
  difference still within ``ATTN_TOL``).
* The ring in ``attention_cached`` against the JAX one, window 8, over more
  positions than the ring's 136 slots: a 128-token pass (the contract's
  longest) and W = 5 passes under the commit schedule, and W = 1 passes
  across the wrap under one kv split (the port's fixed-order single-row
  path) and four; outputs within ``ATTN_TOL``, ring positions exactly.
* Forward logits against JAX within ``LOGIT_TOL`` for phi3 smoke with a
  window of 8 and llama4's chunked smoke (MoE + window 8), fed in 8-token
  chunks past a 64-slot ring's wrap; the pool's ring leaves are slot-kind
  and shaped as the JAX pool's.
* The ring-pass cap: at a window above ``RING_SLACK + 1`` the JAX engine's
  window-sized prefill chunks trip its own ring-contract assertion; the
  port prefills in ``RING_SLACK + 1``-token chunks, and its logits equal
  the JAX full causal pass's.
* The engine on the sliding smoke config: LLM42 streams identical alone and
  beside neighbours with prompts longer than the window, outputs that wrap
  the ring and a rollback after the wrap, on both lanes; a preempted and
  restored request commits what it commits unpreempted.
* The gathered lane prefills a prompt of more than ``CHUNK_THRESHOLD``
  tokens (q-chunked) and commits the paged lane's stream.
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
from repro_torch.models import layers
from repro_torch.models.base import init_params, iter_specs, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import RING_SLACK, cache_spec, forward
from repro_torch.serving import blockpool, kv_cache
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams

ATTN_TOL = 1e-5
#: the bf16 combine rounds each running (d, o) partial to bf16: a partial
#: near a rounding midpoint rounds either way as the two frameworks' f32
#: summation orders differ, moving an output by up to one bf16 ulp of the
#: partial (2^-8 relative; two ulps of max|ref| allowed, as
#: test_torch_kernels allows the decode model)
BF16_FLIP = 2.0 ** -7
LOGIT_TOL = 2e-4
SLIDING = dataclasses.replace(configs.get_smoke_config("phi3-mini-3.8b"),
                              attn_kind="sliding", window=8)
CHUNKED = dataclasses.replace(configs.get_smoke_config("llama4-scout-17b-a16e"),
                              attn_kind="sliding", window=8)
FAST = Schedule(splits=4, kv_splits=4, combine_dtype="bfloat16")
DEMO_POLICY = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                              combine_dtype="bfloat16")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(cfg, seed):
    """A numpy parameter tree for ``cfg`` from ``seed``: normal * each
    matrix's fan-in^-0.5 (the spec's scale where it has one), norms ones,
    so activations stay O(1) (the JAX initializer scales stacked leaves by
    the layer count instead)."""
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


def _close(got, want, combine_dtype, msg=""):
    """``got`` within ``ATTN_TOL`` of ``want``; under a bf16 combine within
    ``BF16_FLIP`` of max|want| elementwise and ``ATTN_TOL`` on the mean."""
    want = np.asarray(want)
    if combine_dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=0, err_msg=msg)
        return
    diff = np.abs(got - want)
    assert diff.max() <= BF16_FLIP * np.abs(want).max(), msg
    assert diff.mean() <= ATTN_TOL, msg


def _jnp_tree(tree):
    jax = pytest.importorskip("jax")
    return jax.tree_util.tree_map(jax.numpy.asarray, tree)


def _dense_cache(cfg, batch, capacity):
    """The port's dense cache of ``cache_spec`` (positions -1)."""
    def make(leaf):
        if isinstance(leaf, dict):
            return {k: make(v) for k, v in leaf.items()}
        shape, dtype = leaf
        fill = -1 if dtype == torch.int32 else 0
        return torch.full(shape, fill, dtype=dtype)
    return make(cache_spec(cfg, batch, capacity))


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("splits", [1, 4])
def test_chunked_attend_matches_jax(window, splits):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import Schedule as JSchedule
    from repro.models.layers import _chunked_attend as jchunked

    rng = np.random.default_rng(window + splits)
    B, T, H, KV, D, S = 2, 700, 8, 2, 32, 760
    q = (rng.standard_normal((B, T, H, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    q_pos = (np.arange(T)[None] + np.array([[40], [60]])).astype(np.int32)
    k_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    k_pos[1, 700:] = -1  # row 1's tail is empty
    sched = Schedule(kv_splits=splits, combine_dtype="bfloat16")
    want = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
                    jnp.asarray(k_pos), JSchedule(*sched), 0.0, window)
    got = layers._chunked_attend(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(q_pos),
                                 torch.from_numpy(k_pos), sched, 0.0, window)
    assert got.shape == (B, T, H, D)
    _close(got.numpy(), want, "float32" if splits == 1 else sched.combine_dtype)


@pytest.mark.parametrize("sched", [VERIFY_SCHEDULE, FAST], ids=["one_split", "four_splits"])
def test_ring_attention_cached_matches_jax_across_the_wrap(sched):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import Schedule as JSchedule
    from repro.models.layers import attention_cached as jattn
    from repro.models.transformer import init_cache as jinit

    cfg, window = SLIDING, SLIDING.window
    tree = np_params(cfg, 1)
    jp = {k: jnp.asarray(v[0]) for k, v in tree["blocks"]["0"]["attn"].items()}
    tp = {k: torch.from_numpy(v[0]) for k, v in tree["blocks"]["0"]["attn"].items()}
    C = window + RING_SLACK  # 136 slots at the smoke capacity
    jc = {k: v[0] for k, v in jinit(cfg, 2, cfg.max_seq_len)["blocks"]["0"].items()}
    tc = {k: v[0] for k, v in _dense_cache(cfg, 2, cfg.max_seq_len)["blocks"]["0"].items()}
    assert tc["k"].shape[1] == jc["k"].shape[1] == C
    # as in the engine, multi-token passes (a 128-token prefill: 128 + 7
    # slots, the contract's edge; W = 5 verify windows) run the commit
    # schedule, jitted, and W = 1 decode passes run ``sched``: op by op where
    # the combine is bf16, since XLA's fusions may keep excess precision
    # where ops round to bf16
    jcommit = jax.jit(jattn, static_argnums=(1, 5, 6))
    if sched.combine_dtype == "float32":
        jattn = jcommit
    V = VERIFY_SCHEDULE
    rng = np.random.default_rng(2)
    offset = np.array([0, 3], np.int32)
    passes = [(128, 0, V), (5, 128, V), (5, 133, V)]
    passes += [(1, 138 + i, sched) for i in range(8)] + [(5, 146, V)]
    wrapped = False
    for W, s, sc in passes:
        x = rng.standard_normal((2, W, cfg.d_model)).astype(np.float32)
        start = offset + s
        jfn = jcommit if sc is V else jattn
        jo, jc = jfn(jp, cfg, jnp.asarray(x), jc, jnp.asarray(start),
                     JSchedule(*sc), window)
        to, tc = layers.attention_cached(tp, cfg, torch.from_numpy(x), tc,
                                         torch.from_numpy(start), sc, window)
        _close(to.numpy(), jo, sc.combine_dtype, f"W={W} start={start}")
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=ATTN_TOL)
        wrapped |= bool((start + W > C).any())
    assert wrapped and int(tc["pos"].max()) > C


def test_ring_contract_is_asserted():
    cfg = SLIDING
    tp = {k: torch.from_numpy(v[0]) for k, v in
          np_params(cfg, 1)["blocks"]["0"]["attn"].items()}
    tc = {k: v[0] for k, v in _dense_cache(cfg, 1, 64)["blocks"]["0"].items()}
    x = torch.zeros((1, 60, cfg.d_model))
    with pytest.raises(AssertionError, match="chunk"):
        layers.attention_cached(tp, cfg, x, tc, torch.zeros(1, dtype=torch.int32),
                                VERIFY_SCHEDULE, cfg.window)  # 60 + 7 > 64


@pytest.mark.parametrize("cfg", [SLIDING, CHUNKED], ids=lambda c: c.name)
def test_ring_forward_matches_jax(cfg):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import VERIFY_SCHEDULE as JV
    from repro.models.transformer import forward as jforward, init_cache as jinit

    jforward = jax.jit(jforward, static_argnames=("cfg", "schedule"))
    tree = np_params(cfg, 3)
    jp, tp = _jnp_tree(tree), params_from_numpy(cfg, tree, "cpu")
    jc, tc = jinit(cfg, 1, 64), _dense_cache(cfg, 1, 64)  # 64-slot rings
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 80)).astype(np.int32)
    for s in range(0, 80, 8):
        chunk = toks[:, s:s + 8]
        jl, jc, _ = jforward(jp, cfg=cfg, tokens=jnp.asarray(chunk), cache=jc,
                             start_pos=jnp.full((1,), s, jnp.int32), schedule=JV)
        tl, tc, _ = forward(tp, cfg, torch.from_numpy(chunk), cache=tc,
                            start_pos=torch.full((1,), s, dtype=torch.int32),
                            schedule=VERIFY_SCHEDULE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    assert int(tc["blocks"]["0"]["pos"].max()) == 79  # the ring wrapped


@pytest.mark.parametrize("cfg", [SLIDING, CHUNKED, configs.get_smoke_config("llama3-8b")],
                         ids=lambda c: c.name)
def test_pool_leaves_match_jax(cfg):
    pytest.importorskip("jax")
    jax = pytest.importorskip("jax")
    from repro.serving import blockpool as jbp

    lay = blockpool.build_layout(cfg, 256, 16, 40)
    jlay = jbp.build_layout(cfg, 256, 16, 40)
    kinds = set(blockpool._leaves(lay.kinds))
    assert kinds == {d.kind for d in jax.tree_util.tree_leaves(jlay.axes)}
    assert lay.has_paged == jlay.has_paged == (cfg.attn_kind == "full")
    pool = blockpool.init_cache(cfg, lay, 3, torch.device("cpu"))
    jpool = jbp.init_cache(cfg, jlay, 3)
    for k in ("k", "v", "pos"):
        assert tuple(pool["blocks"]["0"][k].shape) == jpool["blocks"]["0"][k].shape
    if kinds == {"slot"}:
        # wipe_slot resets one row and leaves the others
        pool["blocks"]["0"]["pos"].fill_(5)
        blockpool.wipe_slot(pool, lay, 1)
        pos = pool["blocks"]["0"]["pos"]
        assert bool((pos[:, 1] == -1).all()) and bool((pos[:, [0, 2, 3]] == 5).all())


def test_ring_pass_cap_repairs_the_reference_window_chunks():
    """window 200 > RING_SLACK + 1: a ring of 328 slots cannot take the
    JAX engine's 200-token chunks (200 + 199 > 328), so its prefill trips
    the ring contract; the port prefills in 129-token chunks, and the logits
    those chunks give equal the JAX full causal pass's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import Mode as JMode
    from repro.models.transformer import forward_train
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSP

    cfg = dataclasses.replace(SLIDING, window=200, num_layers=1)
    tree = np_params(cfg, 5)
    jp, tp = _jnp_tree(tree), params_from_numpy(cfg, tree, "cpu")
    prompt = [(7 * j) % cfg.vocab_size for j in range(300)]
    jeng = JEngine(cfg, jp, mode=JMode.NONDET, max_batch=1, capacity=512)
    jeng.submit(JRequest(rid=0, prompt=prompt, sampling=JSP(max_new_tokens=2)))
    with pytest.raises(AssertionError, match="chunk"):
        jeng.run()
    eng = Engine(cfg, tp, mode=Mode.NONDET, max_batch=1, capacity=512)
    assert eng._chunk_size() == 1 and eng._ring_pass_cap(256) == RING_SLACK + 1
    eng.submit(Request(rid=0, prompt=prompt, sampling=SamplingParams(max_new_tokens=2)))
    done = eng.run()
    assert len(done[0].committed) == 2
    prefill = [ev for ev in eng.events if ev["kind"] == "prefill"]
    assert prefill[0]["padded"] == 3 * (RING_SLACK + 1)
    # the cap's chunks, fed to the forward by hand, against the full pass
    want, _ = forward_train(jp, cfg, jnp.asarray([prompt], jnp.int32))
    cache, outs = _dense_cache(cfg, 1, 512), []
    for s in range(0, 300, RING_SLACK + 1):
        chunk = torch.tensor([prompt[s:s + RING_SLACK + 1]], dtype=torch.int32)
        lg, cache, _ = forward(tp, cfg, chunk, cache=cache,
                               start_pos=torch.full((1,), s, dtype=torch.int32))
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


@pytest.fixture(scope="module")
def sliding_params():
    return init_params(SLIDING, torch.Generator().manual_seed(3), "cpu")


def _sliding_engine(params, paged=True, **kw):
    return Engine(SLIDING, params, mode=Mode.LLM42, policy=DEMO_POLICY, window=6,
                  group=2, max_batch=4, capacity=512, paged_attention=paged,
                  audit=True, **kw)


def _det_requests():
    return [Request(rid=rid, prompt=[(rid * 7 + 3 * k) % 500 for k in range(100 + 9 * rid)],
                    sampling=SamplingParams(max_new_tokens=48, is_deterministic=True,
                                            **kw))
            for rid, kw in ((0, dict(seed=3)), (1, dict(seed=4, temperature=0.8, top_k=20)))]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gathered"])
def test_sliding_engine_llm42_streams_across_the_wrap(sliding_params, paged):
    C = SLIDING.window + RING_SLACK

    def run(neighbours):
        eng = _sliding_engine(sliding_params, paged)
        assert not eng.pool.paged and not eng._paged_fwd and eng.prefix_cache is None
        for r in _det_requests():
            eng.submit(r)
        for i in range(neighbours):
            eng.submit(Request(rid=10 + i, prompt=[3 * i + k for k in range(12)],
                               sampling=SamplingParams(max_new_tokens=24)))
        done = {r.rid: r for r in eng.run()}
        # a rollback whose window lies past the ring's first wrap
        wrapped_rollbacks = [
            rec for rec in eng.obs.audit.records
            if rec.rollback and rec.rid in (0, 1)
            and done[rec.rid].prompt_len + rec.index > C]
        return {rid: done[rid].committed for rid in (0, 1)}, len(wrapped_rollbacks)

    alone, rb0 = run(0)
    crowd, rb3 = run(3)
    assert all(len(s) == 48 for s in alone.values())
    assert crowd == alone
    assert rb0 + rb3 > 0


def test_sliding_restore_replays_on_a_wiped_ring(sliding_params):
    """Preempt a deterministic request mid-decode on a sliding pool (its
    ring past the wrap), let it restore: the replay starts on a wiped slot
    and the stream equals the unpreempted one."""
    def run(preempt_at):
        eng = _sliding_engine(sliding_params)
        reqs = _det_requests()
        for r in reqs:
            eng.submit(r)
        it = 0
        while eng.step():
            it += 1
            if it == preempt_at:
                assert eng.preempt(reqs[0])
                assert eng.pool.data["blocks"]["0"]["pos"][:, reqs[0].slot].max() > 0
        return [r.committed for r in reqs], eng.num_restores

    base, n0 = run(-1)
    again, n1 = run(30)
    assert n0 == 0 and n1 == 1
    assert again == base


def test_gathered_lane_prefills_past_the_chunk_threshold():
    """An exclusive prefill of a 2100-token prompt on the gathered lane
    (bucket 4096 > CHUNK_THRESHOLD: ``_chunked_attend``) commits the paged
    lane's stream (one layer: the 4096-token passes dominate the time)."""
    cfg = dataclasses.replace(configs.get_smoke_config("llama3-8b"), num_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    calls = []
    real = layers._chunked_attend

    def spy(q, *a):
        calls.append(q.shape[1])
        return real(q, *a)

    streams = {}
    for paged in (True, False):
        eng = Engine(cfg, params, mode=Mode.LLM42, window=4, group=1, max_batch=1,
                     capacity=4096, paged_attention=paged)
        eng.submit(Request(rid=0, prompt=[(5 * k) % cfg.vocab_size for k in range(2100)],
                           sampling=SamplingParams(max_new_tokens=6, is_deterministic=True)))
        layers._chunked_attend = spy
        try:
            streams[paged] = eng.run()[0].committed
        finally:
            layers._chunked_attend = real
    assert calls == [4096] * cfg.num_layers  # the gathered prefill only
    assert len(streams[True]) == 6 and streams[False] == streams[True]
