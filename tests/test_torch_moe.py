"""The MoE FFN (``models.layers.moe_ffn``) and llama4-scout on the CPU.

* ``moe_ffn`` against the JAX package's on shared weights
  (``params_from_numpy``), llama4 smoke (4 experts, top-1) and a top-2
  variant, under ``VERIFY_SCHEDULE`` (no drop) and a fast schedule with
  drops: ``y`` within ``MOE_TOL`` (both sides contract in f32, each in its
  own summation order), ``router_load`` and ``dropped_frac`` exactly (they
  are integer counts scaled once).
* Ties: ``_top_k`` returns ``jax.lax.top_k``'s indices on logits that tie
  exactly (the lower index first), and a zero router, where every logit
  ties, routes as the JAX package does.
* Launches: a ``moe_ffn`` call runs the router in the pass's schedule and
  3E expert contractions in the commit GEMM with one chunk
  (``EXPERT_SCHEDULE``), whatever the routing.
* The engine on llama4 smoke: LLM42 streams identical alone and beside
  neighbours on both lanes, and equal between the lanes.
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
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.base import init_params, iter_specs, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams

CFG = configs.get_smoke_config("llama4-scout-17b-a16e")
MOE_TOL = 1e-5
FAST = Schedule(splits=4, kv_splits=4, combine_dtype="bfloat16")


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


def _shared_moe(cfg):
    """Layer 0's ``moe`` weights from numpy, on both sides."""
    jax = pytest.importorskip("jax")

    tree = np_params(cfg, 0)
    tp = params_from_numpy(cfg, tree, "cpu")
    jm = {k: jax.numpy.asarray(v[0]) for k, v in tree["blocks"]["0"]["moe"].items()}
    tm = {k: v[0] for k, v in tp["blocks"]["0"]["moe"].items()}
    return jm, tm


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", ["verify", "fast", "fast_cf0.5"])
def test_moe_ffn_matches_jax(top_k, case):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import Schedule as JSchedule
    from repro.models.layers import moe_ffn as jmoe

    cfg = dataclasses.replace(CFG, top_k=top_k)
    jm, tm = _shared_moe(cfg)
    sched = VERIFY_SCHEDULE if case == "verify" else FAST
    cf = 0.5 if case.endswith("cf0.5") else 1.25
    x = np.random.default_rng(3).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe(jm, cfg, jnp.asarray(x), JSchedule(*sched), capacity_factor=cf)
    ty, taux = layers.moe_ffn(tm, cfg, torch.from_numpy(x), sched, capacity_factor=cf)
    assert ty.shape == x.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_TOL, rtol=0)
    np.testing.assert_array_equal(taux["router_load"].numpy(),
                                  np.asarray(jaux["router_load"]))
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_allclose(float(taux["aux_loss"]), float(jaux["aux_loss"]),
                               rtol=1e-6)
    if case == "fast_cf0.5":
        assert float(taux["dropped_frac"]) > 0  # the overflow bucket was used
    if case == "verify":
        assert float(taux["dropped_frac"]) == 0


def test_top_k_tie_order_is_lax_top_k():
    jax = pytest.importorskip("jax")
    logits = np.array([[1.0, 3.0, 3.0, 0.5],
                       [2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 0.0, -1.0],
                       [5.0, 1.0, 5.0, 5.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jax.numpy.asarray(logits), k)
        tv, ti = layers._top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("top_k", [1, 2])
def test_zero_router_ties_route_as_jax(top_k):
    """Every logit ties at zero: lax.top_k takes experts 0..k-1 for every
    token, and so must the port (a different tie order would move every
    token to other experts)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.layers import moe_ffn as jmoe

    cfg = dataclasses.replace(CFG, top_k=top_k)
    jm, tm = _shared_moe(cfg)
    jm = dict(jm, router=jnp.zeros_like(jm["router"]))
    tm = dict(tm, router=torch.zeros_like(tm["router"]))
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    from repro.core.determinism import VERIFY_SCHEDULE as JV

    jy, jaux = jmoe(jm, cfg, jnp.asarray(x), JV)
    ty, taux = layers.moe_ffn(tm, cfg, torch.from_numpy(x), VERIFY_SCHEDULE)
    want = np.zeros(cfg.num_experts, np.float32)
    want[:top_k] = 1.0 / top_k
    np.testing.assert_array_equal(taux["router_load"].numpy(), want)
    np.testing.assert_array_equal(np.asarray(jaux["router_load"]), want)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_TOL, rtol=0)


@pytest.mark.parametrize("sched", [VERIFY_SCHEDULE, FAST], ids=["verify", "fast"])
def test_moe_ffn_gemm_calls(monkeypatch, sched):
    """The router in the pass's schedule, then three commit-GEMM
    contractions with one chunk per expert, f32 in and out, even for an
    expert no token chose."""
    calls = []
    real = ops.matmul

    def spy(x, w, schedule):
        calls.append((tuple(schedule), x.dtype, w.dtype, tuple(w.shape)))
        return real(x, w, schedule)

    monkeypatch.setattr(ops, "matmul", spy)
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    moe = {k: v[0] for k, v in params["blocks"]["0"]["moe"].items()}
    moe["router"] = torch.zeros_like(moe["router"])  # every token to expert 0
    x = torch.randn((1, 3, CFG.d_model), generator=torch.Generator().manual_seed(1))
    layers.moe_ffn(moe, CFG, x, sched)
    E, d, f = CFG.num_experts, CFG.d_model, CFG.moe_d_ff
    assert calls[0] == (tuple(sched), torch.float32, torch.float32, (d, E))
    expert = tuple(layers.EXPERT_SCHEDULE)
    assert calls[1:] == [(expert, torch.float32, torch.float32, shape)
                         for _ in range(E) for shape in ((d, f), (d, f), (f, d))]


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(2), "cpu")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gathered"])
def test_engine_llm42_streams_identical_beside_neighbours(params, paged):
    policy = ReductionPolicy(thresholds=((2, 16), (4, 8), (8, 4)),
                             combine_dtype="bfloat16")

    def run(neighbours, lane=paged):
        eng = Engine(CFG, params, mode=Mode.LLM42, policy=policy, window=5,
                     group=2, max_batch=4, capacity=64, paged_attention=lane)
        for rid, kw in ((0, dict(seed=3)), (1, dict(seed=4, temperature=0.8, top_k=20))):
            eng.submit(Request(rid=rid, prompt=[rid * 7 + k for k in range(1, 10)],
                               sampling=SamplingParams(max_new_tokens=12,
                                                       is_deterministic=True, **kw)))
        for i in range(neighbours):
            eng.submit(Request(rid=10 + i, prompt=[3 * i + k for k in range(6)],
                               sampling=SamplingParams(max_new_tokens=12)))
        done = {r.rid: r.committed for r in eng.run()}
        return {0: done[0], 1: done[1]}

    alone = run(0)
    assert all(len(s) == 12 for s in alone.values())
    assert run(3) == alone
    if not paged:
        assert run(0, lane=True) == alone
