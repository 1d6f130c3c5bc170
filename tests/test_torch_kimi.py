"""kimi-k2 on the CPU: ``first_k_dense`` head layers and head_dim 112.

* ``params_from_numpy`` maps the JAX tree's ``head_layers/{i}`` (unstacked
  there and here) and the stacked block layers; the kimi-smoke ``forward``
  with its dense head layer and MoE block layer, on the paged lane and on
  gathered views, against the JAX package's, prefill then decode, within
  ``FWD_TOL`` (both sides sum f32 in their own order).
* The three attention kernels' plain versions at D = 112 (G = 8, kimi's
  published group) against ``repro/kernels/ref.py``, and the dense decode
  kernel's also against its Pallas kernel run in interpret mode, as
  ``tests/test_kernels.py`` runs it, within ``ATTN_TOL`` (f32, the same
  arithmetic in another order; a bf16 combine rounds the same values to
  bf16, so ``BF16_TOL``).  The Pallas paged kernels do not trace on the
  installed jax (``pl.load`` is gone from ``jax.experimental.pallas``), so
  the paged versions are held to ``ref`` alone, as
  ``tests/test_torch_kernels.py`` holds them.
* A small forward at ``head_dim=112`` against the JAX package's.
* The engine serves kimi-smoke on both lanes: LLM42 and BATCH_INVARIANT
  streams identical alone and beside neighbours, the lanes equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import VERIFY_SCHEDULE, Mode, ReductionPolicy
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import transformer
from repro_torch.models.base import iter_specs, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import PagedView
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams

CFG = configs.get_smoke_config("kimi-k2-1t-a32b")
FWD_TOL = 2e-4
ATTN_TOL = 1e-5
BF16_TOL = 2e-2
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
    spec's scale where it has one), norms ones."""
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


def _dense_cache(cfg, B, C):
    def make(t):
        if isinstance(t, dict):
            return {k: make(v) for k, v in t.items()}
        shape, dtype = t
        return (torch.full(shape, -1, dtype=dtype) if dtype == torch.int32
                else torch.zeros(shape, dtype=dtype))

    return make(transformer.cache_spec(cfg, B, C))


def test_param_tree_matches_jax():
    """The port's spec tree is the JAX one, paths and shapes: ``head_layers/0``
    unstacked (attention + dense FFN of d_ff), ``blocks/0`` the MoE layers
    stacked; ``params_from_numpy`` maps such a tree leaf for leaf."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models.base import param_specs as jax_specs

    jcfg = jconfigs.get_smoke_config("kimi-k2-1t-a32b")
    flat = {"/".join(p): s.shape for p, s in iter_specs(param_specs(CFG))}
    jflat = {"/".join(k.key for k in path): tuple(spec.shape)
             for path, spec in jax.tree_util.tree_flatten_with_path(
                 jax_specs(jcfg), is_leaf=lambda x: hasattr(x, "shape"))[0]}
    assert flat == jflat
    assert "head_layers/0/ffn/wi_gate" in flat and "blocks/0/moe/router" in flat
    assert flat["head_layers/0/ffn/wi_gate"] == (CFG.d_model, CFG.d_ff)
    assert CFG.param_count() == jcfg.param_count()
    tree = np_params(CFG, 1)
    tp = params_from_numpy(CFG, tree, "cpu")
    for path, _ in iter_specs(param_specs(CFG)):
        node, nnode = tp, tree
        for k in path:
            node, nnode = node[k], nnode[k]
        assert np.array_equal(node.numpy(), nnode), path


_STEPS = [(0, 11)] + [(11 + i, 12 + i) for i in range(2)]
_JAX_LOGITS = {}


def _jax_logits(cfg, tree, toks, C):
    """The JAX package's logits of every pass of ``_STEPS`` (computed once
    per (head_dim, seed): both lanes compare against them)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.determinism import VERIFY_SCHEDULE as JV
    from repro.models import transformer as jt

    key = (cfg.head_dim, toks.tobytes())
    if key not in _JAX_LOGITS:
        jcfg = dataclasses.replace(jconfigs.get_smoke_config("kimi-k2-1t-a32b"),
                                   head_dim=cfg.head_dim)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jc = jt.init_cache(jcfg, toks.shape[0], C)
        # jitted, as the reference's engine runs it: one compilation a pass
        # shape, where op by op every primitive compiles on its own
        fwd = jax.jit(lambda p, x, c, start: jt.forward(p, jcfg, x, cache=c,
                                                        start_pos=start, schedule=JV))
        want = []
        for s, e in _STEPS:
            start = np.full(toks.shape[0], s, np.int32)
            jl, jc, _ = fwd(jp, jnp.asarray(toks[:, s:e]), jc, jnp.asarray(start))
            want.append(np.asarray(jl))
        _JAX_LOGITS[key] = want
    return _JAX_LOGITS[key]


def _forward_both(cfg, paged, seed=0):
    """Prefill of 11 tokens then 2 decode steps, B = 2, on both packages;
    returns the port's and the JAX logits of every pass."""
    tree = np_params(cfg, seed)
    tp = params_from_numpy(cfg, tree, "cpu")
    B, C, bs = 2, 32, 8
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab_size, (B, 13)).astype(np.int32)
    want = _jax_logits(cfg, tree, toks, C)
    if paged:
        nblk = C // bs
        pview = PagedView(bs, B * nblk, B * nblk + 1)
        tables = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)

        def pool_leaf(shape, dtype):  # (layers, NB + 2, bs, ...)
            full = (shape[0], B * nblk + 2, bs) + shape[3:]
            return (torch.full(full, -1, dtype=dtype) if dtype == torch.int32
                    else torch.zeros(full, dtype=dtype))

        spec = transformer.cache_spec(cfg, B, C)
        cache = {top: {k: {n: pool_leaf(*leaf) for n, leaf in sub.items()}
                       for k, sub in tree_.items()} for top, tree_ in spec.items()}
        kw = dict(tables=tables, paged=pview)
    else:
        cache = _dense_cache(cfg, B, C)
        kw = {}
    got = []
    for s, e in _STEPS:
        start = torch.full((B,), s, dtype=torch.int32)
        tl, cache, _ = transformer.forward(tp, cfg, torch.from_numpy(toks[:, s:e]),
                                           cache=cache, start_pos=start,
                                           schedule=VERIFY_SCHEDULE, **kw)
        got.append(tl.numpy())
    return got, want


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gathered"])
def test_forward_with_head_layer_matches_jax(paged):
    got, want = _forward_both(CFG, paged)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gathered"])
def test_forward_at_head_dim_112_matches_jax(paged):
    """kimi's published head width on the smoke widths: the W == 1 passes
    run the plain paged kernel (paged) or the dense decode kernel
    (gathered) at D = 112."""
    cfg = dataclasses.replace(CFG, head_dim=112)
    got, want = _forward_both(cfg, paged, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FWD_TOL, rtol=0)


def _paged_problem(seed, D=112, H=16, KV=2, B=3, bs=8, nblk=6, dtype=np.float32):
    rng = np.random.default_rng(seed)
    NB = B * nblk + 2
    k = rng.standard_normal((NB, bs, KV, D)).astype(dtype)
    v = rng.standard_normal((NB, bs, KV, D)).astype(dtype)
    pos = np.full((NB, bs), -1, np.int32)
    tables = np.full((B, nblk), -1, np.int32)
    q_pos = np.zeros(B, np.int32)
    for b in range(B):
        length = int(rng.integers(1, nblk * bs))
        n = -(-length // bs)
        blocks = rng.permutation(np.arange(b * nblk, (b + 1) * nblk))[:n]
        tables[b, :n] = blocks
        for j, bid in enumerate(blocks):
            pos[bid] = np.arange(j * bs, (j + 1) * bs)
        q_pos[b] = length - 1
    q = rng.standard_normal((B, H, D)).astype(dtype)
    return q, k, v, pos, tables, q_pos, NB - 2


@pytest.mark.parametrize("kind", ["commit", "fast f32", "fast bf16"])
def test_paged_plain_versions_at_d112_match_jax(kind):
    """G = 8 (16 heads over 2), D = 112: the port's plain paged versions
    against the JAX package's ``ref``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    problem = _paged_problem(1 + len(kind))
    q, k, v, pos, tab, qp, nb = problem
    jargs = tuple(jnp.asarray(a) for a in problem[:6])
    targs = tuple(torch.from_numpy(a) for a in problem[:6])
    if kind == "commit":
        got = pa.paged_attention(*targs, null_bid=nb).numpy()
        refs = (jref.paged_attention(*jargs, null_bid=nb),)
        tol = ATTN_TOL
    else:
        cd = "float32" if kind.endswith("f32") else "bfloat16"
        got = pa.paged_attention_fast(*targs, kv_splits=3, combine_dtype=cd,
                                      null_bid=nb).numpy()
        refs = (jref.paged_attention(*jargs, null_bid=nb, kv_splits=3,
                                     combine_dtype=cd),)
        tol = ATTN_TOL if cd == "float32" else BF16_TOL
    assert got.shape == (3, 16, 112)
    for want in refs:
        np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("splits,cd", [(1, "float32"), (4, "float32"), (4, "bfloat16")])
def test_decode_plain_version_at_d112_matches_jax(splits, cd):
    """The dense decode kernel's plain version at G = 8, D = 112 against
    the JAX ``ref`` and the Pallas kernel (interpret)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import decode_attention as jdec
    from repro.kernels import ref as jref

    rng = np.random.default_rng(splits)
    B, S, H, KV, D = 3, 32, 16, 2, 112
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    lengths = np.array([5, 17, 32], np.int32)
    got = dec.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lengths)),
                               kv_splits=splits, combine_dtype=cd).numpy()
    j = tuple(jnp.asarray(a) for a in (q, k, v, lengths))
    tol = ATTN_TOL if cd == "float32" else BF16_TOL
    for want in (jref.decode_attention(*j, splits, cd),
                 jdec.decode_attention(*j, kv_splits=splits, combine_dtype=cd,
                                       interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def test_plain_versions_at_d112_rows_independent_of_batch():
    """Row b alone gives the bits it gives in the batch (commit paged,
    decode at one split), at D = 112."""
    q, k, v, pos, tab, qp, nb = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                 for a in _paged_problem(9))
    full = pa.paged_attention(q, k, v, pos, tab, qp, null_bid=nb)
    assert torch.equal(pa.paged_attention(q[1:2], k, v, pos, tab[1:2], qp[1:2],
                                          null_bid=nb), full[1:2])


_ENGINE = {}


def _engine_params():
    if "p" not in _ENGINE:
        _ENGINE["p"] = params_from_numpy(CFG, np_params(CFG, 5), "cpu")
    return _ENGINE["p"]


def _serve(mode, paged, neighbours):
    eng = Engine(CFG, _engine_params(), mode=mode, policy=DRIFTY, window=5, group=2,
                 max_batch=8, capacity=128, paged_attention=paged)
    eng.submit(Request(rid=0, prompt=list(range(1, 33)), sampling=SamplingParams(
        max_new_tokens=12, is_deterministic=True, seed=7)))
    eng.submit(Request(rid=1, prompt=list(range(5, 37)), sampling=SamplingParams(
        max_new_tokens=12, is_deterministic=True, seed=8, temperature=0.8, top_k=50)))
    for i in range(neighbours):
        eng.submit(Request(rid=10 + i, prompt=[3 * i + k for k in range(20)],
                           sampling=SamplingParams(max_new_tokens=12)))
    done = {r.rid: r for r in eng.run()}
    return {rid: done[rid].committed for rid in (0, 1)}, eng


@pytest.mark.parametrize("mode", [Mode.LLM42, Mode.BATCH_INVARIANT], ids=lambda m: m.value)
def test_engine_serves_kimi_smoke_on_both_lanes(mode):
    runs = {(paged, n): _serve(mode, paged, n)[0] for paged in (True, False)
            for n in (0, 3)}
    first = runs[True, 0]
    assert all(len(s) == 12 for s in first.values())
    for key, streams in runs.items():
        assert streams == first, key
