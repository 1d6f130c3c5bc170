"""The port's model against the JAX package on shared smoke weights.

Weights come from the JAX initializer and reach the port through numpy
(``models.convert.params_from_numpy``); inputs are made with a numpy seed.
Both packages run ``forward`` over a paged pool at ``llama3-smoke`` size
(2 layers, d_model 256, f32).  Tolerance 2e-4 on logits of magnitude ~5:
both sides compute the same reduction trees in f32, each summing in its own
order (XLA on CPU vs torch on CPU).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import llama3_8b
from repro_torch.core.determinism import (
    REORDER_ONLY_POLICY, Schedule, VERIFY_SCHEDULE,
)
from repro_torch.models import layers
from repro_torch.models.base import init_params, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import PagedView
from repro_torch.models.transformer import forward
from repro_torch.serving import kv_cache
from repro_torch.serving.sampler import sample_batch, top2_margin

CFG = llama3_8b.smoke_config()
CAP, BS = 128, 16
LOGIT_TOL = 2e-4


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
def shared():
    """(JAX params, port params) from one JAX init."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config
    from repro.models import init_params as jax_init

    jp = jax_init(get_smoke_config("llama3-8b"), jax.random.key(0))
    tp = params_from_numpy(CFG, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def _pools():
    from repro.configs import get_smoke_config
    from repro.serving import kv_cache as jkv

    jpool = jkv.CachePool(get_smoke_config("llama3-8b"), 4, CAP, block_size=BS)
    tpool = kv_cache.CachePool(CFG, 4, CAP, block_size=BS, device=torch.device("cpu"))
    return jpool, tpool


def _both(shared, jpool_data, tpool_data, tokens, start, tables, jsched, tsched):
    import jax
    import jax.numpy as jnp
    from repro.models.layers import PagedView as JPV
    from repro.models.transformer import forward as jforward

    jp, tp = shared
    nb = 4 * (CAP // BS)  # the pools' null block; scratch follows it
    jcfg = _jcfg()
    # jitted, as the reference's engine runs it (op by op every primitive
    # compiles on its own)
    jl, jc, _ = jax.jit(lambda p, x, c, st, tb: jforward(
        p, jcfg, x, cache=c, start_pos=st, schedule=jsched, tables=tb,
        paged=JPV(BS, nb, nb + 1)))(jp, jnp.asarray(tokens), jpool_data, jnp.asarray(start),
                                    jnp.asarray(tables))
    tl, _, _ = forward(tp, CFG, torch.from_numpy(tokens), cache=tpool_data,
                       start_pos=torch.from_numpy(start), schedule=tsched,
                       tables=torch.from_numpy(tables), paged=PagedView(BS, nb, nb + 1))
    return np.asarray(jl), tl.numpy(), jc


def _jcfg():
    from repro.configs import get_smoke_config

    return get_smoke_config("llama3-8b")


def _tables():
    tables = np.full((2, CAP // BS), -1, np.int32)
    tables[0, :2] = [0, 1]
    tables[1, :2] = [5, 2]
    return tables


def test_forward_matches_jax_under_verify_schedule(shared):
    """A 10-token multi-row pass (the verify/prefill shape) under
    VERIFY_SCHEDULE: the gathered-view attention and the 4-chunk GEMM tree."""
    from repro.core.determinism import VERIFY_SCHEDULE as JV

    rng = np.random.default_rng(0)
    jpool, tpool = _pools()
    tokens = rng.integers(0, CFG.vocab_size, (2, 10)).astype(np.int32)
    start = np.array([0, 4], np.int32)
    jl, tl, _ = _both(shared, jpool.data, tpool.data, tokens, start, _tables(),
                      JV, VERIFY_SCHEDULE)
    assert tl.shape == (2, 10, CFG.vocab_size)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("batch", [2, 5])
def test_decode_matches_jax_under_fast_schedule(shared, batch):
    """A prefill under VERIFY, then one decode token (W == 1) under a fast
    schedule whose kv_splits divides the table reach (8 blocks; splits 8 at
    B=2, 4 at B=5), f32 combine.  The port's W == 1 route is the paged
    kernel pair; the JAX model on the CPU takes its gathered route: same
    function, so they agree to f32 reordering."""
    from repro.core.determinism import REORDER_ONLY_POLICY as JR, VERIFY_SCHEDULE as JV

    rng = np.random.default_rng(1)
    jpool, tpool = _pools()
    tables = np.full((batch, CAP // BS), -1, np.int32)
    for b in range(batch):
        tables[b, :2] = [2 * b, 2 * b + 1]
    start = np.arange(batch, dtype=np.int32)
    tokens = rng.integers(0, CFG.vocab_size, (batch, 8)).astype(np.int32)
    _, _, jc = _both(shared, jpool.data, tpool.data, tokens, start, tables, JV,
                     VERIFY_SCHEDULE)
    one = rng.integers(0, CFG.vocab_size, (batch, 1)).astype(np.int32)
    tsched = REORDER_ONLY_POLICY.schedule_for(batch)
    assert (CAP // BS) % tsched.kv_splits == 0 and tsched.kv_splits > 1
    jl, tl, _ = _both(shared, jc, tpool.data, one, start + 8, tables,
                      JR.schedule_for(batch), tsched)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0)


def test_rms_norm_and_rope_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import Schedule as JS
    from repro.models import layers as jl

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    for splits in (1, 4):
        want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5,
                                      JS(splits=splits, combine_dtype="bfloat16")))
        got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5,
                              Schedule(splits=splits, combine_dtype="bfloat16")).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    want = np.asarray(jl.rope(jnp.asarray(q), jnp.asarray(pos), 500000.0))
    got = layers.rope(torch.from_numpy(q), torch.from_numpy(pos), 500000.0).numpy()
    # angles reach 4000 rad; one f32 ulp of the angle (2.4e-4 there) times
    # |x| ~ 3 bounds the two libraries' cos/sin disagreement
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("width", [256, 4096, 77])
def test_one_pass_norm_sum_is_row_invariant(width):
    """The commit schedule's feature sum: each row's bits are the same at
    every row count, and the fixed tree is as accurate as an f32 sum."""
    from repro_torch.core.determinism import segment_reduce_sum

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((40, width))
                         .astype(np.float32)) ** 2
    full = segment_reduce_sum(x, -1, VERIFY_SCHEDULE)
    for m in (1, 3, 17, 40):
        assert torch.equal(segment_reduce_sum(x[:m], -1, VERIFY_SCHEDULE), full[:m])
    exact = x.double().sum(-1)
    assert float(((full.double() - exact) / exact).abs().max()) < 4 * 2.0 ** -24 * np.log2(width)


def test_param_specs_match_jax():
    """Same keys, shapes and parameter count as the JAX tree, full config."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models.base import param_specs as jax_specs

    full = llama3_8b.config()
    jspec = jax_specs(get_config("llama3-8b"))
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path): tuple(s.shape)
        for path, s in jax.tree_util.tree_leaves_with_path(jspec)
    }
    from repro_torch.models.base import iter_specs

    mine = {"/".join(p): s.shape for p, s in iter_specs(param_specs(full))}
    assert mine == flat
    assert full.param_count() == get_config("llama3-8b").param_count()


def test_init_params_shapes_and_scale():
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    wq = params["blocks"]["0"]["attn"]["wq"]
    assert wq.shape == (2, 256, 256) and wq.dtype == torch.float32
    assert abs(float(wq.std()) - 256 ** -0.5) < 0.01
    assert torch.equal(params["final_norm"], torch.ones(256))
    again = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["unembed"], params["unembed"])


def test_params_from_numpy_checks_shapes():
    bad = {"embed": np.zeros((3, 3), np.float32)}
    with pytest.raises((ValueError, KeyError)):
        params_from_numpy(CFG, bad, "cpu")


def test_greedy_sampler_and_margin_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.serving import sampler as js

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[1, [3, 9]] = 10.0  # a tie: first max wins, margin exactly 0
    want = np.asarray(js.sample_batch(jnp.asarray(logits), jnp.zeros(4, jnp.int32),
                                      jnp.zeros(4, jnp.int32), jnp.zeros(4)))
    got = sample_batch(torch.from_numpy(logits), [0] * 4, [0] * 4, [0.0] * 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1]) == 3
    np.testing.assert_allclose(top2_margin(torch.from_numpy(logits)).numpy(),
                               np.asarray(js.top2_margin(jnp.asarray(logits))),
                               atol=1e-6)
    # a seeded row beside greedy ones: the same Gumbel-argmax as JAX's
    temps = [0.0, 0.7, 0.0, 0.0]
    want = np.asarray(js.sample_batch(jnp.asarray(logits), jnp.arange(4, dtype=jnp.int32),
                                      jnp.zeros(4, jnp.int32), jnp.asarray(temps)))
    got = sample_batch(torch.from_numpy(logits), [0, 1, 2, 3], [0] * 4, temps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_and_commit_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.verifier import _match_and_commit as jmc

    from repro_torch.core.verifier import _match_and_commit

    rng = np.random.default_rng(4)
    W = 6
    v = rng.integers(0, 3, (16, W)).astype(np.int32)
    cand = np.where(rng.random((16, W - 1)) < 0.8, v[:, : W - 1], 7).astype(np.int32)
    cand_len = rng.integers(0, W, 16).astype(np.int32)
    jn, jt = jmc(jnp.asarray(v), jnp.asarray(cand), jnp.asarray(cand_len), W)
    tn, tt = _match_and_commit(torch.from_numpy(v), torch.from_numpy(cand),
                               torch.from_numpy(cand_len), W)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_resolve_device_requires_a_card_unless_asked():
    from repro_torch import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            init_params(CFG, torch.Generator().manual_seed(0))
