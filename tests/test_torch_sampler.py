"""The port's seeded sampler against ``jax.random`` and the JAX sampler.

``repro_torch.serving.sampler`` reproduces jax 0.9's threefry noise with
``jax_threefry_partitionable`` on (the installed default).  Held here:

* the ``(V,)`` random bits and the uniforms bitwise, for several seeds,
  positions and V in {512, 128256};
* the Gumbel values within 2 f32 ulps of ``max(|g|, 1)``: each of the two
  ``log`` calls may differ from XLA's by one ulp, and near g = 0 a relative
  ulp count means nothing;
* the sampled tokens equal to ``repro.serving.sampler``'s (temperature,
  top-k with ties, greedy rows mixed in) wherever the noisy scores' top-2
  gap exceeds 1e-5, far above the Gumbel error.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.serving import sampler

CPU = torch.device("cpu")
#: (seed, position, V): large, negative-as-int32 and zero counters included
CASES = [(0, 0, 512), (7, 3, 512), (1000, 15, 128256), (2**31 - 1, 77, 512),
         (-5, 2**31 - 1, 128256)]


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
def jax_random():
    jax = pytest.importorskip("jax")
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax_threefry_partitionable=True; "
                    "the installed jax has it off")
    return jax


def _jax_key(jax, seed, pos):
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(seed))
    return jax.random.fold_in(key, jnp.int32(pos))


def _port_key(seed, pos):
    s = torch.tensor([seed & 0xFFFFFFFF])
    p = torch.tensor([pos & 0xFFFFFFFF])
    zero = torch.zeros_like(s)
    return sampler.fold_in(sampler.fold_in((zero, zero), s), p)


@pytest.mark.parametrize("seed,pos,V", CASES)
def test_bits_and_uniforms_bitwise(jax_random, seed, pos, V):
    import jax.numpy as jnp

    key = _jax_key(jax_random, seed, pos)
    want_bits = np.asarray(jax_random.random.bits(key, (V,), jnp.uint32))
    want_u = np.asarray(jax_random.random.uniform(
        key, (V,), jnp.float32, minval=np.finfo(np.float32).tiny, maxval=1.0))
    bits = sampler.random_bits(_port_key(seed, pos), V)[0]
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want_bits)
    u = sampler.uniform_from_bits(bits).numpy()
    np.testing.assert_array_equal(u.view(np.uint32), want_u.view(np.uint32))


@pytest.mark.parametrize("seed,pos,V", CASES[:3])
def test_gumbel_within_two_ulps(jax_random, seed, pos, V):
    import jax.numpy as jnp
    from repro.serving import sampler as js

    want = np.asarray(js._gumbel_for(jnp.int32(seed), jnp.int32(pos), V))
    got = sampler._gumbel_for([seed], [pos], V, CPU)[0].numpy()
    ulps = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got.astype(np.float64) - want) <= 2 * ulps)


def test_seeded_tokens_match_jax(jax_random):
    import jax.numpy as jnp
    from repro.serving import sampler as js

    rng = np.random.default_rng(0)
    B, W, V = 6, 3, 512
    logits = rng.standard_normal((B, W, V)).astype(np.float32) * 3
    logits[2, :, :6] = 20.0  # top-k ties: all six equal values survive k=3
    seeds = [11, 12, 13, 14, 15, -16]
    base = [0, 4, 9, 1, 2**20, 3]
    temps = [0.0, 0.8, 0.8, 1.3, 0.5, 0.8]
    top_ks = [0, 0, 3, 50, 1, 0]
    want = np.asarray(js.sample_window(
        jnp.asarray(logits), jnp.asarray(seeds, jnp.int32), jnp.asarray(base, jnp.int32),
        jnp.asarray(temps, jnp.float32), jnp.asarray(top_ks, jnp.int32)))
    got = sampler.sample_window(torch.from_numpy(logits), seeds, base, temps, top_ks)
    # the gap between the two best noisy scores of each (row, position)
    clear = np.ones((B, W), bool)
    for b in range(B):
        if temps[b] <= 0:
            continue
        for j in range(W):
            g = np.asarray(js._gumbel_for(jnp.int32(seeds[b]), jnp.int32(base[b] + j), V))
            x = logits[b, j].astype(np.float64)
            if top_ks[b] > 0:
                x = np.where(x >= np.sort(x)[::-1][top_ks[b] - 1], x, -np.inf)
            top2 = np.sort(x / max(temps[b], 1e-6) + g)[-2:]
            clear[b, j] = top2[1] - top2[0] > 1e-5
    assert clear.sum() >= B * W - 1
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    one = sampler.sample_batch(torch.from_numpy(logits[:, 1]), seeds,
                               [p + 1 for p in base], temps, top_ks)
    np.testing.assert_array_equal(one.numpy(), got[:, 1].numpy())


def test_top_k_keeps_ties_and_noise_follows_the_counter():
    logits = torch.full((1, 64), -5.0)
    logits[0, [3, 17, 40]] = 2.0  # a three-way tie at the top
    seen = {int(sampler.sample_token(logits[0], 5, pos, 1.0, top_k=1))
            for pos in range(40)}
    assert seen == {3, 17, 40}  # k = 1 keeps every value equal to the 1st
    a = sampler.sample_batch(logits.expand(4, 64), [5] * 4, [0, 1, 2, 3], [1.0] * 4, [1] * 4)
    b = torch.stack([sampler.sample_token(logits[0], 5, p, 1.0, 1) for p in range(4)])
    assert torch.equal(a, b)  # a row's sample does not depend on the batch
