"""The port's training path on the CPU (smoke configs, plain kernels).

* The port's versions of ``tests/test_training.py``: the AdamW schedule,
  clipping and descent, microbatch and remat equivalence, the loss mask,
  the synthetic stream, the workload helpers and a checkpoint round trip.
* Against the JAX package on shared numpy-seeded weights (``np_params``,
  through ``params_from_numpy``) at the f32 smoke ``tinyllama-1.1b``:
  ``forward_train``'s logits within ``FWD_TOL``; ``lm_loss`` and every
  gradient leaf against ``jax.value_and_grad`` within ``GRAD_REL`` of the
  leaf's max |g|; one ``train_step``'s parameters, and the training
  program's first step's (within ``STEP_TOL``: at
  step 1 AdamW moves each weight by about lr * sign(g), so a gradient near
  zero whose sign differs across frameworks moves it by up to 2 lr) and
  metrics; ``forward_train`` with its ``aux_loss`` at the smoke
  ``llama4-scout-17b-a16e``, with ``enc_embeds`` at the smoke
  ``seamless-m4t-medium``, from the zero state at the smoke ``rwkv6-3b``
  and at the hybrid smoke ``jamba-1.5-large-398b``, whose ``lm_loss`` and
  every gradient leaf are held against JAX's too; ``SyntheticTextStream``
  batches bitwise; an archive written by each package restored by the
  other, bitwise; the driver training the hybrid family.
* The GEMMs' backward (``kernels.ops.GemmGrad``) against autograd through
  ``x.float() @ w.float()``, both products routed to the commit GEMM with
  one chunk; ``attention_train``'s q-chunked branch against the unchunked
  one.
* Cross-attention's q scale: a bf16 W == 1 cross pass at head_dim 96
  (where hd**-0.5 is inexact in bf16) matches the JAX ``cross_attention``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import VERIFY_SCHEDULE, Schedule
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.base import iter_specs, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import forward_train
from repro_torch.training import checkpoint
from repro_torch.training.data import (
    ARXIV, SHAREGPT, SyntheticTextStream, poisson_arrivals, sample_workload,
)
from repro_torch.training.optimizer import (
    AdamWConfig, apply_updates, init_opt_state, lr_at, tree_leaves, tree_map,
)
from repro_torch.training.train import lm_loss, make_train_step, train_params

ARCH = "tinyllama-1.1b"
CFG = configs.get_smoke_config(ARCH)
#: f32 forwards of the two frameworks sum in their own orders
FWD_TOL = 2e-4
#: each gradient leaf within this fraction of its max |g|
GRAD_REL = 1e-4
#: one AdamW step at lr(1) = 1e-5: a weight moves by about lr * sign(g)
STEP_TOL = 2.5e-5
OPT = AdamWConfig(lr=1e-3, total_steps=100)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_params(cfg, seed):
    """Numpy weights for ``cfg``: normal * each matrix's fan-in^-0.5 (the
    spec's scale where it has one), norms ones (as tests/test_torch_kimi.py)."""
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


def np_batch(cfg, seq=32, batch=4, seed=1):
    b = next(iter(SyntheticTextStream(cfg.vocab_size, seq, batch, seed=seed)))
    return {"tokens": b.tokens, "targets": b.targets, "loss_mask": b.loss_mask}


def torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@pytest.fixture(scope="module")
def setup():
    """(port params, numpy tree, numpy batch) at the smoke tinyllama."""
    tree = np_params(CFG, 3)
    return train_params(CFG, params_from_numpy(CFG, tree, "cpu")), tree, np_batch(CFG)


def _flat_np(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_np(tree[k], prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_tree_close(got, want, rel=None, atol=None):
    g, w = _flat_np(tree_map(lambda t: t.detach().float().numpy(), got)), _flat_np(want)
    assert g.keys() == w.keys()
    for k in g:
        tol = atol if atol is not None else rel * max(float(np.abs(w[k]).max()), 1e-30)
        np.testing.assert_allclose(g[k], np.asarray(w[k], np.float32), atol=tol, rtol=0,
                                   err_msg="/".join(k))


# ---------------------------------------------------------------------------
# tests/test_training.py on the port
# ---------------------------------------------------------------------------


class TestOptimizer:
    def test_lr_schedule(self):
        cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
        step = lambda n: torch.tensor(n, dtype=torch.int32)  # noqa: E731
        assert float(lr_at(cfg, step(5))) == pytest.approx(5e-4)
        assert float(lr_at(cfg, step(10))) == pytest.approx(1e-3, rel=1e-2)
        assert float(lr_at(cfg, step(100))) == pytest.approx(
            cfg.lr * cfg.min_lr_frac, rel=1e-2)

    def test_grad_clip(self):
        p = {"w": torch.ones(4)}
        g = {"w": torch.full((4,), 100.0)}
        cfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0)
        _, _, m = apply_updates(cfg, p, g, init_opt_state(p))
        assert float(m["grad_norm"]) == pytest.approx(200.0)

    def test_descends_quadratic(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                          total_steps=1000, clip_norm=1e9)
        p = {"w": torch.tensor(5.0)}
        s = init_opt_state(p)
        for _ in range(50):
            p, s, _ = apply_updates(cfg, p, {"w": 2 * p["w"]}, s)
        assert abs(float(p["w"])) < 1.0


class TestTrainStep:
    @pytest.mark.parametrize("variant", ["microbatches", "remat"])
    def test_equivalent_step(self, setup, variant):
        """grad accumulation over 2 microbatches == one batch, and remat ==
        no remat (f32).  Remat recomputes the same ops, so it is bitwise."""
        params, _, nb = setup
        batch = torch_batch(nb)
        kw = ({"num_microbatches": 2} if variant == "microbatches" else {"remat": False})
        pa, _, ma = make_train_step(CFG, OPT)(params, init_opt_state(params), batch)
        pb, _, mb = make_train_step(CFG, OPT, **kw)(params, init_opt_state(params), batch)
        for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
            if variant == "remat":
                assert torch.equal(a, b)
            else:
                assert torch.allclose(a, b, atol=1e-5)
        assert float(ma["grad_norm"]) == pytest.approx(float(mb["grad_norm"]), rel=1e-5)

    def test_loss_mask_respected(self, setup):
        params, _, nb = setup
        batch = torch_batch(nb)
        mask = batch["loss_mask"].clone()
        mask[:, 16:] = 0.0
        poked = batch["targets"].clone()
        poked[:, 20] = 3
        l1, _ = lm_loss(params, CFG, batch["tokens"], batch["targets"], mask)
        l2, _ = lm_loss(params, CFG, batch["tokens"], poked, mask)
        assert float(l1) == float(l2)


class TestData:
    def test_stream_deterministic(self):
        a = next(iter(SyntheticTextStream(256, 16, 2, seed=5)))
        b = next(iter(SyntheticTextStream(256, 16, 2, seed=5)))
        assert (a.tokens == b.tokens).all()

    def test_workload_stats_roughly_match_table3(self):
        ins = np.array([i for i, _ in sample_workload(SHAREGPT, 4000, seed=0)])
        assert 80 < np.median(ins) < 260  # Table 3: median 136, mean 304
        ins_a = np.array([i for i, _ in sample_workload(ARXIV, 2000, seed=0)])
        assert np.median(ins_a) > 3000  # ArXiv is long-context

    def test_poisson_arrivals_monotone(self):
        t = poisson_arrivals(100, qps=10, seed=0)
        assert all(b > a for a, b in zip(t, t[1:]))
        assert 5 < t[-1] < 25  # ~10s at 10 qps


class TestCheckpoint:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_roundtrip(self, setup, tmp_path, dtype):
        params = tree_map(lambda t: t.to(dtype), setup[0])
        opt_state = init_opt_state(params)
        opt_state = opt_state._replace(
            step=torch.tensor(7, dtype=torch.int32),
            mu=tree_map(lambda t: torch.randn(t.shape, generator=torch.Generator()
                                              .manual_seed(1)), params))
        path = str(tmp_path / "c.npz")
        checkpoint.save(path, params, opt_state, step=7)
        assert not os.path.exists(path + ".tmp")
        p2, o2, step = checkpoint.restore(path, params, init_opt_state(params))
        assert step == 7
        for a, b in zip(tree_leaves(params), tree_leaves(p2)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip([opt_state.step] + tree_leaves(opt_state.mu) + tree_leaves(opt_state.nu),
                        [o2.step] + tree_leaves(o2.mu) + tree_leaves(o2.nu)):
            assert torch.equal(a, b)


def test_train_cli_smoke(tmp_path, monkeypatch, capsys):
    """The driver at smoke size on the CPU, then resumed from its archive."""
    from repro_torch.launch import train_launch

    ck = str(tmp_path / "c.npz")
    base = ["train_launch", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--log-every", "1"]

    def run(*extra):
        monkeypatch.setattr(sys, "argv", base + list(extra))
        train_launch.main()
        return capsys.readouterr().out

    out = run("--steps", "2", "--ckpt", ck)
    assert "step     2  loss" in out and "tok/s" in out and os.path.exists(ck)
    out = run("--steps", "3", "--resume", ck)
    assert "at step 2" in out and "step     3  loss" in out


@pytest.mark.parametrize("argv,lr", [
    (["--smoke"], 1e-3), ([], 3e-4), (["--smoke", "--lr", "5e-4"], 5e-4),
    (["--lr", "1e-3"], 1e-3)], ids=["smoke", "full", "smoke-given", "full-given"])
def test_train_cli_lr_defaults(argv, lr):
    """``--lr`` defaults to the JAX package's 1e-3 under ``--smoke``
    and to 3e-4 for the full config; a given rate is kept."""
    from repro_torch.launch import train_launch

    assert train_launch.parse_args(argv).lr == lr


def test_train_cli_hybrid(monkeypatch, capsys):
    """The driver trains the hybrid family (``jamba-smoke``) two steps."""
    from repro_torch.launch import train_launch

    monkeypatch.setattr(sys, "argv", [
        "train_launch", "--arch", "jamba-1.5-large-398b", "--smoke", "--device", "cpu",
        "--batch", "2", "--seq", "16", "--steps", "2", "--log-every", "1"])
    train_launch.main()
    out = capsys.readouterr().out
    assert "jamba-smoke" in out and "step     2  loss" in out and "nan" not in out


# ---------------------------------------------------------------------------
# the GEMMs' backward and attention_train
# ---------------------------------------------------------------------------


def _record_products(monkeypatch):
    """Calls of the two product entries ``ops`` routes to, as (entry, chunks
    or None, a, b), each then run as it would be."""
    calls = []
    commit, grad = ops.gemm_batch_invariant, ops.gemm_grad
    monkeypatch.setattr(ops, "gemm_batch_invariant",
                        lambda a, b, chunks=1: calls.append(("commit", chunks, a, b))
                        or commit(a, b, chunks=chunks))
    monkeypatch.setattr(ops, "gemm_grad",
                        lambda a, b: calls.append(("grad", None, a, b)) or grad(a, b))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [24, 13])
@pytest.mark.parametrize("schedule", [VERIFY_SCHEDULE,
                                      Schedule(splits=4, kv_splits=4,
                                               combine_dtype="bfloat16")])
def test_gemm_backward_matches_autograd(monkeypatch, dtype, M, schedule):
    """dX = dY W^T and dW = X^T dY: one f32 pass each, rounded to the
    operands' dtype, as autograd through ``x.float() @ w.float()`` gives;
    bf16 products in ``gemm_grad`` on the transposed views (no copy: an M
    that is no multiple of 8 needs no padding either), f32 ones in the
    commit GEMM with one chunk; never the split-K GEMM."""
    calls = _record_products(monkeypatch)
    g = torch.Generator().manual_seed(M)
    K, N = 40, 48
    x = torch.randn(M, K, generator=g).to(dtype).requires_grad_(True)
    w = (torch.randn(K, N, generator=g) * K ** -0.5).to(dtype).requires_grad_(True)
    dy = torch.randn(M, N, generator=g).to(dtype)
    ops.matmul(x, w, schedule).backward(dy)
    if dtype == torch.bfloat16:
        backward = calls[-2:]
        assert [c[:2] for c in backward] == [("grad", None), ("grad", None)]
        (_, _, dy_a, wt), (_, _, xt, dy_b) = backward
        assert wt.data_ptr() == w.data_ptr() and wt.stride() == (1, N)  # w.t(), in place
        assert xt.data_ptr() == x.data_ptr() and xt.stride() == (1, K)  # x.t(), in place
        assert dy_a.shape == dy_b.shape == (M, N)
    else:
        backward = [c for c in calls if c[1] == 1][-2:]
        assert [c[:2] for c in backward] == [("commit", 1), ("commit", 1)]

    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    (xr.float() @ wr.float()).to(dtype).backward(dy)
    tol = 1e-6 if dtype == torch.float32 else 0.0
    for got, want in ((x.grad, xr.grad), (w.grad, wr.grad)):
        assert got.dtype == dtype
        diff = (got.float() - want.float()).abs().max().item()
        ulp = want.float().abs().max().item() * (2 ** -7 if dtype == torch.bfloat16 else 0)
        assert diff <= max(tol, ulp), diff


def test_gemm_backward_hands_views_without_copies(monkeypatch):
    """``GemmGrad``'s backward gives ``gemm_grad`` dY as autograd hands it
    over and the saved operands' transposes as views of their storage:
    no ``.contiguous()`` copy, no padded copy, for a token count (13) and a
    contraction (21) that are no multiples of 8."""
    calls = _record_products(monkeypatch)
    g = torch.Generator().manual_seed(3)
    M, K, N = 13, 21, 24
    x = torch.randn(M, K, generator=g).bfloat16().requires_grad_(True)
    w = torch.randn(K, N, generator=g).bfloat16().requires_grad_(True)
    dy = torch.randn(M, N, generator=g).bfloat16()
    ops.matmul(x, w, VERIFY_SCHEDULE).backward(dy)
    (e1, _, a1, b1), (e2, _, a2, b2) = calls[-2:]
    assert (e1, e2) == ("grad", "grad")
    assert a1.data_ptr() == dy.data_ptr() and a1.is_contiguous()
    assert b1.data_ptr() == w.data_ptr() and b1.shape == (N, K) and b1.stride() == (1, N)
    assert a2.data_ptr() == x.data_ptr() and a2.shape == (K, M) and a2.stride() == (1, K)
    assert b2.data_ptr() == dy.data_ptr()


@pytest.mark.parametrize("M", [13, 24])
@pytest.mark.parametrize("K", [21, 40])
def test_grad_product_views_equal_contiguous_copies(M, K):
    """``ops.grad_product`` on transposed views, and on a view whose base is
    not 16-byte aligned (a column slice), gives bitwise the plain product
    of contiguous copies (``ref.gemm_batch_invariant`` at one chunk), for
    bf16 and f32 operands, at token counts and a contraction that are no
    multiples of 8."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(M * 100 + K)
    N = 24
    for dt in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.standard_normal((M, K + 1)).astype(np.float32)).to(dt)
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(dt)
        dy = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)).to(dt)
        xs = x[:, 1:]  # base one element off, row stride K + 1
        for a, b in ((dy, w.t()), (xs.t(), dy), (xs, w), (dy.t().contiguous().t(), w.t())):
            got = ops.grad_product(a, b)
            want = ref.gemm_batch_invariant(a.contiguous(), b.contiguous(), chunks=1)
            assert got.dtype == dt and torch.equal(got, want)


def test_attention_train_chunked_equals_unchunked(monkeypatch):
    """Past ``CHUNK_THRESHOLD`` rows the q-chunked branch (pad rows
    included) gives the unchunked attention's output and gradients."""
    cfg = dataclasses.replace(CFG, attn_kind="sliding", window=9)
    p = params_from_numpy(cfg, np_params(cfg, 5), "cpu")["blocks"]["0"]["attn"]
    p = {k: v[0].clone().requires_grad_(True) for k, v in p.items()}
    x = torch.randn(2, 28, cfg.d_model, generator=torch.Generator().manual_seed(2))
    outs, grads = [], []
    for window in (0, cfg.window):
        for thr in (layers.CHUNK_THRESHOLD, 8):
            monkeypatch.setattr(layers, "CHUNK_THRESHOLD", thr)
            monkeypatch.setattr(layers, "Q_CHUNK", 8)
            out = layers.attention_train(p, cfg, x, VERIFY_SCHEDULE, window)
            grads.append(torch.autograd.grad(out.square().sum(), p["wq"])[0])
            outs.append(out)
    for a, b in ((0, 1), (2, 3)):
        torch.testing.assert_close(outs[a], outs[b], atol=1e-6, rtol=0)
        torch.testing.assert_close(grads[a], grads[b], atol=1e-5, rtol=0)
    assert not torch.allclose(outs[0], outs[2])  # the window masks


@pytest.mark.parametrize("remat", [True, False])
def _chip_smoke():
    import importlib.util

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _count_step_gemms(monkeypatch, cfg, params, nb, remat):
    """Product-entry calls of one training step on the plain versions."""
    calls = _record_products(monkeypatch)
    splitk = []
    monkeypatch.setattr(ops, "gemm_splitk", lambda *a, **k: splitk.append(1))
    make_train_step(cfg, OPT, remat=remat)(params, init_opt_state(params), torch_batch(nb))
    return {"gemm_batch_invariant": sum(c[0] == "commit" for c in calls),
            "gemm_grad": sum(c[0] == "grad" for c in calls), "gemm_splitk": len(splitk)}


@pytest.mark.parametrize("remat", [True, False])
def test_chip_smoke_counts_a_steps_gemm_launches(setup, monkeypatch, remat):
    """``chip_smoke.train_gemm_launches``, which the training phase holds
    each step's launches to on the card, is the number of commit-GEMM and
    ``gemm_grad`` calls a step makes (counted here on the plain versions;
    at this f32 config every product is a commit GEMM), and a step calls
    no split-K GEMM; the phases sit before ``timings``."""
    cs = _chip_smoke()
    assert cs.PHASES.index("cluster") < cs.PHASES.index("training") < cs.PHASES.index(
        "timings")
    params, _, nb = setup
    want = cs.train_gemm_launches(CFG, remat)
    got = _count_step_gemms(monkeypatch, CFG, params, nb, remat)
    assert got == {k: want[k] for k in got} and want["gemm_grad"] == 0
    assert not any(n for k, n in want.items() if k not in got)


def test_chip_smoke_counts_a_bf16_steps_gemm_launches(monkeypatch):
    """At a bf16 config the step's backward products go to ``gemm_grad``
    (two for every forward GEMM), the forward and its recompute to the
    commit GEMM, as ``chip_smoke.train_gemm_launches`` counts them."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    params = train_params(cfg, params_from_numpy(cfg, np_params(cfg, 3), "cpu"))
    want = cs.train_gemm_launches(cfg, True)
    got = _count_step_gemms(monkeypatch, cfg, params, np_batch(cfg), True)
    fwd = sum(cs.forward_gemms(cfg))
    assert got == {k: want[k] for k in got} and want["gemm_grad"] == 2 * fwd > 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_setup(arch, tree):
    """(jax, jnp, the JAX smoke config of ``arch``, ``tree`` as jax arrays)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs

    return (jax, jnp, jconfigs.get_smoke_config(arch),
            jax.tree_util.tree_map(jnp.asarray, tree))


@pytest.fixture(scope="module")
def jax_reference(setup):
    """The JAX package at the shared weights, in one ``jax.jit`` (one
    compilation for both): ``(total, metrics, grads)`` of
    ``jax.value_and_grad`` of ``lm_loss``, and one ``train_step``'s
    ``(params, state, metrics)``."""
    _, tree, nb = setup
    jax, jnp, jcfg, jp = _jax_setup(ARCH, tree)
    from repro.training.optimizer import AdamWConfig as JAdamW, init_opt_state as jinit
    from repro.training.train import lm_loss as jlm_loss, make_train_step as jmake

    step = jmake(jcfg, JAdamW(**dataclasses.asdict(OPT)))

    def both(p, state, batch):
        def loss_fn(q):
            return jlm_loss(q, jcfg, batch["tokens"], batch["targets"], batch["loss_mask"])

        (total, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return (total, metrics, grads), step(p, state, batch)

    return jax.jit(both)(jp, jinit(jp), {k: jnp.asarray(v) for k, v in nb.items()})


@pytest.fixture(scope="module")
def jax_grads(jax_reference):
    """JAX's (total, metrics, grads) of ``lm_loss`` at the shared weights."""
    return jax_reference[0]


@pytest.fixture(scope="module")
def jax_step(jax_reference):
    """One JAX ``train_step`` at the shared weights: (params, state, metrics)."""
    return jax_reference[1]


def test_forward_train_logits_match_jax(setup):
    params, tree, nb = setup
    jax, jnp, jcfg, jp = _jax_setup(ARCH, tree)
    from repro.models.transformer import forward_train as jforward_train

    want, _ = jax.jit(lambda p, t: jforward_train(p, jcfg, t))(jp, jnp.asarray(nb["tokens"]))
    got, aux = forward_train(params, CFG, torch.from_numpy(nb["tokens"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    assert float(aux["aux_loss"]) == 0.0


def test_loss_and_every_gradient_match_jax(setup, jax_grads):
    params, _, nb = setup
    total, metrics, grads = jax_grads
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    b = torch_batch(nb)
    got, got_m = lm_loss(p, CFG, b["tokens"], b["targets"], b["loss_mask"])
    leaves = tree_leaves(p)
    gs = iter(torch.autograd.grad(got, leaves))
    got_g = tree_map(lambda t: next(gs), p)
    assert float(got.detach()) == pytest.approx(float(total), rel=1e-5)
    assert float(got_m["tokens"]) == float(metrics["tokens"])
    assert len(leaves) == len(_flat_np(grads))
    _assert_tree_close(got_g, grads, rel=GRAD_REL)


def test_train_step_matches_jax(setup, jax_step):
    params, _, nb = setup
    jnew, jstate, jm = jax_step
    new, state, m = make_train_step(CFG, OPT)(params, init_opt_state(params),
                                              torch_batch(nb))
    _assert_tree_close(new, jnew, atol=STEP_TOL)
    _assert_tree_close(state.mu, jstate.mu, rel=GRAD_REL)
    _assert_tree_close(state.nu, jstate.nu, rel=2 * GRAD_REL)
    assert int(state.step) == int(jstate.step) == 1
    for k in ("loss", "grad_norm", "lr", "tokens"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k


def test_train_program_step_matches_jax(setup, jax_step):
    """The training program's first step (``make_train_program``, the
    counterpart of the reference's jitted step) against that jitted step,
    within the eager step's tolerances."""
    from repro_torch.training.train import make_train_program

    params, _, nb = setup
    jnew, jstate, jm = jax_step
    prog = make_train_program(CFG, OPT, device="cpu")
    prog.load(params)
    m = prog.step(torch_batch(nb))
    _assert_tree_close(prog.params, jnew, atol=STEP_TOL)
    _assert_tree_close(prog.opt_state.mu, jstate.mu, rel=GRAD_REL)
    _assert_tree_close(prog.opt_state.nu, jstate.nu, rel=2 * GRAD_REL)
    assert int(prog.opt_state.step) == int(jstate.step) == 1
    for k in ("loss", "grad_norm", "lr", "tokens"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k


HYBRID = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def jax_hybrid():
    """The JAX package's smoke ``jamba-1.5-large-398b`` in one ``jax.jit``
    for both hybrid tests below (their weights and batches share shapes, so
    it compiles once): ``forward_train``'s ``(logits, aux)`` and
    ``jax.value_and_grad`` of ``lm_loss``'s ``((total, metrics), grads)``."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models.transformer import forward_train as jforward_train
    from repro.training.train import lm_loss as jlm_loss

    jcfg = jconfigs.get_smoke_config(HYBRID)

    def both(p, batch):
        def loss_fn(q):
            return jlm_loss(q, jcfg, batch["tokens"], batch["targets"], batch["loss_mask"])

        return (jforward_train(p, jcfg, batch["tokens"]),
                jax.value_and_grad(loss_fn, has_aux=True)(p))

    return jax.jit(both)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "seamless-m4t-medium",
                                  "rwkv6-3b", HYBRID])
def test_forward_train_families_match_jax(arch, jax_hybrid):
    """MoE: the logits, ``aux_loss`` and ``dropped_frac`` summed over the
    layers; encoder-decoder: the logits with ``enc_embeds`` (the encoder and
    every layer's cross K/V under an all-true mask); rwkv: the logits from
    the zero state; hybrid: the block positions in layer order, mamba
    layers from the zero state, MoE terms summed by block."""
    cfg = configs.get_smoke_config(arch)
    tree = np_params(cfg, 4)
    jax, jnp, jcfg, jp = _jax_setup(arch, tree)
    from repro.models.transformer import forward_train as jforward_train

    nb = np_batch(cfg, seq=16, batch=2, seed=2)
    kw, jkw = {}, {}
    if cfg.family == "encdec":
        enc = (np.random.default_rng(0).standard_normal(
            (2, cfg.encoder_seq_len, cfg.d_model)) * 0.02).astype(np.float32)
        kw, jkw = {"enc_embeds": torch.from_numpy(enc)}, {"enc_embeds": jnp.asarray(enc)}
    if arch == HYBRID:
        (want, jaux), _ = jax_hybrid(jp, {k: jnp.asarray(v) for k, v in nb.items()})
    else:
        want, jaux = jax.jit(lambda p, t, kw: jforward_train(p, jcfg, t, **kw))(
            jp, jnp.asarray(nb["tokens"]), jkw)
    got, aux = forward_train(train_params(cfg, params_from_numpy(cfg, tree, "cpu")), cfg,
                             torch.from_numpy(nb["tokens"]), remat=True, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_TOL, rtol=0)
    for k in ("aux_loss", "dropped_frac"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-5, abs=1e-7), k
    if cfg.num_experts:
        assert float(aux["aux_loss"]) > 0


def test_hybrid_loss_and_every_gradient_match_jax(jax_hybrid):
    """``lm_loss`` and every gradient leaf at the smoke ``jamba-1.5-large-398b``
    (2 x 16 tokens; attention, mamba, dense and MoE layers) against
    ``jax.value_and_grad`` of the JAX ``lm_loss``, within ``GRAD_REL`` of
    each leaf's max |g|."""
    cfg = configs.get_smoke_config(HYBRID)
    tree = np_params(cfg, 5)
    jax, jnp, jcfg, jp = _jax_setup(HYBRID, tree)

    nb = np_batch(cfg, seq=16, batch=2, seed=3)
    _, ((total, metrics), grads) = jax_hybrid(jp, {k: jnp.asarray(v) for k, v in nb.items()})
    p = tree_map(lambda t: t.detach().requires_grad_(True),
                 train_params(cfg, params_from_numpy(cfg, tree, "cpu")))
    b = torch_batch(nb)
    got, got_m = lm_loss(p, cfg, b["tokens"], b["targets"], b["loss_mask"])
    leaves = tree_leaves(p)
    gs = iter(torch.autograd.grad(got, leaves))
    got_g = tree_map(lambda t: next(gs), p)
    assert float(got.detach()) == pytest.approx(float(total), rel=1e-5)
    for k in ("aux_loss", "dropped_frac"):
        assert float(got_m[k].detach()) == pytest.approx(float(metrics[k]), rel=1e-5,
                                                        abs=1e-7), k
    assert len(leaves) == len(_flat_np(grads))
    _assert_tree_close(got_g, grads, rel=GRAD_REL)


def test_stream_matches_jax():
    pytest.importorskip("jax")
    from repro.training.data import SyntheticTextStream as JStream

    for args in ((512, 32, 4, 1), (32000, 64, 3, 7)):
        a, b = iter(SyntheticTextStream(*args)), iter(JStream(*args))
        for _ in range(3):
            x, y = next(a), next(b)
            for f in ("tokens", "targets", "loss_mask"):
                got, want = getattr(x, f), getattr(y, f)
                assert got.dtype == want.dtype and np.array_equal(got, want)


def test_checkpoints_cross_load(setup, jax_step, tmp_path):
    """An archive either package writes restores in the other, bitwise,
    step metadata and optimizer state included (the JAX state after one
    step, so the moments are not zeros)."""
    params, tree, _ = setup
    jax, jnp, jcfg, jp = _jax_setup(ARCH, tree)
    from repro.training import checkpoint as jckpt
    from repro.training.optimizer import init_opt_state as jinit

    jnew, jstate, _ = jax_step
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jckpt.save(jpath, jnew, jstate, step=1)
    p, o, step = checkpoint.restore(jpath, params, init_opt_state(params))
    assert step == 1 and int(o.step) == 1
    _assert_tree_close(p, jnew, atol=0)
    _assert_tree_close(o.mu, jstate.mu, atol=0)
    _assert_tree_close(o.nu, jstate.nu, atol=0)

    checkpoint.save(tpath, p, o, step=5)
    jp2, jo2, jstep = jckpt.restore(tpath, jp, jinit(jp))
    assert jstep == 5 and int(jo2.step) == 1
    for name in ("params", "mu", "nu"):
        a = jp2 if name == "params" else getattr(jo2, name)
        b = jnew if name == "params" else getattr(jstate, name)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    with np.load(tpath) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)


# ---------------------------------------------------------------------------
# cross-attention's q scale
# ---------------------------------------------------------------------------


def test_cross_attention_bf16_q_scale_matches_jax():
    """At head_dim 96, hd**-0.5 is inexact in bf16: the reference rounds q *
    scale to bf16 before its f32 softmax, and so must the W == 1 cross pass
    (``decode_attention`` with ``scale=1.0``), with hd^-0.5 itself rounded
    to bf16 first (``layers.q_scale``), as JAX casts its weakly typed
    scalar.  Scaling in f32 instead (the kernel's default) moves half the
    outputs, the largest by more than one bf16 ulp of max |out|."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.determinism import VERIFY_SCHEDULE as JVERIFY
    from repro.models.layers import cross_attention as jcross

    cfg = dataclasses.replace(configs.get_smoke_config("seamless-m4t-medium"),
                              head_dim=96, dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("seamless-m4t-medium"),
                               head_dim=96, dtype="bfloat16")
    rng = np.random.default_rng(7)
    H, KV, D, B, Se = cfg.num_heads, cfg.num_kv_heads, 96, 3, 40
    # small-integer weights and inputs: every GEMM is exact in f32, so the
    # two frameworks' sums agree and only the q scale's rounding remains
    arrs = {
        "x": rng.integers(-2, 3, (B, 1, cfg.d_model)),
        "wq": rng.integers(-1, 2, (cfg.d_model, H * D)) / 4,
        "wo": np.eye(H * D, cfg.d_model),
        "k": rng.integers(-3, 4, (B, Se, KV, D)) / 4,
        "v": rng.standard_normal((B, Se, KV, D)),
    }
    bf = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in arrs.items()}
    mask = np.ones((B, Se), bool)
    mask[1, 30:] = False
    got = layers.cross_attention({"wq": bf["wq"], "wo": bf["wo"]}, cfg, bf["x"], bf["k"],
                                 bf["v"], torch.from_numpy(mask), VERIFY_SCHEDULE)
    jb = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for k, v in bf.items()}
    want = jcross({"wq": jb["wq"], "wo": jb["wo"]}, jcfg, jb["x"], jb["k"], jb["v"],
                  jnp.asarray(mask), JVERIFY)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    ulp = want.abs().max().item() * 2 ** -8
    diff = (got.float() - want).abs()
    assert got.dtype == torch.bfloat16
    assert diff.max().item() <= ulp / 4 and (diff > 0).float().mean().item() <= 0.01
