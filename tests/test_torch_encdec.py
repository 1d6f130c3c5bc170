"""The encoder-decoder family on the CPU (``seamless-smoke``, plain kernels).

* The parameter tree (``cross_attn``, ``norm2``, ``enc_blocks/0``,
  ``enc_final_norm``) is the JAX tree, leaf for leaf.
* On shared numpy-seeded weights (``np_params``: each matrix scaled by its
  own fan-in, through ``params_from_numpy``; the JAX initializer scales
  stacked weights by the layer count, which at two layers drives K, V and
  logits to magnitudes of 10-30) and inputs: ``encode``,
  ``build_cross_cache``, ``cross_attention`` at W = 1 (the dense decode
  kernel's plain version) and W > 1 (``_softmax_attend``) under the commit
  and a split schedule, and ``forward`` with cross K/V (prefill, then two
  decode tokens) on the paged lane and on gathered views, all within
  ``FWD_TOL`` (both sides sum f32, each in its own order).
* The engine against the JAX engine: LLM42 committed streams agree up to
  the first position whose verifier top-1/top-2 margin is below
  ``MARGIN_TOL`` (near-ties are reported, not asserted).
* Within the port, bitwise: chunk sizes 0, 4 and 8 commit the same stream
  (``tests/test_prefill.py``'s family check); LLM42 and BATCH_INVARIANT
  streams identical alone and beside neighbours on both lanes; a request
  preempted and restored commits its stream, the restore's cross cache
  bitwise the first build's; the prefix cache is off.
* An odd vocabulary (509): the unembedding is stored padded to 512 zero
  columns, passes the GEMMs' operand check, and the logits equal those of
  the unpadded unembedding bitwise.
* The serve CLI at ``--arch seamless-m4t-medium --smoke --device cpu``.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import VERIFY_SCHEDULE, Mode, ReductionPolicy, Schedule
from repro_torch.kernels.gemm_batch_invariant import check_operands
from repro_torch.models import layers, transformer
from repro_torch.models.base import init_params, iter_specs, padded_vocab, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import PagedView
from repro_torch.models.multimodal import audio_frames
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import PauseDecodePolicy

ROOT = Path(__file__).resolve().parents[1]
#: the serve CLI's process runs with one intra-op thread, as this module's
#: own tests do: several test workers share the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
ARCH = "seamless-m4t-medium"
CFG = configs.get_smoke_config(ARCH)
FWD_TOL = 2e-4
#: f32 logits of the two frameworks agree to ~1e-5 at this size; a margin
#: 100x that cannot flip (as tests/test_torch_engine.py)
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


@pytest.fixture(scope="module")
def jax_params():
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config
    from repro.models import init_params as jax_init

    return jax_init(get_smoke_config(ARCH), jax.random.key(0))


@pytest.fixture(scope="module")
def np_tree(jax_params):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax_params)


@pytest.fixture(scope="module")
def params(np_tree):
    return params_from_numpy(CFG, np_tree, "cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=FWD_TOL, rtol=0)


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


@pytest.fixture(scope="module")
def shared():
    """(JAX params, port params) of one numpy tree."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    tree = np_params(CFG, 11)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(CFG, tree, "cpu"))


def _enc_embeds(seed, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, CFG.encoder_seq_len, CFG.d_model))
            * 0.02).astype(np.float32)


def test_param_tree_matches_jax(np_tree):
    """``param_specs`` gives the JAX tree's paths and shapes; the counts
    equal the JAX config's."""
    from repro import configs as jconfigs

    flat = {"/".join(p): s.shape for p, s in iter_specs(param_specs(CFG))}

    def walk(node, prefix=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, prefix + (k,))
        else:
            yield "/".join(prefix), tuple(node.shape)

    assert flat == dict(walk(np_tree))
    assert flat["blocks/0/cross_attn/wq"] == (2, 256, 256)
    assert flat["enc_blocks/0/ffn/wi_gate"] == (2, 256, 512)
    assert "blocks/0/norm2" in flat and "enc_blocks/0/norm2" not in flat
    jcfg = jconfigs.get_smoke_config(ARCH)
    assert CFG.param_count() == jcfg.param_count()


def test_encode_and_cross_cache_match_jax(shared):
    import jax.numpy as jnp
    from repro.models import transformer as jt

    jax_params, params = shared
    enc = _enc_embeds(1)
    want_out = np.asarray(jt.encode(jax_params, CFG_J(), jnp.asarray(enc)))
    got_out = transformer.encode(params, CFG, torch.from_numpy(enc))
    _close(got_out.numpy(), want_out)
    want = jt.build_cross_cache(jax_params, CFG_J(), jnp.asarray(enc))
    got = transformer.build_cross_cache(params, CFG, torch.from_numpy(enc))
    assert got["k"].shape == (CFG.num_layers, 2, CFG.encoder_seq_len,
                              CFG.num_kv_heads, CFG.hd)
    for name in ("k", "v"):
        _close(got[name].numpy(), want[name])
    assert got["mask"].shape == (1, 2, CFG.encoder_seq_len)
    assert np.array_equal(got["mask"][0].numpy(), np.asarray(want["mask"]))


def CFG_J():
    from repro import configs as jconfigs

    return jconfigs.get_smoke_config(ARCH)


@pytest.mark.parametrize("W", [1, 5])
@pytest.mark.parametrize("schedule", [VERIFY_SCHEDULE, FAST], ids=["commit", "split"])
def test_cross_attention_matches_jax(shared, W, schedule):
    """W == 1 runs the dense decode kernel's plain version, W > 1
    ``_softmax_attend``; the encoder mask's last frames are masked in one
    row (a prefix mask)."""
    import jax.numpy as jnp
    from repro.core.determinism import Schedule as JSchedule
    from repro.models import layers as jl

    jax_params, params = shared
    rng = np.random.default_rng(W)
    B, Se = 2, CFG.encoder_seq_len
    x = rng.standard_normal((B, W, CFG.d_model)).astype(np.float32)
    k = rng.standard_normal((B, Se, CFG.num_kv_heads, CFG.hd)).astype(np.float32)
    v = rng.standard_normal((B, Se, CFG.num_kv_heads, CFG.hd)).astype(np.float32)
    mask = np.ones((B, Se), bool)
    mask[1, 20:] = False
    lp = {n: a[1] for n, a in jax_params["blocks"]["0"]["cross_attn"].items()}
    want = jl.cross_attention(lp, CFG_J(), *(jnp.asarray(a) for a in (x, k, v, mask)),
                              JSchedule(*schedule))
    tp = {n: t[1] for n, t in params["blocks"]["0"]["cross_attn"].items()}
    got = layers.cross_attention(tp, CFG, *(torch.from_numpy(a) for a in (x, k, v, mask)),
                                 schedule)
    assert got.shape == (B, W, CFG.d_model)
    _close(got.numpy(), want)


_STEPS = [(0, 11), (11, 12), (12, 13)]
_JAX_LOGITS = {}


def _jax_forward(jax_params, toks, enc, C):
    """The JAX package's logits of every pass of ``_STEPS`` (once: both
    lanes compare against them)."""
    import jax.numpy as jnp
    from repro.core.determinism import VERIFY_SCHEDULE as JV
    from repro.models import transformer as jt

    if "l" not in _JAX_LOGITS:
        B = toks.shape[0]
        jc = jt.init_cache(CFG_J(), B, C)
        jc["cross"] = jt.build_cross_cache(jax_params, CFG_J(), jnp.asarray(enc))
        want = []
        for s, e in _STEPS:
            jl, jc, _ = jt.forward(jax_params, CFG_J(), jnp.asarray(toks[:, s:e]),
                                   cache=jc, start_pos=jnp.full((B,), s, jnp.int32),
                                   schedule=JV)
            want.append(np.asarray(jl))
        _JAX_LOGITS["l"] = want
    return _JAX_LOGITS["l"]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gathered"])
def test_forward_with_cross_matches_jax(shared, paged):
    """An 11-token prefill and two decode tokens, B = 2, each package's
    cross cache from its own encoder on the same frames."""
    jax_params, params = shared
    B, C, bs = 2, 32, 8
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size, (B, 13)).astype(np.int32)
    enc = _enc_embeds(4)
    want = _jax_forward(jax_params, toks, enc, C)
    cross = transformer.build_cross_cache(params, CFG, torch.from_numpy(enc))
    spec = transformer.cache_spec(CFG, B, C)
    if paged:
        nblk = C // bs
        kw = dict(tables=torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk),
                  paged=PagedView(bs, B * nblk, B * nblk + 1))

        def leaf(shape, dtype):  # (layers, NB + 2, bs, ...)
            full = (shape[0], B * nblk + 2, bs) + shape[3:]
            return (torch.full(full, -1, dtype=dtype) if dtype == torch.int32
                    else torch.zeros(full, dtype=dtype))
    else:
        kw = {}

        def leaf(shape, dtype):
            return (torch.full(shape, -1, dtype=dtype) if dtype == torch.int32
                    else torch.zeros(shape, dtype=dtype))
    cache = {"blocks": {"0": {n: leaf(*s) for n, s in spec["blocks"]["0"].items()}},
             "cross": cross}
    for (s, e), jl in zip(_STEPS, want):
        tl, cache, _ = transformer.forward(
            params, CFG, torch.from_numpy(toks[:, s:e]), cache=cache,
            start_pos=torch.full((B,), s, dtype=torch.int32), schedule=VERIFY_SCHEDULE,
            **kw)
        _close(tl.numpy(), jl)
    assert cache["cross"] is cross


def _request(rid, plen=12, max_new=10, det=True, seed=None, **kw):
    rng = np.random.default_rng(100 + rid)
    r = Request(rid=rid, prompt=rng.integers(0, CFG.vocab_size, plen).tolist(),
                sampling=SamplingParams(max_new_tokens=max_new, is_deterministic=det,
                                        seed=70 + rid if seed is None else seed, **kw))
    r.enc_embeds = torch.from_numpy(_enc_embeds(200 + rid, batch=1))
    return r


def test_engine_matches_jax_engine(jax_params, params):
    from repro.core.determinism import Mode as JMode
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling
    from repro.serving.scheduler import PauseDecodePolicy as JPause
    import jax.numpy as jnp

    # the pause scheduler: the fewest shape classes for the JAX engine to jit
    kw = dict(window=4, group=2, max_batch=2, capacity=64)
    jeng = JEngine(CFG_J(), jax_params, mode=JMode.LLM42, scheduler=JPause(), **kw)
    teng = Engine(CFG, params, mode=Mode.LLM42, audit=True,
                  scheduler=PauseDecodePolicy(), **kw)
    for rid in range(2):
        r = _request(rid, max_new=8)
        teng.submit(r)
        jr = JRequest(rid=rid, prompt=r.prompt, sampling=JSampling(
            max_new_tokens=8, is_deterministic=True, seed=r.sampling.seed))
        jr.enc_embeds = jnp.asarray(r.enc_embeds.numpy())
        jeng.submit(jr)
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


def _serve(params, mode=Mode.LLM42, *, rids=(0, 1), paged=True, chunk=0,
           preempt_at=None, **kw):
    eng = Engine(CFG, params, mode=mode, policy=DRIFTY, window=5, group=2, max_batch=8,
                 capacity=128, paged_attention=paged, prefill_chunk=chunk, **kw)
    for rid in rids:
        eng.submit(_request(rid, plen=21 if rid < 10 else 9, max_new=12,
                            det=rid < 10 and mode != Mode.NONDET,
                            **({"temperature": 0.8, "top_k": 50} if rid == 1 else {})))
    if preempt_at is None:
        return {r.rid: r.committed for r in eng.run()}, eng
    cross = None
    while eng.step():
        if eng._now == preempt_at:
            victim = next(r for r in eng.running if r.rid == 0)
            cross = {n: t[:, victim.slot].clone()
                     for n, t in eng.pool.data["cross"].items()}
            assert eng.preempt(victim)
    return {r.rid: r.committed for r in eng.finished}, eng, cross


def test_chunked_prefill_commits_the_exclusive_stream(params):
    """tests/test_prefill.py's family check on the port: chunk sizes 0, 4
    and 8 commit the same stream (NONDET, one request)."""
    base, eng = _serve(params, Mode.NONDET, rids=(0,))
    assert not any(ev["kind"] == "prefill_chunk" for ev in eng.events)
    for chunk in (4, 8):
        got, eng = _serve(params, Mode.NONDET, rids=(0,), chunk=chunk)
        assert any(ev["kind"] == "prefill_chunk" for ev in eng.events)
        assert got == base, chunk


@pytest.mark.parametrize("mode", [Mode.LLM42, Mode.BATCH_INVARIANT], ids=lambda m: m.value)
def test_streams_beside_neighbours_on_both_lanes(params, mode):
    runs = {(paged, n): _serve(params, mode, rids=(0, 1) + tuple(range(10, 10 + n)),
                               paged=paged)[0]
            for paged in (True, False) for n in (0, 3)}
    first = {rid: runs[True, 0][rid] for rid in (0, 1)}
    assert all(len(s) == 12 for s in first.values())
    for key, streams in runs.items():
        assert {rid: streams[rid] for rid in (0, 1)} == first, key


def test_preempt_and_restore_keep_the_stream_and_the_cross_cache(params):
    """A request evicted mid-run is restored by recompute: the encoder runs
    again (bitwise the first build's cross K/V) and the stream is the one
    of the run without the eviction."""
    base, _ = _serve(params, rids=(0, 1, 10))
    got, eng, before = _serve(params, rids=(0, 1, 10), preempt_at=4)
    assert eng.num_preemptions == 1 and eng.num_restores == 1
    assert eng.num_cross_builds == 4  # three admissions and one restore
    assert {rid: got[rid] for rid in (0, 1)} == {rid: base[rid] for rid in (0, 1)}
    slot = next(r for r in eng.finished if r.rid == 0)
    assert before is not None and slot is not None
    rebuilt = transformer.build_cross_cache(
        params, CFG, _request(0).enc_embeds)
    for name in ("k", "v", "mask"):
        assert torch.equal(before[name], rebuilt[name][:, 0]), name


def test_prefix_cache_off_and_cross_leaves_read_only(params):
    eng = Engine(CFG, params, capacity=64)
    assert eng.prefix_cache is None
    kinds = eng.pool.layout.kinds["cross"]
    assert kinds == {"k": "cross", "v": "cross", "mask": "cross"}
    assert eng.pool.data["cross"]["mask"].shape == (1, eng.max_batch + 1,
                                                    CFG.encoder_seq_len)
    from repro_torch.serving import statepool

    assert "cross" not in statepool.state_spec(CFG, 2)
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.submit(Request(rid=0, prompt=[1, 2, 3]))
    short = Request(rid=1, prompt=[1, 2, 3])
    short.enc_embeds = torch.zeros((1, CFG.encoder_seq_len - 1, CFG.d_model))
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.submit(short)


def test_serve_builds_seeded_audio_frames():
    from repro_torch.launch.serve import build_requests

    a = build_requests(CFG, 2, 1.0, 4, seed=3)
    b = build_requests(CFG, 2, 1.0, 4, seed=3)
    assert a[0].enc_embeds.shape == (1, CFG.encoder_seq_len, CFG.d_model)
    assert torch.equal(a[1].enc_embeds, b[1].enc_embeds)
    assert not torch.equal(a[0].enc_embeds, a[1].enc_embeds)
    g = torch.Generator().manual_seed(5)
    x = audio_frames(g, 1, 8, 4)
    assert x.shape == (1, 8, 4) and float(x.abs().max()) < 0.2


def test_odd_vocab_unembedding_is_padded():
    """vocab 509: ``unembed`` is stored (d, 512) with zero columns past 509,
    the GEMMs' operand check takes it, and the logits are those of the
    unpadded unembedding bitwise, cut to 509 columns."""
    cfg = dataclasses.replace(CFG, vocab_size=509)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert padded_vocab(cfg) == 512 and p["unembed"].shape == (cfg.d_model, 512)
    assert not p["unembed"][:, 509:].any()
    check_operands("unembed", torch.zeros((4, cfg.d_model)), p["unembed"])
    check_operands("unembed", torch.zeros((4, cfg.d_model), dtype=torch.bfloat16),
                   p["unembed"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 8"):
        check_operands("unembed", torch.zeros((4, cfg.d_model), dtype=torch.bfloat16),
                       p["unembed"][:, :509].contiguous().to(torch.bfloat16))
    x = torch.randn((3, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    got = transformer._unembed(p, cfg, x, VERIFY_SCHEDULE)
    unpadded = dict(p, unembed=p["unembed"][:, :509].contiguous())
    want = transformer.matmul(x, unpadded["unembed"], VERIFY_SCHEDULE)
    assert got.shape == (3, 5, 509)
    assert torch.equal(got, want)
    eng = Engine(cfg, p, capacity=64)
    r = Request(rid=0, prompt=[5, 7, 11], sampling=SamplingParams(max_new_tokens=4))
    r.enc_embeds = torch.zeros((1, cfg.encoder_seq_len, cfg.d_model))
    eng.submit(r)
    assert all(0 <= t < 509 for t in eng.run()[0].committed)


def test_serve_cli_on_cpu():
    """``launch/serve.py --arch seamless-m4t-medium --smoke --device cpu``: the requests
    carry their stub embeddings and every one finishes."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "5"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", **ONE_THREAD},
    )
    assert out.returncode == 0, out.stderr
    assert "finished 3 requests, 15 tokens committed" in out.stdout
