"""Prefix embeddings on the CPU (``llava-next-smoke``: 16 prefix positions
before the prompt, plain kernels).

* ``forward`` with ``inputs_embeds`` (the prefix embeds, then the prompt's
  token embeddings; a prefill, then two decode tokens) against the JAX
  package's on shared numpy-seeded weights (each matrix scaled by its own
  fan-in), on the paged lane and on gathered views, within ``FWD_TOL``
  (both sides sum f32, each in its own order).
* The engine against the JAX engine (its weights from the JAX
  ``init_params``): LLM42 committed streams agree up to the first position
  whose verifier top-1/top-2 margin is below ``MARGIN_TOL`` (near-ties are
  reported, not asserted).
* Within the port, bitwise: chunk sizes 0, 4, 6 and 8 commit the same
  stream (``tests/test_prefill.py``'s family check; at 6 a chunk holds both
  prefix and prompt positions); LLM42 and BATCH_INVARIANT streams identical
  alone and beside neighbours on both lanes; a request preempted and
  restored (its replay feeds the prefix again) commits its stream; the
  prefix cache is off; capacity, positions and prefill events count the
  prefix.
* The serve CLI at ``--arch llava-next-mistral-7b --smoke --device cpu``.
* ``chip_smoke.py``'s ``modalities`` phase is wired like the others: in
  ``PHASES``, in the docstring with its ``--phases`` example, and its
  functions import nothing but ``repro_torch``.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.determinism import VERIFY_SCHEDULE, Mode, ReductionPolicy
from repro_torch.models import transformer
from repro_torch.models.base import iter_specs, param_specs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import PagedView
from repro_torch.models.multimodal import num_vision_tokens, vision_embeds
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import PauseDecodePolicy

ROOT = Path(__file__).resolve().parents[1]
#: the serve CLI's process runs with one intra-op thread, as this module's
#: own tests do: several test workers share the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
ARCH = "llava-next-mistral-7b"
CFG = configs.get_smoke_config(ARCH)
P = CFG.num_prefix_embeds
FWD_TOL = 2e-4
#: as tests/test_torch_engine.py
MARGIN_TOL = 1e-3
DRIFTY = ReductionPolicy(thresholds=((2, 16), (4, 8), (16, 4)), combine_dtype="bfloat16")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def CFG_J():
    from repro import configs as jconfigs

    return jconfigs.get_smoke_config(ARCH)


@pytest.fixture(scope="module")
def jax_params():
    jax = pytest.importorskip("jax")
    from repro.models import init_params as jax_init

    return jax_init(CFG_J(), jax.random.key(0))


@pytest.fixture(scope="module")
def params(jax_params):
    import jax

    return params_from_numpy(CFG, jax.tree_util.tree_map(np.asarray, jax_params), "cpu")


def _prefix(seed, batch=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, P, CFG.d_model)) * 0.02).astype(np.float32)


def np_params(cfg, seed):
    """Numpy weights: normal * each matrix's fan-in^-0.5, norms ones."""
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


_JAX_LOGITS = {}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gathered"])
def test_forward_with_prefix_embeds_matches_jax(paged):
    """B = 2: a prefill of the 16 prefix embeds and 11 prompt tokens (as
    ``inputs_embeds``), then two decode tokens at positions 27 and 28."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.determinism import VERIFY_SCHEDULE as JV
    from repro.models import transformer as jt

    tree = np_params(CFG, 13)
    tp = params_from_numpy(CFG, tree, "cpu")
    B, C, bs = 2, 64, 8
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (B, 13)).astype(np.int32)
    prefix = _prefix(5, batch=B)
    emb0 = np.concatenate([prefix, tree["embed"][toks[:, :11]]], axis=1)
    steps = [(0, emb0, None), (P + 11, None, toks[:, 11:12]),
             (P + 12, None, toks[:, 12:13])]
    if "l" not in _JAX_LOGITS:
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jc = jt.init_cache(CFG_J(), B, C)
        want = []
        for start, emb, tok in steps:
            jl, jc, _ = jt.forward(
                jp, CFG_J(), None if tok is None else jnp.asarray(tok),
                inputs_embeds=None if emb is None else jnp.asarray(emb), cache=jc,
                start_pos=jnp.full((B,), start, jnp.int32), schedule=JV)
            want.append(np.asarray(jl))
        _JAX_LOGITS["l"] = want
    spec = transformer.cache_spec(CFG, B, C)
    if paged:
        nblk = C // bs
        kw = dict(tables=torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk),
                  paged=PagedView(bs, B * nblk, B * nblk + 1))

        def leaf(shape, dtype):
            full = (shape[0], B * nblk + 2, bs) + shape[3:]
            return (torch.full(full, -1, dtype=dtype) if dtype == torch.int32
                    else torch.zeros(full, dtype=dtype))
    else:
        kw = {}

        def leaf(shape, dtype):
            return (torch.full(shape, -1, dtype=dtype) if dtype == torch.int32
                    else torch.zeros(shape, dtype=dtype))
    cache = {"blocks": {"0": {n: leaf(*s) for n, s in spec["blocks"]["0"].items()}}}
    for (start, emb, tok), want in zip(steps, _JAX_LOGITS["l"]):
        got, cache, _ = transformer.forward(
            tp, CFG, None if tok is None else torch.from_numpy(tok),
            inputs_embeds=None if emb is None else torch.from_numpy(emb), cache=cache,
            start_pos=torch.full((B,), start, dtype=torch.int32),
            schedule=VERIFY_SCHEDULE, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)


def _request(rid, plen=21, max_new=12, det=True, **kw):
    rng = np.random.default_rng(300 + rid)
    r = Request(rid=rid, prompt=rng.integers(0, CFG.vocab_size, plen).tolist(),
                sampling=SamplingParams(max_new_tokens=max_new, is_deterministic=det,
                                        seed=80 + rid, **kw))
    r.prefix_embeds = torch.from_numpy(_prefix(400 + rid))
    return r


def test_engine_matches_jax_engine(jax_params, params):
    import jax.numpy as jnp
    from repro.core.determinism import Mode as JMode
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling
    from repro.serving.scheduler import PauseDecodePolicy as JPause

    # the pause scheduler: the fewest shape classes for the JAX engine to jit
    kw = dict(window=4, group=2, max_batch=2, capacity=64)
    jeng = JEngine(CFG_J(), jax_params, mode=JMode.LLM42, scheduler=JPause(), **kw)
    teng = Engine(CFG, params, mode=Mode.LLM42, audit=True,
                  scheduler=PauseDecodePolicy(), **kw)
    for rid in range(2):
        r = _request(rid, plen=12, max_new=8)
        teng.submit(r)
        jr = JRequest(rid=rid, prompt=r.prompt, sampling=JSampling(
            max_new_tokens=8, is_deterministic=True, seed=r.sampling.seed))
        jr.prefix_embeds = jnp.asarray(r.prefix_embeds.numpy())
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
    assert [ev["tokens"] for ev in teng.events if ev["kind"] == "prefill"] == [P + 12] * 2


def _serve(params, mode=Mode.LLM42, *, rids=(0, 1), paged=True, chunk=0,
           preempt_at=None):
    eng = Engine(CFG, params, mode=mode, policy=DRIFTY, window=5, group=2, max_batch=8,
                 capacity=128, paged_attention=paged, prefill_chunk=chunk)
    for rid in rids:
        eng.submit(_request(rid, plen=21 if rid < 10 else 9,
                            det=rid < 10 and mode != Mode.NONDET,
                            **({"temperature": 0.8, "top_k": 50} if rid == 1 else {})))
    if preempt_at is None:
        return {r.rid: r.committed for r in eng.run()}, eng
    while eng.step():
        if eng._now == preempt_at:
            assert eng.preempt(next(r for r in eng.running if r.rid == 0))
    return {r.rid: r.committed for r in eng.finished}, eng


def test_chunked_prefill_commits_the_exclusive_stream(params):
    """tests/test_prefill.py's family check on the port, with chunk 6 added:
    its third chunk holds prefix positions 12-15 and the first two prompt
    tokens."""
    base, eng = _serve(params, Mode.NONDET, rids=(0,))
    assert [ev["padded"] for ev in eng.events if ev["kind"] == "prefill"] == [P + 32]
    for chunk in (4, 6, 8):
        got, eng = _serve(params, Mode.NONDET, rids=(0,), chunk=chunk)
        chunks = [ev for ev in eng.events if ev["kind"] == "prefill_chunk"]
        assert sum(ev["tokens"] for ev in chunks) == P + 21
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


def test_preempt_and_restore_keep_the_stream(params):
    """The restore's replay feeds the prefix embeds, then prompt +
    committed[:-1]: the stream equals the run without the eviction."""
    base, _ = _serve(params, rids=(0, 1, 10))
    got, eng = _serve(params, rids=(0, 1, 10), preempt_at=4)
    assert eng.num_preemptions == 1 and eng.num_restores == 1
    assert {rid: got[rid] for rid in (0, 1)} == {rid: base[rid] for rid in (0, 1)}
    replay = next(ev for ev in eng.events if ev["kind"] == "prefill" and ev.get("replay"))
    assert replay["tokens"] >= P + 21  # the prefix, the prompt, committed[:-1]


def test_prefix_counts_in_capacity_positions_and_cache(params):
    eng = Engine(CFG, params, capacity=64, window=4)
    assert eng.prefix_cache is None
    r = _request(0, plen=30, max_new=8)
    # max(prefix + the prompt's bucket, prefix + prompt + output + verify rows)
    assert eng._worst_need(r) == max(P + 32, P + 30 + 8 + 4) == 58
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(_request(1, plen=40, max_new=8))  # 40 + 8 + 4 fits 64 alone
    eng.submit(r)
    eng.step()
    args, pos = eng._decode_prep([r])
    assert pos == [P + 30 + len(r.committed) + len(r.speculation) - 1]


def test_prefix_embeds_default_to_zeros(params):
    """A request without ``prefix_embeds`` prefills zeros there, as the
    reference does: the same stream as explicit zeros; prefix embeds of
    another shape are refused at submit."""
    def run(prefix):
        eng = Engine(CFG, params, mode=Mode.BATCH_INVARIANT, capacity=64)
        r = _request(0, max_new=4)
        r.prefix_embeds = prefix
        eng.submit(r)
        return eng.run()[0].committed

    assert run(None) == run(torch.zeros((1, P, CFG.d_model)))
    eng = Engine(CFG, params, capacity=64)
    r = _request(0)
    r.prefix_embeds = torch.zeros((1, P + 1, CFG.d_model))
    with pytest.raises(ValueError, match="prefix_embeds"):
        eng.submit(r)


def test_vision_embeds_shapes_and_seeding():
    from repro_torch.launch.serve import build_requests

    assert num_vision_tokens() == 2880 == configs.get_config(ARCH).num_prefix_embeds
    g = torch.Generator().manual_seed(0)
    x = vision_embeds(g, 2, 8, num_tiles=0)
    assert x.shape == (2, 576, 8) and x.dtype == torch.float32
    a, b = (build_requests(CFG, 2, 1.0, 4, seed=3) for _ in range(2))
    assert a[0].prefix_embeds.shape == (1, P, CFG.d_model)
    assert torch.equal(a[1].prefix_embeds, b[1].prefix_embeds)


def _functions(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def test_chip_smoke_modalities_phase_is_wired():
    """The phase sits in ``PHASES`` before ``timings``, the docstring names
    it with a ``--phases build,modalities`` example, ``main`` runs it, and
    every function it defines imports only ``repro_torch`` (the card has no
    JAX)."""
    text = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(text)
    doc = ast.get_docstring(tree)
    assert "modalities" in doc and "--phases build,modalities" in doc
    phases = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                  and any(getattr(t, "id", None) == "PHASES" for t in n.targets))
    names = [c.value for c in phases.elts]
    assert "modalities" in names and names.index("modalities") < names.index("timings")
    fns = _functions(tree)
    assert "phase_modalities" in fns
    assert "phase_modalities" in ast.unparse(fns["main"])
    mod_fns = [n for name, n in fns.items()
               if name == "phase_modalities" or name.startswith("modal_")]
    assert len(mod_fns) > 1
    for fn in mod_fns:
        for node in ast.walk(fn):
            if isinstance(node, ast.ImportFrom):
                assert node.module.split(".")[0] == "repro_torch", (fn.name, node.module)
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] == "repro_torch" for a in node.names)


def test_serve_cli_on_cpu():
    """``launch/serve.py --arch llava-next-mistral-7b --smoke --device cpu``: the requests
    carry their stub embeddings and every one finishes."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "5"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", **ONE_THREAD},
    )
    assert out.returncode == 0, out.stderr
    assert "finished 3 requests, 15 tokens committed" in out.stdout
