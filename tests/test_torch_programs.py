"""One program per shape class (``serving.programs``) on the CPU.

* Key parity with the reference: on one shared trace (LLM42, llama3-smoke,
  chunked prefill, spec_depth 2, the overlap scheduler, an iteration that
  fuses a prefill chunk, a decode batch and a verify group), the port's
  ``Engine._programs`` keys equal the JAX engine's ``_fns`` keys plus the
  verify program's ``("verify", G, W)``.
* Buffer plumbing: committed streams under programs are bitwise the streams
  under ``programs.eager()`` in all three modes on both lanes, for rwkv6 and
  seamless too; an engine that serves traffic A and then traffic B gives
  B's streams of a fresh engine.
* A drained engine's schedule: traffic B after other traffic is scheduled
  pass by pass as the reference engine schedules it, which differs from a
  fresh engine's through the logical clock and the slot free list.
* The ``Program`` itself: one input buffer per input, reused at every
  call; inputs of another shape refused, naming the key; ``eager()`` calls
  the body on its arguments; ``kernels.recording.add_launches``.
* The gathered lane's view-capacity check, moved from the forward to the
  host prep, still refuses a pass that ends past the view.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config, llama3_8b
from repro_torch.core.determinism import Mode
from repro_torch.kernels import recording
from repro_torch.models.base import init_params
from repro_torch.serving import programs
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request, SamplingParams
from repro_torch.serving.scheduler import OverlapPolicy

ROOT = Path(__file__).resolve().parents[1]
CFG = llama3_8b.smoke_config()
#: the key-parity trace: prompts of 5 and 6 tokens prefill exclusively at
#: bucket 8, the 40-token one in chunks of 8 while the others decode and
#: verify (windows of 4, groups of 2, two windows in flight)
PARITY_KW = dict(window=4, group=2, max_batch=4, capacity=64, prefill_chunk=8,
                 spec_depth=2)
PARITY_LENS = (5, 6, 40)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def _norm(key):
    """A program key with its schedule as a plain tuple (the two packages'
    ``Schedule`` named tuples compare as tuples)."""
    return tuple(tuple(x) if isinstance(x, tuple) else x for x in key)


@pytest.fixture(scope="module")
def shared():
    """(the JAX smoke config, its params, the same params in the port) for
    the tests that run the reference engine."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import init_params as jax_init

    from repro_torch.models.convert import params_from_numpy

    jcfg = jax_smoke("llama3-8b")
    jax_params = jax_init(jcfg, jax.random.key(0))
    return jcfg, jax_params, params_from_numpy(
        CFG, jax.tree_util.tree_map(np.asarray, jax_params), "cpu")


def test_program_keys_equal_reference_fns(shared):
    from repro.core.determinism import Mode as JMode
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling
    from repro.serving.scheduler import OverlapPolicy as JOverlap

    jcfg, jax_params, port_params = shared
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist() for n in PARITY_LENS]
    jeng = JEngine(jcfg, jax_params, mode=JMode.LLM42,
                   scheduler=JOverlap(), **PARITY_KW)
    teng = Engine(CFG, port_params, mode=Mode.LLM42, scheduler=OverlapPolicy(),
                  **PARITY_KW)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, sampling=JSampling(
            max_new_tokens=6, is_deterministic=True)))
        teng.submit(Request(rid=i, prompt=p, sampling=SamplingParams(
            max_new_tokens=6, is_deterministic=True)))
    jeng.run()
    teng.run()
    ours = {_norm(k) for k in teng._programs}
    theirs = {_norm(k) for k in jeng._fns}
    assert ours == theirs | {("verify", 2, 4)}
    # the trace covers every key kind of a token model: exclusive prefill,
    # decode, a fused prefill chunk + decode + verify, the standalone verify
    kinds = {k[0] for k in ours}
    assert kinds == {"prefill", "decode", "fused", "verify"}
    assert any(k[0] == "fused" and k[1] is not None and k[2] > 0 and k[4] > 0
               for k in ours)
    # every step ran through a program: one run per call on the CPU
    assert all(p.runs >= 1 and p.captures == 0 for p in teng._programs.values())


def _requests(cfg, n, seed, lens=None, max_new=8):
    rng = np.random.default_rng(seed)
    lens = lens or [6 + (3 * i) % 11 for i in range(n)]
    reqs = []
    for i in range(n):
        sp = SamplingParams(max_new_tokens=max_new, is_deterministic=i % 3 != 1,
                            seed=100 + i)
        if i % 2:
            sp = SamplingParams(max_new_tokens=max_new, is_deterministic=sp.is_deterministic,
                                seed=100 + i, temperature=0.8, top_k=5)
        r = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, lens[i]).tolist(),
                    sampling=sp)
        if cfg.family == "encdec":
            g = torch.Generator().manual_seed(seed * 100 + i)
            r.enc_embeds = torch.randn((1, cfg.encoder_seq_len, cfg.d_model), generator=g)
        reqs.append(r)
    return reqs


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    return {r.rid: list(r.committed) for r in done}


def _engine(cfg, params, mode, paged, **kw):
    kw = {**dict(window=4, group=2, max_batch=4, capacity=64, prefill_chunk=8,
                 spec_depth=2, scheduler=OverlapPolicy()), **kw}
    return Engine(cfg, params, mode=mode, paged_attention=paged, **kw)


def _launches():
    return {fn.__name__: fn.launches for fn in recording.COUNTED}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gathered"])
@pytest.mark.parametrize("mode", [Mode.LLM42, Mode.BATCH_INVARIANT, Mode.NONDET],
                         ids=lambda m: m.value)
def test_programs_equal_eager(params, mode, paged):
    eng = _engine(CFG, params, mode, paged)
    got = _serve(eng, _requests(CFG, 5, seed=2))
    with programs.eager():
        want = _serve(_engine(CFG, params, mode, paged), _requests(CFG, 5, seed=2))
    assert got == want
    assert all(len(s) == 8 for s in got.values())
    progs = eng._programs
    assert progs and all(p.runs >= 1 and p.replays == 0 for p in progs.values())
    # every event of the run names a key the engine holds a program for
    assert sum(p.runs for p in progs.values()) >= len(
        [e for e in eng.events if e["kind"] != "cache_hit"])


def test_stale_buffers_a_then_b(params):
    """Traffic A then traffic B on one engine commit for B what the same
    engine commits under ``eager()`` (no program reads a buffer A left
    behind) and a fresh engine's deterministic streams of B."""
    lens_a, lens_b = [9, 17, 7, 12], [11, 6, 19, 8]
    got = {}
    for direct in (False, True):
        with programs.eager() if direct else contextlib.nullcontext():
            eng = _engine(CFG, params, Mode.LLM42, True)
            _serve(eng, _requests(CFG, 4, seed=5, lens=lens_a))
            n_before = {k: p.runs for k, p in eng._programs.items()}
            got[direct] = _serve(eng, _requests(CFG, 4, seed=6, lens=lens_b))
            assert any(eng._programs[k].runs > n for k, n in n_before.items()), (
                "traffic B reused none of A's programs")
    assert got[False] == got[True]
    fresh = _serve(_engine(CFG, params, Mode.LLM42, True),
                   _requests(CFG, 4, seed=6, lens=lens_b))
    det = [r.rid for r in _requests(CFG, 4, seed=6, lens=lens_b)
           if r.sampling.is_deterministic]
    assert det and all(got[False][r] == fresh[r] for r in det)


#: the drained-engine trace: traffic A, then traffic B on the same engine;
#: requests of one new token (T0), so that every pass is a prefill chunk,
#: picked by ``scheduler.pick_prefill``, and the reference compiles one
#: program
DRAIN_KW = dict(window=4, group=2, max_batch=3, capacity=64, prefill_chunk=8,
                spec_depth=2, paged_attention=False)


def _drain_traffic(request, sampling, seed):
    rng = np.random.default_rng(seed)
    return [request(rid=i, prompt=rng.integers(0, CFG.vocab_size, int(rng.integers(9, 24)))
                    .tolist(), sampling=sampling(max_new_tokens=1, is_deterministic=i % 2 == 0,
                                                 seed=10 * seed + i))
            for i in range(4)]


def _schedule(eng, reqs):
    """Each step's passes (kind, rids) and its running requests' slots and
    positions (prompt and committed tokens)."""
    for r in reqs:
        eng.submit(r)
    steps, seen = [], len(eng.events)
    while eng.queue or eng.running:
        eng.step()
        passes = [(e["kind"], tuple(e.get("rids", [e.get("rid")])))
                  for e in eng.events[seen:]]
        seen = len(eng.events)
        steps.append((passes, sorted((r.rid, r.slot, len(r.prompt) + len(r.committed))
                                     for r in eng.running)))
    return steps


def _slots(steps):
    return [[(rid, slot) for rid, slot, _ in running] for _, running in steps]


def test_drained_engine_schedule_follows_the_reference(shared):
    """A drained engine schedules traffic pass by pass as the reference
    engine does on the same trace (traffic B on a fresh engine, then A,
    then B again; NONDET, whose schedule no token value moves), and
    otherwise than a fresh engine.  For A then B, two states carry over:
    the logical clock ``_now``, whose phase ``scheduler.pick_prefill``
    reads (``now % 4``), and the slot free list, which hands B the slots
    in the order A's requests finished.  With both reset after A, B's
    schedule is a fresh engine's.  (B run again also meets its own prompts
    in the prefix cache.)"""
    from repro.core.determinism import Mode as JMode
    from repro.serving.engine import Engine as JEngine
    from repro.serving.request import Request as JRequest, SamplingParams as JSampling
    from repro.serving.scheduler import OverlapPolicy as JOverlap

    jcfg, jax_params, port_params = shared

    def port():
        return Engine(CFG, port_params, mode=Mode.NONDET, scheduler=OverlapPolicy(),
                      **DRAIN_KW)

    def traffic(seed):
        return _drain_traffic(Request, SamplingParams, seed)

    eng = port()
    got = {"port": [_schedule(eng, traffic(seed)) for seed in (2, 1, 2)]}
    jeng = JEngine(jcfg, jax_params, mode=JMode.NONDET, scheduler=JOverlap(), **DRAIN_KW)
    got["ref"] = [_schedule(jeng, _drain_traffic(JRequest, JSampling, seed))
                  for seed in (2, 1, 2)]
    assert got["port"] == got["ref"]
    fresh = got["port"][0]
    assert got["ref"][2] != fresh  # the reference's drained engine differs too
    eng = port()
    _schedule(eng, traffic(1))
    after = _schedule(eng, traffic(2))
    assert [p for p, _ in after] != [p for p, _ in fresh]  # the passes differ
    assert _slots(after) != _slots(fresh)  # and the slots
    eng = port()
    _schedule(eng, traffic(1))
    eng._now = 0
    eng.pool._free.sort()
    assert _schedule(eng, traffic(2)) == fresh


@pytest.mark.parametrize("arch", ["rwkv6-3b", "seamless-m4t-medium"])
def test_family_programs_equal_eager(arch):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = _engine(cfg, params, Mode.LLM42, True, capacity=64)
    got = _serve(eng, _requests(cfg, 3, seed=4))
    with programs.eager():
        want = _serve(_engine(cfg, params, Mode.LLM42, True, capacity=64),
                      _requests(cfg, 3, seed=4))
    assert got == want
    kinds = {k[0] for k in eng._programs}
    if cfg.family == "encdec":
        assert ("cross", cfg.encoder_seq_len) in eng._programs
    else:
        assert "prefill_chunk_rec" in kinds or "prefill" in kinds


@pytest.mark.parametrize("arch,kw", [
    ("llama3-8b", dict(prefill_chunk=0, scheduler=None)),
    ("llama3-8b", dict(paged_attention=False)),
    ("phi3-mini-3.8b-sw4k", dict(prefill_chunk=0, scheduler=None)),
    ("rwkv6-3b", dict()),
    ("jamba-1.5-large-398b", dict(prefill_chunk=0)),
    ("llama4-scout-17b-a16e", dict()),
    ("seamless-m4t-medium", dict(prefill_chunk=0)),
    ("llava-next-mistral-7b", dict()),
])
def test_chip_smoke_program_keys_name_every_program(arch, kw):
    """``chip_smoke.program_keys`` (the keys a run's events name, which the
    card's phases hold the engine's programs to) names exactly the
    programs each family's run made, sync and overlapped, exclusive and
    chunked prefill."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    if arch.endswith("sw4k"):  # its ring at smoke width, a window of 16
        cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                                  attn_kind="sliding", window=16)
    else:
        cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    paged = kw.pop("paged_attention", True)
    eng = _engine(cfg, params, Mode.LLM42, paged,
                  capacity=64 + cfg.num_prefix_embeds, **kw)
    _serve(eng, _requests(cfg, 4, seed=7, lens=[5, 23, 9, 14], max_new=6))
    norm = chip_smoke._norm_key
    assert {norm(k) for k in eng._programs} == {
        norm(k) for k in chip_smoke.program_keys(eng)}


def test_program_reuses_its_buffers():
    seen = []

    def body(x, pair):
        seen.append((x.data_ptr(), pair[0].data_ptr()))
        return {"sum": x + pair[0], "none": None, "list": [pair[1] * 2]}

    prog = programs.Program(("demo", 3), body, torch.device("cpu"))
    out = prog(torch.arange(3), (torch.ones(3, dtype=torch.long), torch.tensor(2.0)))
    assert out["sum"].tolist() == [1, 2, 3] and out["none"] is None
    assert out["list"][0].item() == 4.0
    out = prog(torch.arange(3) * 2, (torch.zeros(3, dtype=torch.long), torch.tensor(1.0)))
    assert out["sum"].tolist() == [0, 2, 4] and out["list"][0].item() == 2.0
    assert seen[0] == seen[1] and prog.runs == 2 and prog.captures == 0
    with pytest.raises(ValueError, match="demo"):
        prog(torch.arange(4), (torch.ones(3, dtype=torch.long), torch.tensor(2.0)))
    with pytest.raises(ValueError, match="demo"):
        prog(torch.arange(3.0), (torch.ones(3, dtype=torch.long), torch.tensor(2.0)))
    with programs.eager():
        x = torch.arange(3)
        prog(x, (torch.ones(3, dtype=torch.long), torch.tensor(2.0)))
    assert seen[-1][0] == x.data_ptr() and prog.runs == 3


def test_add_launches_moves_counts():
    fn = recording.COUNTED[0]
    before = fn.launches
    recording.add_launches({fn: 5})
    assert recording.launch_counts()[fn] == before + 5
    recording.add_launches({fn: -5})
    assert fn.launches == before
    assert {f.__name__ for f in recording.COUNTED} == {
        "gemm_batch_invariant", "gemm_grad", "gemm_splitk", "paged_attention",
        "paged_attention_fast", "decode_attention", "rmsnorm"}


def test_launch_counts_equal_eager_on_cpu(params):
    """On the CPU the wrappers run their plain versions and count nothing,
    under programs and under ``eager()`` alike."""
    before = _launches()
    _serve(_engine(CFG, params, Mode.LLM42, True), _requests(CFG, 2, seed=8))
    assert _launches() == before


def test_view_capacity_checked_on_the_host(params):
    """The gathered lane refuses, before any program runs, a pass that ends
    past the per-row view; the paged lane addresses through its table and
    has no view to overrun."""
    for paged in (False, True):
        eng = _engine(CFG, params, Mode.LLM42, paged, capacity=32)
        req = Request(rid=0, prompt=list(range(1, 9)),
                      sampling=SamplingParams(max_new_tokens=4, is_deterministic=True))
        eng.submit(req)
        eng.step()
        assert req.committed
        req.committed.extend([1] * 30)  # position 8 + 31 - 1 > 32
        if paged:
            eng._decode_prep([req])
            continue
        with pytest.raises(AssertionError, match="past the view capacity 32 would wrap"):
            eng._decode_prep([req])
        with pytest.raises(AssertionError, match="would wrap"):
            eng._check_view([30], 4)
        eng._check_view([28], 4)


def test_programs_import_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch\n"
            "from repro_torch.serving import engine, programs\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
