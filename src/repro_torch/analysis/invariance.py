"""Shape-invariance prover: the commit path is batch-invariant by its programs.

The port's counterpart of ``repro.analysis.invariance``, with its constants.
The LLM-42 contract says the verify and prefill (commit) computations must
not change their reduction structure with the dynamic batch composition:
that is what makes committed tokens independent of co-scheduled traffic
(paper §2.2/§4).  This pass proves it from the programs the eager engine
runs:

1. Build the real ``serving.Engine`` for each arch class, on the CPU or the
   card, over the port's ``init_params`` at smoke size (the eager bodies
   read values on the host, so the reference's abstract parameters have
   no counterpart; ``run_pass`` also takes a caller's config and weights,
   which is how ``chip_smoke.py`` proves the attention class at
   Llama-3-8B's full width).
2. Record its step bodies (``trace_utils.Recorder``) at several batch
   compositions, each called as the engine calls it, under
   ``core.determinism.deterministic_torch``: the grouped verify body
   (``core.verifier.make_verify_body``; ``verify_recurrent`` from the state
   pool's anchor on a recurrent config), the prefill chunk
   (``Engine._prefill_chunk_body(C)``) and the batch-invariant decode
   (``Engine._decode_body(B, INVARIANT_SCHEDULE)``).
3. Canonicalize each live program and require the forms identical across
   batch sizes, integers allowed to differ only as batch-affine dimensions
   ``k*B + c`` (``trace_utils.compare_canonical``).

Batch sizes are primes >= 13 (13/17/19), so that no model dimension or
structural constant fits the affine window by accident.  Each body is run
once unrecorded first: one-time host work (``layers.q_scale``'s cached
read) is set-up, not the step.

Negative controls guard the prover against vacuity: the fast-path decode
under ``FAST_PATH_POLICY`` at 13 rows (4 splits) and 17 rows (2 splits),
whose programs differ in their ``gemm_splitk`` and ``paged_attention_fast``
nodes' geometry, and, in the mesh pass, ``Engine._decode_schedule`` at TP
widths 1 and 4.  If either pair canonicalizes identically, the pass fails
itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.analysis.report import Finding
from repro_torch.analysis.trace_utils import (
    Log, canonicalize, compare_canonical, dce, kernel_summary, record,
)
from repro_torch.configs import get_smoke_config
from repro_torch.core.determinism import (
    FAST_PATH_POLICY, INVARIANT_SCHEDULE, Mode, deterministic_torch,
)
from repro_torch.core.verifier import make_verify_body
from repro_torch.models.base import ModelConfig, init_params
from repro_torch.serving.engine import Engine

BATCHES = (13, 17, 19)
WINDOW = 8
CAPACITY = 128
BLOCK_SIZE = 16
MAX_BATCH = 20  # engine slots; >= max(BATCHES), never divisible by them
#: Mesh widths the TP-invariance pass builds engines at (each divides
#: CANONICAL_TP_SHARDS, as ``Engine`` requires).
MESH_TPS = (1, 2, 4)
#: Fixed batch for the mesh pass: TP varies at constant batch, so no
#: batch-affine allowance can mask a leak.
MESH_BATCH = 13
#: Arch classes the mesh pass sweeps: attention (the pure-KV commit path)
#: and jamba (the recurrent + MoE hybrid).
MESH_ARCHES = ("attention", "jamba")
#: rows' KV blocks before the window (positions [0, START) are in the pool)
START = 2 * BLOCK_SIZE


def _ssm_smoke() -> ModelConfig:
    """A mamba-carrying config without MoE (the reference's 'ssm' class:
    jamba-smoke at 2 layers, attention and mamba, MoE stripped)."""
    base = get_smoke_config("jamba-1.5-large-398b")
    return dataclasses.replace(base, name="mamba-ssm-smoke", num_layers=2,
                               num_experts=0, top_k=0, moe_d_ff=0)


ARCH_CLASSES: Dict[str, Callable[[], ModelConfig]] = {
    "attention": lambda: get_smoke_config("llama3-8b"),
    "ssm": _ssm_smoke,
    "rwkv6": lambda: get_smoke_config("rwkv6-3b"),
    "jamba": lambda: get_smoke_config("jamba-1.5-large-398b"),
}

# commit-path kinds that must be invariant; decode_fast must NOT be
INVARIANT_KINDS = ("verify", "prefill_chunk", "decode_invariant")


def smoke_params(cfg: ModelConfig, device) -> Dict:
    """The port's random weights for ``cfg`` on ``device`` (seed 0)."""
    return init_params(cfg, torch.Generator(device=device).manual_seed(0), device)


def build_engine(cfg: ModelConfig, params: Dict, tp: int = 1) -> Engine:
    """An LLM42 engine over ``params`` at the pass's window and pool."""
    return Engine(cfg, params, mode=Mode.LLM42, window=WINDOW, group=4,
                  max_batch=MAX_BATCH, capacity=CAPACITY, block_size=BLOCK_SIZE,
                  prefill_chunk=BLOCK_SIZE, tp=tp)


@contextlib.contextmanager
def _engine_context(tf32: bool = False) -> Iterator[None]:
    """The context the engine runs a body in; ``tf32`` turns cuBLAS TF32 on
    inside it (the seeded violation of the TF32 rule)."""
    with deterministic_torch():
        if not tf32:
            yield
            return
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _rows(engine: Engine, n: int):
    """Per-row slots and block tables of ``n`` rows: row i in slot i, its
    first two blocks allocated (2i, 2i + 1), the rest of its table empty."""
    blocks = [[2 * i, 2 * i + 1] for i in range(n)] if engine.pool.paged else [[] for _ in range(n)]
    return list(range(n)), engine.pool.table_array(blocks)


def _sampling(n: int):
    """Every row seeded (temperature 0.7, top-k 4), so the sampler's noise,
    its top-k sort and its greedy argmax are all in the program."""
    return [100 + i for i in range(n)], [0.7] * n, [4] * n


def verify_call(engine: Engine, G: int):
    """(body, args) of the grouped verify pass at group size G."""
    cfg, W = engine.cfg, WINDOW
    body = make_verify_body(cfg, G, W, engine.pool.layout, paged=engine._paged_fwd)
    slots, tables = _rows(engine, G)
    inputs = [[(7 * i + j) % cfg.vocab_size for j in range(W)] for i in range(G)]
    cands = [row[1:] for row in inputs]
    seeds, temps, tks = _sampling(G)
    args = [slots, tables, engine._ints([START] * G), engine._ints(inputs),
            engine._ints(cands), engine._ints([W - 1] * G), seeds, temps,
            [START + 1] * G, tks]
    head = [engine.params, engine.pool.data]
    if engine.has_recurrent_state:
        head.append(engine.statepool.anchor)
    return body, head + args


def prefill_chunk_call(engine: Engine, C: int):
    """(body, args) of the chunk-resumable prefill step at chunk width C."""
    cfg = engine.cfg
    body = engine._prefill_chunk_body(C)
    _, tables = _rows(engine, 1)
    if engine.pool.paged:
        tables = engine.pool.table_array([list(range(engine.pool.blocks_per_table))])
    tokens = torch.tensor([[(5 * j) % cfg.vocab_size for j in range(C)]],
                          dtype=torch.long, device=engine.device)
    embeds = engine.params["embed"][tokens]
    args = [engine.params, engine.pool.data, 0, tables[0], embeds,
            engine._ints(0), engine._ints(C - 1)]
    return body, args


def decode_call(engine: Engine, B: int, schedule):
    """(body, args) of the decode step at batch B under ``schedule``."""
    cfg = engine.cfg
    body = engine._decode_body(B, schedule)
    slots, tables = _rows(engine, B)
    seeds, temps, tks = _sampling(B)
    args = [engine.params, engine.pool.data, slots, tables,
            engine._ints([(3 * i) % cfg.vocab_size for i in range(B)]),
            engine._ints([START] * B), seeds, temps, [START + 1] * B, tks]
    return body, args


def run_call(call, *, recorded: bool = True, tf32: bool = False) -> Optional[Log]:
    """Run one (body, args) as the engine does; its live recorded program."""
    body, args = call
    with _engine_context(tf32):
        if not recorded:
            body(*args)
            return None
        log, _ = record(body, *args)
    return dce(log)


def trace_verify(engine: Engine, G: int, *, tf32: bool = False) -> Log:
    return run_call(verify_call(engine, G), tf32=tf32)


def trace_prefill_chunk(engine: Engine, C: int) -> Log:
    return run_call(prefill_chunk_call(engine, C))


def trace_decode(engine: Engine, B: int, schedule) -> Log:
    return run_call(decode_call(engine, B, schedule))


def warm_up(engine: Engine, batch: int) -> None:
    """Each body once, unrecorded: one-time host work leaves the programs."""
    run_call(verify_call(engine, batch), recorded=False)
    run_call(prefill_chunk_call(engine, batch), recorded=False)
    run_call(decode_call(engine, batch, INVARIANT_SCHEDULE), recorded=False)
    run_call(decode_call(engine, batch, FAST_PATH_POLICY.schedule_for(batch)),
             recorded=False)


@dataclasses.dataclass
class ArchTraces:
    arch: str
    cfg: ModelConfig
    # kind -> batch (or TP width) -> live recorded program (kinds: verify,
    # prefill_chunk, decode_invariant; decode_fast for the control)
    traces: Dict[str, Dict[int, Log]]
    canon: Dict[str, Dict[int, str]]
    batch: int = 0  # the mesh pass's fixed batch (0: the batch pass)


def _canon(traces: Dict[str, Dict[int, Log]], batch: Optional[int] = None):
    return {kind: {b: canonicalize(log, batch or b) for b, log in per.items()}
            for kind, per in traces.items()}


def _cfg_params(arch: str, device, cfg=None, params=None):
    cfg = cfg if cfg is not None else ARCH_CLASSES[arch]()
    return cfg, (params if params is not None else smoke_params(cfg, device))


def trace_arch(arch: str, batches=BATCHES, *, device, cfg: Optional[ModelConfig] = None,
               params: Optional[Dict] = None) -> ArchTraces:
    """Record the commit kinds at each batch and the fast-path control at
    the first two, on ``device`` (``cfg`` and ``params`` default to the
    arch class's smoke config and its random weights there)."""
    cfg, params = _cfg_params(arch, device, cfg, params)
    engine = build_engine(cfg, params)
    warm_up(engine, batches[0])
    traces: Dict[str, Dict[int, Log]] = {k: {} for k in INVARIANT_KINDS + ("decode_fast",)}
    for b in batches:
        traces["verify"][b] = trace_verify(engine, b)
        traces["prefill_chunk"][b] = trace_prefill_chunk(engine, b)
        traces["decode_invariant"][b] = trace_decode(engine, b, INVARIANT_SCHEDULE)
    # negative control: two points straddling a FAST_PATH_POLICY split-count
    # threshold (13 rows -> 4 splits, 17 rows -> 2 splits)
    for b in batches[:2]:
        traces["decode_fast"][b] = trace_decode(engine, b, FAST_PATH_POLICY.schedule_for(b))
    return ArchTraces(arch, cfg, traces, _canon(traces))


def prove(tr: ArchTraces) -> tuple:
    """(findings, certificate) of one arch class's batch traces."""
    findings = []
    cert: dict = {"arch": tr.arch, "config": tr.cfg.name, "kinds": {}}
    for kind in INVARIANT_KINDS:
        per = tr.canon[kind]
        batches = sorted(per)
        ref_b = batches[0]
        ref = per[ref_b]
        invariant = True
        for b in batches[1:]:
            div = compare_canonical(ref, per[b], ref_b, b)
            if div is None:
                continue
            invariant = False
            line, a, bb = div
            findings.append(Finding(
                pass_name="invariance", rule="batch-variant-commit-path",
                where=f"trace::{tr.arch}::{kind}", arch=tr.arch,
                message=(f"{kind} program differs between batch {ref_b} and {b} "
                         f"at canonical line {line}:\n      B={ref_b}: {a}\n"
                         f"      B={b}: {bb}\n    the commit path must run one "
                         "batch-invariant schedule (paper §2.2/§4)")))
        cert["kinds"][kind] = {
            "batches": batches, "invariant": invariant,
            "canonical_lines": len(ref.splitlines()),
            "kernels": kernel_summary(tr.traces[kind][ref_b]),
        }
    fast = tr.canon["decode_fast"]
    b0, b1 = sorted(fast)[:2]
    control_ok = compare_canonical(fast[b0], fast[b1], b0, b1) is not None
    cert["negative_control"] = {
        "kind": "decode_fast", "batches": [b0, b1], "schedules_differ": control_ok,
        "kernels": {b: kernel_summary(tr.traces["decode_fast"][b]) for b in (b0, b1)},
    }
    if not control_ok:
        findings.append(Finding(
            pass_name="invariance", rule="prover-self-check",
            where=f"trace::{tr.arch}::decode_fast", arch=tr.arch,
            message=(f"fast-path decode at B={b0} (schedule "
                     f"{tuple(FAST_PATH_POLICY.schedule_for(b0))}) and B={b1} "
                     f"(schedule {tuple(FAST_PATH_POLICY.schedule_for(b1))}) "
                     "canonicalized identically: the canonicalizer can no longer "
                     "tell reduction schedules apart, so the certificates above "
                     "are vacuous")))
    return findings, cert


def trace_arch_mesh(arch: str, tps=MESH_TPS, batch: int = MESH_BATCH, *, device,
                    cfg: Optional[ModelConfig] = None,
                    params: Optional[Dict] = None) -> ArchTraces:
    """Record the commit kinds from engines built at each TP width (a mesh
    parameter leaking onto the commit side would change them), and the
    fast decode under each engine's own ``_decode_schedule`` at the
    narrowest and widest width (the control: it threads ``tp`` un-pinned).
    The TP width takes the batch's place as the key; the batch is fixed."""
    cfg, params = _cfg_params(arch, device, cfg, params)
    traces: Dict[str, Dict[int, Log]] = {k: {} for k in INVARIANT_KINDS + ("decode_fast",)}
    for t in tps:
        engine = build_engine(cfg, params, tp=t)
        if t == tps[0]:
            warm_up(engine, batch)
        traces["verify"][t] = trace_verify(engine, batch)
        traces["prefill_chunk"][t] = trace_prefill_chunk(engine, batch)
        traces["decode_invariant"][t] = trace_decode(engine, batch, INVARIANT_SCHEDULE)
        if t in (min(tps), max(tps)):
            traces["decode_fast"][t] = trace_decode(engine, batch,
                                                    engine._decode_schedule(batch))
    return ArchTraces(arch, cfg, traces, _canon(traces, batch), batch=batch)


def prove_mesh(tr: ArchTraces) -> tuple:
    """Commit kinds identical across TP widths (equal batch keys: every
    affine allowance degenerates to equality); the un-pinned fast path not."""
    findings = []
    batch = tr.batch
    cert: dict = {"arch": tr.arch, "config": tr.cfg.name, "batch": batch, "kinds": {}}
    for kind in INVARIANT_KINDS:
        per = tr.canon[kind]
        tps = sorted(per)
        ref = per[tps[0]]
        invariant = True
        for t in tps[1:]:
            div = compare_canonical(ref, per[t], batch, batch)
            if div is None:
                continue
            invariant = False
            line, a, bb = div
            findings.append(Finding(
                pass_name="invariance", rule="mesh-variant-commit-path",
                where=f"trace::{tr.arch}::{kind}", arch=tr.arch,
                message=(f"{kind} program differs between TP {tps[0]} and {t} at "
                         f"canonical line {line}:\n      TP={tps[0]}: {a}\n"
                         f"      TP={t}: {bb}\n    the commit path must replay "
                         "under the canonical mesh-reduction schedule whatever "
                         "the fast path's mesh")))
        cert["kinds"][kind] = {"tps": tps, "invariant": invariant,
                               "canonical_lines": len(ref.splitlines())}
    fast = tr.canon["decode_fast"]
    t0, t1 = sorted(fast)[:2]
    control_ok = compare_canonical(fast[t0], fast[t1], batch, batch) is not None
    cert["negative_control"] = {
        "kind": "decode_fast", "tps": [t0, t1], "schedules_differ": control_ok,
        "kernels": {t: kernel_summary(tr.traces["decode_fast"][t]) for t in (t0, t1)},
    }
    if not control_ok:
        findings.append(Finding(
            pass_name="invariance", rule="prover-self-check",
            where=f"trace::{tr.arch}::decode_fast", arch=tr.arch,
            message=(f"fast-path decode at TP={t0} and TP={t1} canonicalized "
                     "identically: the canonicalizer cannot see the TP reduction "
                     "decomposition, so the mesh certificates above are vacuous")))
    return findings, cert


def run_mesh_pass(tps=MESH_TPS, arches=MESH_ARCHES, batch: int = MESH_BATCH, *,
                  device) -> tuple:
    """Record and prove TP invariance (certificates keyed ``mesh::<arch>``)."""
    findings, certs = [], {}
    for arch in arches:
        f, cert = prove_mesh(trace_arch_mesh(arch, tps, batch, device=device))
        findings.extend(f)
        certs[f"mesh::{arch}"] = cert
    return findings, certs


def run_pass(batches=BATCHES, arches=None, *, device, cfg: Optional[ModelConfig] = None,
             params: Optional[Dict] = None) -> tuple:
    """Record and prove every arch class (or ``arches``) on ``device``.

    Returns ``(findings, certificates, arch_traces)``; the traces feed the
    hazard pass, so each program is recorded once.  ``cfg`` and ``params``
    replace the smoke config and weights (with a single arch)."""
    arches = tuple(arches or ARCH_CLASSES)
    assert cfg is None or len(arches) == 1, "a caller's config is one arch class"
    findings, certs, all_traces = [], {}, []
    for arch in arches:
        tr = trace_arch(arch, batches, device=device, cfg=cfg, params=params)
        all_traces.append(tr)
        f, cert = prove(tr)
        findings.extend(f)
        certs[arch] = cert
    return findings, certs, all_traces
