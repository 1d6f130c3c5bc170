"""The port's determinism-contract checker (``repro_torch.analysis``).

* Seeded violations under ``tests/torch_analysis_fixtures/``: the checker
  must flag every one with its rule (a checker that stops firing is worse
  than none), by its passes and by the CLI's fixture mode.
* The port's own tree comes out clean modulo the justified allowlist, and
  the three faults the reference's taint pass found in the port before it
  had a checker (two unannotated commit roots, ``Engine._note_t0``'s
  unresolved schedule) are gone without an allowlist entry.
* The recorder: one kernel node per wrapper call with its geometry and none
  of the plain version's aten ops, liveness, attribution, the folded
  per-position loop; the canonical-form comparison.
* The attention class is proved at batches 13, 17 and 19 and at TP widths
  1, 2 and 4 with both negative controls (slow tier: the other three arch
  classes and the jamba mesh pass, as ``tests/test_analysis.py``'s full
  prover).
* Parity with the reference (skipped without JAX): the allowlist parsers,
  ``compare_canonical`` and ``_batch_affine``, the taint pass on the
  reference's fixture, and the attention certificate's verdicts.
* ``import repro_torch.analysis`` with JAX and the JAX package unimportable.
"""

from __future__ import annotations

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.analysis import check, hazards, invariance, kernel_lint, taint
from repro_torch.analysis import trace_utils as tu
from repro_torch.analysis.report import (
    AllowEntry, AllowlistError, Finding, Report, _parse_toml_allow, load_allowlist,
)
from repro_torch.kernels import ops, recording
from repro_torch.kernels.gemm_batch_invariant import gemm_batch_invariant

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_analysis_fixtures"
ALLOWLIST = REPO / "src/repro_torch/analysis/allowlist.toml"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_engine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(findings) -> set:
    return {f.rule for f in findings}


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"fx_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# seeded violations: every fixture must be flagged with its rule

SOURCE_FIXTURES = {
    "fixture_atomic_commit.cu": ("atomic-in-commit-kernel", "gemv_atomic_kernel"),
    "fixture_bf16_accum.cu": ("accum-dtype", "row_sum_kernel"),
    "fixture_adaptive_tile.cu": ("adaptive-block-size", "launch_gemm_adaptive"),
}
TRACE_FIXTURES = {
    "fixture_scatter_hazard.py": ("scatter-add-overlap", "overlapping_writeback"),
    "fixture_batch_sum.py": ("batch-extent-reduction", "center_by_batch"),
}
ALL_FIXTURES = sorted(list(SOURCE_FIXTURES) + list(TRACE_FIXTURES)
                      + ["fixture_splitk_commit.py"])


@pytest.mark.parametrize("name", sorted(SOURCE_FIXTURES))
def test_kernel_fixture_flagged(name):
    rule, fn = SOURCE_FIXTURES[name]
    fs = kernel_lint.run_pass(REPO, files=[FIXTURES / name])
    assert [(f.rule, f.where) for f in fs] == [
        (rule, f"tests/torch_analysis_fixtures/{name}::{fn}")], fs


@pytest.mark.parametrize("name", sorted(TRACE_FIXTURES))
def test_trace_fixture_flagged(name):
    rule, fn = TRACE_FIXTURES[name]
    log, batch = _load(FIXTURES / name).analysis_trace()
    fs = hazards.scan_trace(tu.dce(log), batch, arch="fixture", kind=name)
    assert rule in _rules(fs), fs
    # attributed to the fixture's own function, by the port's own means
    assert any(f.where == f"tests/torch_analysis_fixtures/{name}::{fn}"
               for f in fs if f.rule == rule), fs


def test_taint_fixture_flagged():
    fs = taint.scan_files([FIXTURES / "fixture_splitk_commit.py"], REPO,
                          expected_roots=frozenset())
    assert "fast-schedule-on-commit-path" in _rules(fs)
    assert "unresolved-schedule" in _rules(fs)
    # the threaded-parameter helper is fine: its binding is checked upstream
    assert not any(f.where.endswith("::_project") for f in fs)


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_fixture_mode_cli_exits_nonzero(name, capsys):
    assert check.main(["--paths", str(FIXTURES / name)]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_kernel_lint_exemptions():
    """``// det: fastpath`` exempts a file on its first line and a function
    on the line above its header; the split-K GEMM and the fast paged pair
    are exempt, the commit kernels linted."""
    csrc = REPO / kernel_lint.CSRC
    assert kernel_lint.lint_file(csrc / "gemm_splitk.cu", "x") == []
    raw = (csrc / "paged_attention.cu").read_text()
    fns = {f.name: f for f in kernel_lint.parse_functions(raw, kernel_lint.strip_comments(raw))}
    assert fns["paged_split_kernel"].fastpath and fns["paged_merge_kernel"].fastpath
    assert not fns["paged_attention_kernel"].fastpath
    src = (FIXTURES / "fixture_atomic_commit.cu").read_text()
    marked = src.replace("__global__ void gemv_atomic_kernel",
                         "// det: fastpath\n__global__ void gemv_atomic_kernel")
    fns = kernel_lint.parse_functions(marked, kernel_lint.strip_comments(marked))
    assert [f.name for f in fns if f.fastpath] == ["gemv_atomic_kernel"]


def test_kernel_lint_rules_on_snippets(tmp_path):
    """The rules the fixtures leave out: a non-f32 MMA accumulator, a step
    read from gridDim or a runtime count, a tile clamped by M, red. PTX."""
    src = tmp_path / "k.cu"
    src.write_text(
        "__global__ void k(float* y, int n, int rows) {\n"
        '  asm volatile("wgmma.mma_async.sync.aligned.m64n32k16.f16.bf16.bf16 {};");\n'
        "  for (int i = 0; i < n; i += gridDim.x) y[i] = 0.f;\n"
        "  for (int i = 0; i < n; i += rows) y[i] = 1.f;\n"
        '  asm volatile("red.global.add.f32 [%0], %1;" :: "l"(y), "f"(1.f));\n'
        "}\n"
        "int pick(int M) { int tile = min(M, 64); return tile; }\n")
    fs = kernel_lint.run_pass(tmp_path, files=[src])
    rules = sorted(f.rule for f in fs)
    assert rules == ["accum-dtype", "adaptive-block-size", "atomic-in-commit-kernel",
                     "grid-reduction-extent", "grid-reduction-extent",
                     "grid-reduction-extent"], [f.format() for f in fs]


# ---------------------------------------------------------------------------
# the port's own tree


def test_repo_taint_clean():
    assert taint.run_pass(REPO) == []


@pytest.mark.parametrize("key", [
    ("unannotated-commit-root", "src/repro_torch/core/verifier.py::make_verify_body"),
    ("unannotated-commit-root",
     "src/repro_torch/serving/engine.py::Engine._prefill_chunk_body"),
    ("unresolved-schedule", "src/repro_torch/serving/engine.py::Engine._note_t0"),
])
def test_earlier_taint_faults_repaired(key):
    """The three findings the reference's taint pass reported on the port
    before it had a checker are gone, and no allowlist entry hides them."""
    assert key not in {(f.rule, f.where) for f in taint.run_pass(REPO)}
    assert key[1] not in {e.where for e in load_allowlist(ALLOWLIST)}


def test_every_expected_root_annotated():
    regs = []
    for scope in taint.DEFAULT_SCOPE:
        for p in sorted((REPO / scope).glob("*.py")):
            regs.extend(taint._collect(p, str(p.relative_to(REPO)))[0])
    roots = {f.where for f in regs if f.is_root}
    assert taint.EXPECTED_ROOTS <= roots


def test_commit_roots_annotated(tmp_path):
    """Deleting a ``# det: commit-path`` annotation is itself a finding."""
    for rel in taint.DEFAULT_SCOPE:
        shutil.copytree(REPO / rel, tmp_path / rel)
    vf = tmp_path / "src/repro_torch/core/verifier.py"
    vf.write_text(vf.read_text().replace("# det: commit-path\n", "", 1))
    assert "unannotated-commit-root" in _rules(taint.run_pass(tmp_path))


def test_repo_kernel_lint_clean_modulo_allowlist():
    report = Report(allowlist=load_allowlist(ALLOWLIST))
    report.extend(kernel_lint.run_pass(REPO))
    assert report.ok, report.format()
    assert [f.rule for f in report.suppressed] == ["grid-reduction-extent"]


def test_cli_source_passes_clean(capsys):
    assert check.main(["--skip-trace"]) == 0
    assert "OK" in capsys.readouterr().out


def test_cli_cuda_device_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check.main(["--device", "cuda", "--no-cache"])


# ---------------------------------------------------------------------------
# allowlist mechanics


def test_allowlist_requires_justification():
    with pytest.raises(AllowlistError, match="justification"):
        _parse_toml_allow('[[allow]]\npass = "hazards"\nrule = "x"\nwhere = "y"\n', "t")
    with pytest.raises(AllowlistError, match="empty justification"):
        _parse_toml_allow('[[allow]]\npass = "hazards"\nrule = "x"\nwhere = "y"\n'
                          'justification = "  "\n', "t")


def test_allowlist_stale_entry_flagged():
    report = Report(allowlist=[AllowEntry(pass_name="hazards", rule="gone",
                                          where="nowhere.py::f",
                                          justification="used to matter")])
    report.finish(check_stale=True)
    assert [f.rule for f in report.findings] == ["stale-entry"]


def test_allowlist_suppression_is_exact_key_match():
    report = Report(allowlist=[AllowEntry(pass_name="kernel_lint", rule="accum-dtype",
                                          where="a.py::f", justification="j")])
    report.add(Finding("kernel_lint", "accum-dtype", "a.py::f", "m"))
    report.add(Finding("kernel_lint", "accum-dtype", "a.py::g", "m"))
    assert len(report.suppressed) == 1 and len(report.findings) == 1


def test_repo_allowlist_loads_and_is_justified():
    entries = load_allowlist(ALLOWLIST)
    assert len(entries) == 8
    for e in entries:
        assert len(e.justification) > 100
        path = e.where.split("::")[0]
        assert (REPO / path).exists(), path
        assert path.startswith("src/repro_torch/")


# ---------------------------------------------------------------------------
# the recorder


def test_kernel_call_is_one_node_with_geometry():
    """A wrapper call on CPU tensors is one kernel node with its geometry;
    the plain version's aten ops are not in the log, and the hook is off
    again afterwards (the serving path reads one global)."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((5, 64), generator=g), torch.randn((64, 32), generator=g)
    log, out = tu.record(lambda: gemm_batch_invariant(x, w, chunks=4))
    assert [n.op for n in log.nodes] == ["kernel.gemm_batch_invariant"]
    assert log.nodes[0].geometry == {"chunks": 4}
    assert recording.active is None
    assert torch.equal(out, gemm_batch_invariant(x, w, chunks=4))
    from repro_torch.core.determinism import FAST_PATH_POLICY

    log, _ = tu.record(ops.matmul, x, w, FAST_PATH_POLICY.schedule_for(3))
    names = [n.op for n in log.nodes if n.kernel]
    assert names == ["kernel.gemm_splitk"]
    assert log.nodes[[n.op for n in log.nodes].index(names[0])].geometry == {
        "splits": 8, "combine_dtype": "bfloat16", "tp_shards": 1, "tp_pinned": False}


def test_dce_keeps_outputs_and_external_writes():
    pool = torch.zeros(4, 3)

    def step(x):
        dead = (x * 2).sum()  # noqa: F841  (aux statistics nobody reads)
        pool[torch.tensor([1])] = x[:1]
        return x + 1

    log, _ = tu.record(step, torch.ones(2, 3))
    live = tu.dce(log)
    names = [n.name for n in live.nodes]
    assert "index_put_" in names and "add" in names
    assert "sum" not in names and "mul" not in names
    assert all(n.where.endswith("test_torch_analysis.py::test_dce_keeps_outputs_and_"
                                "external_writes.step") for n in live.nodes)


def test_recorded_loop_folds():
    """A ``recording.steps`` loop canonicalizes as one body and a trip
    count, so its programs at two lengths compare batch-affine; the same
    loop over ``range`` does not."""

    def prog(x, stepper):
        outs = []
        s = torch.zeros_like(x[:, 0])
        for t in stepper(x.shape[1]):
            s = s * 0.5 + x[:, t]
            outs.append(s)
        return torch.stack(outs, dim=1)

    def canon(T, stepper):
        log, _ = tu.record(prog, torch.ones(2, T), stepper)
        return tu.canonicalize(tu.dce(log), T)

    assert "loop(trips=13)" in canon(13, recording.steps)
    assert tu.compare_canonical(canon(13, recording.steps), canon(17, recording.steps),
                                13, 17) is None
    assert tu.compare_canonical(canon(13, range), canon(17, range), 13, 17) is not None


def test_tf32_rule_sees_the_switch():
    x = torch.randn(4, 8)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            log, _ = tu.record(torch.mm, x, x.t())
            fs = hazards.scan_trace(log, 13, arch="t", kind="t")
            assert ("tf32-enabled" in _rules(fs)) is flag
            assert "library-contraction" in _rules(fs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_compare_affine_batch_dims_match():
    a = "x = foo[dim=104] (13, 8) out\ny = bar 1.5"
    b = "x = foo[dim=136] (17, 8) out\ny = bar 1.5"
    assert tu.compare_canonical(a, b, 13, 17) is None
    assert tu.compare_canonical("pad 16", "pad 20", 13, 17) is None
    assert tu.compare_canonical("slice 12", "slice 16", 13, 17) is None


def test_compare_rejects_schedule_change():
    assert tu.compare_canonical("chunk 64", "chunk 128", 13, 17) is not None
    assert tu.compare_canonical("splits=4", "splits=2", 13, 17) is not None
    assert tu.compare_canonical("v 17", "v 13", 13, 17) is not None
    assert tu.compare_canonical("scale 0.0048", "scale 0.0036", 13, 17) is not None
    idx, la, lb = tu.compare_canonical("same\nleft\nsame2", "same\nright\nsame2", 13, 17)
    assert idx == 1 and la == "left" and lb == "right"


# ---------------------------------------------------------------------------
# the prover: the attention class in the default tier


@pytest.fixture(scope="module")
def attention_traces():
    findings, certs, traces = invariance.run_pass(arches=("attention",), device="cpu")
    return findings, certs, traces


def test_attention_class_invariant(attention_traces):
    findings, certs, _ = attention_traces
    assert findings == [], [f.format() for f in findings]
    cert = certs["attention"]
    for kind in invariance.INVARIANT_KINDS:
        assert cert["kinds"][kind]["invariant"] is True
        assert cert["kinds"][kind]["batches"] == list(invariance.BATCHES)
        # every commit GEMM is the batch-invariant kernel at the pinned tree
        kernels = cert["kinds"][kind]["kernels"]
        assert not any(k.startswith(("gemm_splitk", "paged_attention_fast")) for k in kernels)
        assert any(k == "gemm_batch_invariant(chunks=4)" for k in kernels)
    control = cert["negative_control"]
    assert control["schedules_differ"] is True
    assert any("splits=4" in k for k in control["kernels"][13])
    assert any("splits=2" in k for k in control["kernels"][17])


def test_attention_hazards_clean_modulo_allowlist(attention_traces):
    report = Report(allowlist=load_allowlist(ALLOWLIST))
    report.extend(hazards.run_pass(attention_traces[2]))
    assert report.ok, report.format()
    assert {f.rule for f in report.suppressed} == {"scatter-set-overlap",
                                                   "library-contraction"}


def test_seeded_tf32_trace_flagged(attention_traces):
    engine = invariance.build_engine(attention_traces[2][0].cfg,
                                     invariance.smoke_params(attention_traces[2][0].cfg, "cpu"))
    log = invariance.trace_verify(engine, 13, tf32=True)
    assert "tf32-enabled" in _rules(hazards.scan_trace(log, 13, arch="a", kind="verify"))
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_attention_mesh_invariant():
    findings, certs = invariance.run_mesh_pass(arches=("attention",), device="cpu")
    assert findings == [], [f.format() for f in findings]
    cert = certs["mesh::attention"]
    for kind in invariance.INVARIANT_KINDS:
        assert cert["kinds"][kind] == {**cert["kinds"][kind], "tps": [1, 2, 4],
                                       "invariant": True}
    assert cert["negative_control"]["schedules_differ"] is True
    assert any("tp_shards=4" in k for k in cert["negative_control"]["kernels"][4])


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["ssm", "rwkv6", "jamba"])
def test_prover_certifies_arch_class(arch):
    findings, certs, traces = invariance.run_pass(arches=(arch,), device="cpu")
    assert findings == [], [f.format() for f in findings]
    for kind_cert in certs[arch]["kinds"].values():
        assert kind_cert["invariant"] is True
    assert certs[arch]["negative_control"]["schedules_differ"] is True
    report = Report(allowlist=load_allowlist(ALLOWLIST))
    report.extend(hazards.run_pass(traces))
    assert report.ok, report.format()


@pytest.mark.slow
def test_jamba_mesh_invariant():
    findings, certs = invariance.run_mesh_pass(arches=("jamba",), device="cpu")
    assert findings == [], [f.format() for f in findings]
    assert certs["mesh::jamba"]["negative_control"]["schedules_differ"] is True


@pytest.mark.slow
def test_cli_cpu_check_passes(tmp_path):
    assert check.main(["--device", "cpu", "--cache-dir", str(tmp_path)]) == 0
    # the second run reads the cache
    assert check.main(["--device", "cpu", "--cache-dir", str(tmp_path)]) == 0


# ---------------------------------------------------------------------------
# parity with the reference (the JAX package)


def test_allowlist_parsers_agree():
    pytest.importorskip("jax")
    from repro.analysis import report as ref_report

    path = REPO / "src/repro/analysis/allowlist.toml"
    ours = [(e.pass_name, e.rule, e.where, e.justification) for e in load_allowlist(path)]
    theirs = [(e.pass_name, e.rule, e.where, e.justification)
              for e in ref_report.load_allowlist(path)]
    assert ours == theirs and len(ours) == 6


_TOKENS = st.lists(st.integers(min_value=0, max_value=300), min_size=1, max_size=4)


@settings(max_examples=200, deadline=None)
@given(a=_TOKENS, b=_TOKENS, b1=st.integers(min_value=1, max_value=40),
       b2=st.integers(min_value=1, max_value=40))
def test_compare_canonical_agrees_with_reference(a, b, b1, b2):
    pytest.importorskip("jax")
    from repro.analysis import jaxpr_utils as ref

    la = "op " + " ".join(map(str, a)) + "\nend"
    lb = "op " + " ".join(map(str, b)) + "\nend"
    assert tu.compare_canonical(la, lb, b1, b2) == ref.compare_canonical(la, lb, b1, b2)
    for d in a:
        assert tu._batch_affine(d, b1) == ref._batch_affine(d, b1)


def test_taint_agrees_with_reference_on_its_fixture():
    pytest.importorskip("jax")
    from repro.analysis import taint as ref_taint

    fx = REPO / "tests/analysis_fixtures/fixture_splitk_commit.py"
    ours = {(f.rule, f.where) for f in taint.scan_files([fx], REPO, expected_roots=frozenset())}
    theirs = {(f.rule, f.where)
              for f in ref_taint.scan_files([fx], REPO, expected_roots=frozenset())}
    assert ours == theirs and ours


def test_attention_certificate_agrees_with_reference(attention_traces):
    pytest.importorskip("jax")
    from repro.analysis import invariance as ref_inv

    _, ref_certs, _ = ref_inv.run_pass(arches=("attention",))
    ours, theirs = attention_traces[1]["attention"], ref_certs["attention"]
    for kind in invariance.INVARIANT_KINDS:
        for key in ("batches", "invariant"):
            assert ours["kinds"][kind][key] == theirs["kinds"][kind][key], (kind, key)
    assert set(ours["kinds"]) == set(theirs["kinds"])
    for key in ("kind", "batches", "schedules_differ"):
        assert ours["negative_control"][key] == theirs["negative_control"][key]


# ---------------------------------------------------------------------------
# no JAX


def test_analysis_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.analysis\n"
            "from repro_torch.analysis import check, hazards, invariance, kernel_lint, "
            "taint, trace_utils, report\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                                        "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
