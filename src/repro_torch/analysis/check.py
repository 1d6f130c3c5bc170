"""Determinism-contract checker CLI: ``python -m repro_torch.analysis.check``.

Runs the four passes over the port and exits nonzero on any unexplained
finding:

1. invariance  — records the engine's verify, prefill-chunk and decode
   bodies at several batch sizes per arch class, on ``--device``, and
   proves the commit-path programs batch-invariant; then across TP widths
   1, 2 and 4 (``invariance.run_mesh_pass``);
2. hazards     — lints the recorded programs for nondeterminism-prone ops
   (overlapping scatters, batch-extent library reductions, library
   contractions, fast kernels, narrow accumulators, TF32, host reads);
3. taint       — AST dataflow proving no fast-path schedule reaches
   commit-annotated code;
4. kernel_lint — CUDA source rules over ``kernels/csrc`` (literal
   reduction partitions, no shape-chosen tiles, f32 accumulators, no
   atomics).

``--device`` defaults to ``cuda`` and raises without a card (it never falls
back); ``--device cpu`` records the same programs through the kernels'
plain versions.  Findings are suppressed only by a justified entry in
``allowlist.toml``; stale entries are findings themselves.  The trace passes
(1 + 2) are cached in ``.analysis_cache/`` as ``torch-<key>.json``, keyed on
a hash of ``src/repro_torch`` and the device.

Fixture mode (``--paths f.py f.cu ...``) runs only the source passes on the
given files, plus the hazard pass on any module exposing ``analysis_trace()
-> (log, batch)`` (``trace_utils.record``): the seeded violations of
``tests/torch_analysis_fixtures/``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import hazards, invariance, kernel_lint, taint
from repro_torch.analysis.report import Finding, Report, load_allowlist

CACHE_VERSION = 1  # bump to invalidate cached trace-pass results


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def src_hash(root: Path, device: str) -> str:
    h = hashlib.sha256()
    pkg = root / "src" / "repro_torch"
    files = sorted(p for ext in ("*.py", "*.cu", "*.cuh", "*.toml") for p in pkg.rglob(ext))
    for p in files:
        h.update(str(p.relative_to(root)).encode())
        h.update(b"\0")
        h.update(p.read_bytes())
        h.update(b"\0")
    h.update(f"v{CACHE_VERSION}:{device}".encode())
    return h.hexdigest()


def _findings_from_json(items: list) -> List[Finding]:
    return [Finding(pass_name=d["pass_name"], rule=d["rule"], where=d["where"],
                    message=d["message"], arch=d.get("arch", ""))
            for d in items]


def run_trace_passes(root: Path, cache_dir: Optional[Path], *, device: str,
                     use_cache: bool) -> tuple:
    """Invariance + hazards (+ the mesh pass) on ``device``, with results
    cached on the source hash and the device."""
    key = src_hash(root, device)
    cache_file = (cache_dir or root / ".analysis_cache") / f"torch-{key[:16]}.json"
    if use_cache and cache_file.exists():
        try:
            data = json.loads(cache_file.read_text())
            if data.get("src_hash") == key:
                print(f"[check] trace cache hit ({cache_file.name})")
                return _findings_from_json(data["findings"]), data["certs"]
        except (json.JSONDecodeError, KeyError):
            pass  # corrupt cache: record again

    print(f"[check] recording engine steps on {device} (no cache hit)")
    inv_findings, certs, arch_traces = invariance.run_pass(device=device)
    hz_findings = hazards.run_pass(arch_traces)
    mesh_findings, mesh_certs = invariance.run_mesh_pass(device=device)
    certs.update(mesh_certs)
    findings = inv_findings + hz_findings + mesh_findings
    certs = json.loads(json.dumps(certs))  # int keys -> str, as read back
    if use_cache:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        cache_file.write_text(json.dumps({
            "src_hash": key, "device": device,
            "findings": [f.to_dict() for f in findings], "certs": certs,
        }, indent=1))
    return findings, certs


def _load_fixture_trace(path: Path):
    spec = importlib.util.spec_from_file_location(f"_fixture_{path.stem}", path)
    if spec is None or spec.loader is None:
        return None
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fn = getattr(module, "analysis_trace", None)
    return fn() if callable(fn) else None


def run_fixture_mode(paths: List[Path], root: Path) -> Report:
    from repro_torch.analysis.trace_utils import dce

    report = Report(allowlist=[])
    py = [p for p in paths if p.suffix == ".py"]
    report.extend(taint.scan_files(py, root, expected_roots=frozenset()))
    report.extend(kernel_lint.run_pass(root, files=paths))
    for p in py:
        if "analysis_trace" not in p.read_text():
            continue
        traced = _load_fixture_trace(p)
        if traced is None:
            continue
        log, batch = traced
        report.extend(hazards.scan_trace(dce(log), batch, arch="fixture", kind=p.stem))
    report.finish(check_stale=False)
    return report


def _resolve_device(name: str) -> str:
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device visible (pass --device cpu "
                           "to record the plain versions' programs)")
    return name


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.check",
                                 description="LLM-42 determinism-contract checker (port)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine's steps are recorded (default cuda)")
    ap.add_argument("--json", type=Path, default=None, help="write a JSON report here")
    ap.add_argument("--no-cache", action="store_true", help="always record again")
    ap.add_argument("--cache-dir", type=Path, default=None, help="trace cache directory")
    ap.add_argument("--allowlist", type=Path, default=None,
                    help="allowlist TOML (default: src/repro_torch/analysis/allowlist.toml)")
    ap.add_argument("--skip-trace", action="store_true",
                    help="source passes only (taint + kernel lint); no recording")
    ap.add_argument("--paths", type=Path, nargs="+", default=None,
                    help="fixture mode: lint only these files (.py, .cu, .cuh)")
    args = ap.parse_args(argv)
    root = repo_root()

    if args.paths:
        report = run_fixture_mode([p.resolve() for p in args.paths], root)
    else:
        allow_path = args.allowlist or root / "src/repro_torch/analysis/allowlist.toml"
        report = Report(allowlist=load_allowlist(allow_path))
        report.extend(taint.run_pass(root))
        report.extend(kernel_lint.run_pass(root))
        if not args.skip_trace:
            trace_findings, certs = run_trace_passes(
                root, args.cache_dir, device=_resolve_device(args.device),
                use_cache=not args.no_cache)
            report.extend(trace_findings)
            report.certificates = certs
            for arch, cert in sorted(certs.items()):
                kinds = {k: v["invariant"] for k, v in cert["kinds"].items()}
                print(f"[check] invariance {arch}: {kinds} control differs: "
                      f"{cert['negative_control']['schedules_differ']}")
        # trace-pass allowlist entries look stale when recording is skipped
        report.finish(check_stale=not args.skip_trace)

    out = report.format()
    if out:
        print(out)
    print(f"[check] {'OK' if report.ok else 'FAIL'}: {len(report.findings)} finding(s)")
    if args.json:
        report.write_json(args.json)
        print(f"[check] report written to {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
