"""Findings, reports, and the justified allowlist.

The port's own copy of ``repro.analysis.report`` (the JAX package is not
imported).  A finding is keyed ``(pass, rule, where)`` where ``where`` is a
repo-relative ``path::function`` location.  The allowlist
(``analysis/allowlist.toml``) suppresses findings by exact key match; every
entry must carry a non-empty ``justification`` string, and entries that no
longer match anything are themselves reported (stale-entry) so the
exemption set cannot rot.

The TOML reader below is a deliberately tiny subset parser (array-of-tables
``[[allow]]`` with string values), the reference's: both packages read one
file into the same entries.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass
class Finding:
    """One contract violation (or prover failure) at a source location."""

    pass_name: str  # invariance | hazards | taint | kernel_lint | allowlist
    rule: str  # short rule id, e.g. "dot-default-precision"
    where: str  # repo-relative "path/to/file.py::function" (or module)
    message: str  # human diagnostic, includes line numbers where known
    arch: str = ""  # arch class for trace-derived findings ("" otherwise)

    def key(self) -> tuple[str, str, str]:
        return (self.pass_name, self.rule, self.where)

    def format(self) -> str:
        tag = f" [{self.arch}]" if self.arch else ""
        return f"{self.pass_name}/{self.rule}{tag} at {self.where}:\n    {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AllowEntry:
    pass_name: str
    rule: str
    where: str
    justification: str
    used: bool = False

    def matches(self, f: Finding) -> bool:
        return (self.pass_name, self.rule, self.where) == f.key()


class AllowlistError(ValueError):
    pass


def _parse_toml_allow(text: str, source: str) -> list[AllowEntry]:
    """Parse the ``[[allow]]`` subset of TOML used by allowlist.toml."""
    entries: list[AllowEntry] = []
    current: dict[str, str] | None = None

    def flush() -> None:
        nonlocal current
        if current is None:
            return
        missing = {"pass", "rule", "where", "justification"} - set(current)
        if missing:
            raise AllowlistError(
                f"{source}: [[allow]] entry missing keys {sorted(missing)}: {current}"
            )
        if not current["justification"].strip():
            raise AllowlistError(
                f"{source}: empty justification for "
                f"{current['pass']}/{current['rule']} at {current['where']} — "
                "every allowlist entry must say why the finding is safe"
            )
        entries.append(
            AllowEntry(
                pass_name=current["pass"],
                rule=current["rule"],
                where=current["where"],
                justification=current["justification"],
            )
        )
        current = None

    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[allow]]":
            flush()
            current = {}
            continue
        if line.startswith("["):
            raise AllowlistError(
                f"{source}:{lineno}: only [[allow]] tables are supported, got {line!r}"
            )
        if "=" not in line:
            raise AllowlistError(f"{source}:{lineno}: expected key = \"value\"")
        if current is None:
            raise AllowlistError(
                f"{source}:{lineno}: key outside an [[allow]] table"
            )
        key, _, val = line.partition("=")
        key = key.strip()
        val = val.strip()
        if not (len(val) >= 2 and val[0] == '"' and val[-1] == '"'):
            raise AllowlistError(
                f"{source}:{lineno}: value for {key!r} must be a double-quoted string"
            )
        body = val[1:-1]
        if '"' in body.replace('\\"', ""):
            raise AllowlistError(f"{source}:{lineno}: unescaped quote in value")
        current[key] = body.replace('\\"', '"')
    flush()
    return entries


def load_allowlist(path: Path) -> list[AllowEntry]:
    if not path.exists():
        return []
    return _parse_toml_allow(path.read_text(), str(path))


class Report:
    """Accumulates findings across passes and applies the allowlist."""

    def __init__(self, allowlist: list[AllowEntry] | None = None):
        self.allowlist = allowlist or []
        self.findings: list[Finding] = []  # surviving (not allowlisted)
        self.suppressed: list[Finding] = []
        self.certificates: dict = {}  # invariance-prover output, by arch

    def add(self, finding: Finding) -> None:
        for entry in self.allowlist:
            if entry.matches(finding):
                entry.used = True
                self.suppressed.append(finding)
                return
        self.findings.append(finding)

    def extend(self, findings: list[Finding]) -> None:
        for f in findings:
            self.add(f)

    def finish(self, *, check_stale: bool = True) -> None:
        """Flag allowlist entries that matched nothing (stale exemptions)."""
        if not check_stale:
            return
        for entry in self.allowlist:
            if not entry.used:
                self.add(
                    Finding(
                        pass_name="allowlist",
                        rule="stale-entry",
                        where=entry.where,
                        message=(
                            f"allowlist entry {entry.pass_name}/{entry.rule} at "
                            f"{entry.where} no longer matches any finding — "
                            "remove it (justification was: "
                            f"{entry.justification!r})"
                        ),
                    )
                )

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "certificates": self.certificates,
        }

    def write_json(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n")

    def format(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(f.format())
        if self.suppressed:
            lines.append(
                f"({len(self.suppressed)} finding(s) suppressed by allowlist)"
            )
        return "\n".join(lines)
