"""Schedule-taint pass: no fast-path schedule can reach the commit side.

The port's counterpart of ``repro.analysis.taint``, with the reference's
classification rules, over ``src/repro_torch/{core,serving,models}``.  An
AST dataflow check: nothing is imported.  Commit
roots are marked in source with a ``# det: commit-path`` comment on the
line above the ``def`` (above its decorators, if any); the checker keeps a
built-in list of functions that are *expected* to be roots — the places
that bind schedules for verify/prefill — so deleting an annotation is
itself a finding, not a silent hole.

From the roots, reachability is computed over a name-matched call graph
(conservative: a call edge goes to every known function with that bare
name, nested functions included).  Within commit-reachable code:

* any expression classified FAST — ``FAST_PATH_POLICY``, a
  ``.schedule_for(...)`` call, or a ``Schedule(...)`` literal with
  ``splits/kv_splits != 1`` or a sub-f32 combine dtype — is a finding
  (``fast-schedule-on-commit-path``);
* any ``schedule=`` keyword argument whose value cannot be shown SAFE
  (``VERIFY_SCHEDULE``/``INVARIANT_SCHEDULE``, a safe ternary over them, a
  parameter threaded from an already-checked caller) is a finding
  (``unresolved-schedule``).

Under ``Mode.LLM42``/``Mode.BATCH_INVARIANT`` both ternary arms in the
engine's prefill builders resolve SAFE; the fast path (``_decode_step``)
is deliberately NOT commit-reachable — nondeterministic decode is the
contract's licensed speculation, repaired by verification.  A TP width
leaking onto the commit side is the mesh invariance pass's to see
(``invariance.run_mesh_pass``), as in the reference.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.analysis.report import Finding

# classification lattice (join = max)
SAFE, PARAM, UNKNOWN, FAST = 0, 1, 2, 3
_LEVEL_NAME = {SAFE: "SAFE", PARAM: "PARAM", UNKNOWN: "UNKNOWN", FAST: "FAST"}

SAFE_NAMES = {"VERIFY_SCHEDULE", "INVARIANT_SCHEDULE"}
FAST_NAMES = {"FAST_PATH_POLICY"}
FAST_CALLS = {"schedule_for"}
_SAFE_DTYPES = {"float32", "f32"}

ANNOTATION_RE = re.compile(r"^\s*#\s*det:\s*commit-path\s*$")

# Functions that must carry the `# det: commit-path` annotation: every
# place that binds a schedule on the verify/commit side.  A missing
# annotation (e.g. dropped in a refactor) fails the check.
EXPECTED_ROOTS = frozenset(
    {
        "src/repro_torch/core/verifier.py::make_verify_body",
        "src/repro_torch/serving/engine.py::Engine._prefill_pass",
        "src/repro_torch/serving/engine.py::Engine._prefill_chunk_body",
        "src/repro_torch/serving/engine.py::Engine._prefill",
        "src/repro_torch/models/transformer.py::build_cross_cache",
    }
)

DEFAULT_SCOPE = (
    "src/repro_torch/core", "src/repro_torch/serving", "src/repro_torch/models",
)

#: ``core.determinism.Schedule``'s fields in positional order
SCHEDULE_FIELDS = (
    "splits", "kv_splits", "combine_dtype", "moe_no_drop", "tp_shards", "tp_pinned",
)


@dataclasses.dataclass
class FuncInfo:
    qualname: str  # "Class.method" / "outer.inner"
    file: str  # repo-relative path
    node: ast.AST
    parent: Optional["FuncInfo"]
    params: Dict[str, Optional[ast.expr]]  # name -> default expr (or None)
    assigns: Dict[str, List[ast.expr]]
    is_root: bool = False

    @property
    def where(self) -> str:
        return f"{self.file}::{self.qualname}"

    @property
    def bare(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


def _tail(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class _Collector(ast.NodeVisitor):
    def __init__(self, file: str, root_lines: set, registry: list):
        self.file = file
        self.root_lines = root_lines
        self.registry = registry
        self.stack: List[FuncInfo] = []
        self.class_stack: List[str] = []

    def _qual(self, name: str) -> str:
        parts = [f.bare for f in self.stack] or list(self.class_stack)
        if self.stack and self.class_stack:
            # methods: class prefix then function nesting
            parts = list(self.class_stack) + [f.bare.split(".")[-1] for f in self.stack]
        return ".".join(parts + [name]) if parts else name

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node) -> None:
        start = min(
            [node.lineno] + [d.lineno for d in node.decorator_list]
        )
        qual = self._qual(node.name)
        args = node.args
        params: Dict[str, Optional[ast.expr]] = {}
        pos = list(args.posonlyargs) + list(args.args)
        defaults = list(args.defaults)
        for i, a in enumerate(pos):
            di = i - (len(pos) - len(defaults))
            params[a.arg] = defaults[di] if di >= 0 else None
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            params[a.arg] = d
        if args.vararg:
            params[args.vararg.arg] = None
        if args.kwarg:
            params[args.kwarg.arg] = None
        info = FuncInfo(
            qualname=qual,
            file=self.file,
            node=node,
            parent=self.stack[-1] if self.stack else None,
            params=params,
            assigns={},
            is_root=(start - 1) in self.root_lines,
        )
        self.registry.append(info)
        self.stack.append(info)
        for child in node.body:
            self._scan_assigns(child, info)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _scan_assigns(self, node: ast.AST, info: FuncInfo) -> None:
        # flow-insensitive: record every assignment to a bare name in this
        # function's immediate body (conditionals included, nested defs not)
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        info.assigns.setdefault(tgt.id, []).append(sub.value)
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                if isinstance(sub.target, ast.Name):
                    info.assigns.setdefault(sub.target.id, []).append(sub.value)


def _collect(path: Path, rel: str) -> tuple[list[FuncInfo], list[int], set]:
    src = path.read_text()
    root_lines = {
        i for i, line in enumerate(src.splitlines(), start=1)
        if ANNOTATION_RE.match(line)
    }
    tree = ast.parse(src, filename=str(path))
    registry: list[FuncInfo] = []
    _Collector(rel, root_lines, registry).visit(tree)
    used = {
        min([f.node.lineno] + [d.lineno for d in f.node.decorator_list]) - 1
        for f in registry
        if f.is_root
    }
    dangling = sorted(root_lines - used)
    return registry, dangling, root_lines


class _Classifier:
    def __init__(self, by_bare: Dict[str, List[FuncInfo]]):
        self.by_bare = by_bare

    def classify(self, expr: ast.expr, scope: Optional[FuncInfo], seen=None) -> int:
        seen = seen or set()
        if isinstance(expr, (ast.Name, ast.Attribute)):
            tail = expr.id if isinstance(expr, ast.Name) else expr.attr
            if tail in SAFE_NAMES:
                return SAFE
            if tail in FAST_NAMES:
                return FAST
            if isinstance(expr, ast.Name):
                return self._resolve_name(expr.id, scope, seen)
            return UNKNOWN
        if isinstance(expr, ast.Call):
            tail = _tail(expr.func)
            if tail in FAST_CALLS:
                return FAST
            if tail == "Schedule":
                return self._classify_schedule_ctor(expr)
            return UNKNOWN
        if isinstance(expr, ast.IfExp):
            return max(
                self.classify(expr.body, scope, seen),
                self.classify(expr.orelse, scope, seen),
            )
        if isinstance(expr, (ast.Tuple, ast.List)) and expr.elts:
            return max(self.classify(e, scope, seen) for e in expr.elts)
        return UNKNOWN

    def _resolve_name(self, name: str, scope: Optional[FuncInfo], seen) -> int:
        s = scope
        while s is not None:
            key = (id(s), name)
            if key in seen:
                return UNKNOWN  # assignment cycle
            if name in s.assigns:
                seen = seen | {key}
                return max(
                    self.classify(v, s, seen) for v in s.assigns[name]
                )
            if name in s.params:
                default = s.params[name]
                if default is not None:
                    return max(PARAM, self.classify(default, s, seen))
                return PARAM
            s = s.parent
        return UNKNOWN

    def _classify_schedule_ctor(self, call: ast.Call) -> int:
        level = SAFE
        bound: Dict[str, ast.expr] = {}
        for i, a in enumerate(call.args):
            if i < len(SCHEDULE_FIELDS):
                bound[SCHEDULE_FIELDS[i]] = a
        for kw in call.keywords:
            if kw.arg:
                bound[kw.arg] = kw.value
        for field in ("splits", "kv_splits"):
            v = bound.get(field)
            if v is None:
                continue
            if isinstance(v, ast.Constant) and v.value == 1:
                continue
            return FAST
        v = bound.get("combine_dtype")
        if v is not None:
            tail = _tail(v) if isinstance(v, (ast.Name, ast.Attribute, ast.Call)) else None
            if isinstance(v, (ast.Name, ast.Attribute)):
                tail = v.id if isinstance(v, ast.Name) else v.attr
            if tail not in _SAFE_DTYPES:
                return FAST
        return level


def scan_files(
    files: List[Path], repo_root: Path, *, expected_roots=EXPECTED_ROOTS
) -> list[Finding]:
    findings: list[Finding] = []
    registry: list[FuncInfo] = []
    for path in files:
        rel = str(path.relative_to(repo_root)) if path.is_absolute() else str(path)
        try:
            file_funcs, dangling, _ = _collect(path, rel)
        except SyntaxError as e:
            findings.append(
                Finding(
                    pass_name="taint",
                    rule="unparseable",
                    where=rel,
                    message=f"cannot parse: {e}",
                )
            )
            continue
        registry.extend(file_funcs)
        for line in dangling:
            findings.append(
                Finding(
                    pass_name="taint",
                    rule="dangling-annotation",
                    where=f"{rel}::line{line}",
                    message=(
                        f"'# det: commit-path' at {rel}:{line} is not "
                        "attached to a function definition (it must sit on "
                        "the line above the def / its first decorator)"
                    ),
                )
            )

    by_where = {f.where: f for f in registry}
    for want in sorted(expected_roots):
        f = by_where.get(want)
        if f is None:
            continue  # function gone entirely: scope tests cover renames
        if not f.is_root:
            findings.append(
                Finding(
                    pass_name="taint",
                    rule="unannotated-commit-root",
                    where=want,
                    message=(
                        "this function binds schedules on the commit side "
                        "and must carry a '# det: commit-path' annotation "
                        "on the line above its definition"
                    ),
                )
            )

    by_bare: Dict[str, List[FuncInfo]] = {}
    for f in registry:
        by_bare.setdefault(f.bare, []).append(f)

    # commit-reachability over the name-matched call graph.  Nested
    # functions are visited as part of their enclosing body, so edges only
    # need to resolve outward calls.
    roots = [f for f in registry if f.is_root and f.parent is None]
    reachable: Dict[str, FuncInfo] = {}
    work = list(roots)
    while work:
        f = work.pop()
        if f.where in reachable:
            continue
        reachable[f.where] = f
        for sub in ast.walk(f.node):
            if not isinstance(sub, ast.Call):
                continue
            tail = _tail(sub.func)
            if not tail:
                continue
            for g in by_bare.get(tail, ()):
                if g.parent is None and g.where not in reachable:
                    work.append(g)

    classifier = _Classifier(by_bare)

    def innermost_scope(top: FuncInfo, node: ast.AST) -> FuncInfo:
        # find the innermost nested function containing `node`
        best = top
        lineno = getattr(node, "lineno", None)
        if lineno is None:
            return best
        for g in registry:
            if g.file != top.file:
                continue
            n = g.node
            if (
                g.where != top.where
                and g.qualname.startswith(top.qualname + ".")
                and n.lineno <= lineno <= (n.end_lineno or n.lineno)
                and n.lineno >= best.node.lineno
            ):
                best = g
        return best

    seen_lines: set = set()
    for f in reachable.values():
        for sub in ast.walk(f.node):
            if isinstance(sub, ast.Call):
                for kw in sub.keywords:
                    if kw.arg != "schedule":
                        continue
                    scope = innermost_scope(f, sub)
                    level = classifier.classify(kw.value, scope)
                    if level == FAST:
                        key = (f.file, kw.value.lineno, "fast")
                        if key in seen_lines:
                            continue
                        seen_lines.add(key)
                        findings.append(
                            Finding(
                                pass_name="taint",
                                rule="fast-schedule-on-commit-path",
                                where=f.where,
                                message=(
                                    f"line {kw.value.lineno}: schedule= "
                                    "argument classifies FAST on a "
                                    "commit-reachable path — the commit side "
                                    "must run VERIFY_SCHEDULE"
                                ),
                            )
                        )
                    elif level == UNKNOWN:
                        key = (f.file, kw.value.lineno, "unk")
                        if key in seen_lines:
                            continue
                        seen_lines.add(key)
                        findings.append(
                            Finding(
                                pass_name="taint",
                                rule="unresolved-schedule",
                                where=f.where,
                                message=(
                                    f"line {kw.value.lineno}: schedule= "
                                    "argument cannot be proven "
                                    "VERIFY/INVARIANT on a commit-reachable "
                                    "path — thread it from a checked "
                                    "binding or restructure"
                                ),
                            )
                        )
            elif isinstance(sub, (ast.Attribute, ast.Name)):
                tail = sub.id if isinstance(sub, ast.Name) else sub.attr
                if tail in FAST_NAMES or (
                    isinstance(sub, ast.Attribute) and sub.attr in FAST_CALLS
                ):
                    key = (f.file, sub.lineno, "fastref")
                    if key in seen_lines:
                        continue
                    seen_lines.add(key)
                    findings.append(
                        Finding(
                            pass_name="taint",
                            rule="fast-schedule-on-commit-path",
                            where=f.where,
                            message=(
                                f"line {sub.lineno}: reference to "
                                f"'{tail}' inside commit-reachable code — "
                                "fast-path reduction policies must not be "
                                "visible from the commit side"
                            ),
                        )
                    )
    return findings


def run_pass(repo_root: Path) -> list[Finding]:
    files: list[Path] = []
    for scope in DEFAULT_SCOPE:
        files.extend(sorted((repo_root / scope).glob("*.py")))
    return scan_files(files, repo_root)
