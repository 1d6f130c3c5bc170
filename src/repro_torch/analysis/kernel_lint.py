"""CUDA kernel lint: the universal-schedule rules, checked in source.

The port's counterpart of ``repro.analysis.kernel_lint``, which lints the
Pallas sources; this pass lints ``src/repro_torch/kernels/csrc/*.cu`` and
``*.cuh`` (comments stripped, line numbers kept).  The batch-invariant
kernel contract (paper §2.3): a commit kernel's reduction geometry is
pinned by literals, never derived from the inputs' shapes or the card.
The reference's rules, mapped to CUDA:

* ``grid-reduction-extent``  — a commit function's reduction partition or
  loop step is not a ``constexpr`` / ``#define`` literal: device code that
  reads ``gridDim``, ``%smid`` / ``%nsmid`` or a clock, host code that reads
  the SM count, or a ``for`` step that is neither a literal, a
  literal-derived constant, a template parameter nor ``blockDim`` (a
  runtime count may bound a loop, its trip count, but not step it).
* ``adaptive-block-size``    — a tile, K step or CTA partition chosen by M,
  B, a length or a ``min`` / ``max`` over them; this covers a launcher
  ``if`` / ``switch`` / ``?:`` on such a count that picks between launches
  or template instantiations (the reference's ``shape-branch-in-kernel``
  too: a compiled reduction structure chosen by shape).
* ``accum-dtype``            — a commit accumulator narrower than ``float``
  (a ``__nv_bfloat16`` / ``__half`` variable that is added into), or a
  ``wgmma`` / ``mma`` whose accumulator type is not ``.f32`` (``.s32`` for
  integer products).
* ``atomic-in-commit-kernel`` — ``atomic*`` calls or PTX ``red.`` /
  ``atom.`` in commit code: the order of the combine would follow the
  hardware's scheduling (the port's ground rule in ``ROADMAP.md``).

A file whose first line is ``// det: fastpath``, or a function with that
line directly above its header (above its ``template`` line, if any), is
exempt: it implements the licensed fast path (split-K, kv-split
flash-decode), whose schedules the taint pass proves unreachable from the
commit side.  Findings are keyed ``path::function``.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.analysis.report import Finding

FASTPATH_RE = re.compile(r"^\s*//\s*det:\s*fastpath\s*$")
CSRC = "src/repro_torch/kernels/csrc"

#: names a launch count takes in the sources: rows, batch, lengths
BATCH_NAMES = frozenset({
    "M", "B", "T", "S", "batch", "rows", "nrows", "num_rows", "n_rows", "len",
    "lens", "length", "lengths", "seq_len", "ctx", "ctx_len", "nctx",
})
#: types narrower than f32 that an accumulator must not have
NARROW_TYPES = ("__nv_bfloat16", "__nv_bfloat162", "nv_bfloat16", "__half",
                "__half2", "half", "half2", "__nv_fp8_e4m3", "__nv_fp8_e5m2")
_CONTROL = frozenset({"if", "for", "while", "switch", "catch", "return", "sizeof",
                      "decltype", "__launch_bounds__", "__cluster_dims__",
                      "alignas", "__align__", "defined"})
#: identifiers a loop step may read besides literals and constants
_STEP_OK = frozenset({"blockDim", "warpSize", "sizeof", "int", "unsigned",
                      "long", "size_t", "x", "y", "z"})
_TILE_NAME = re.compile(r"(?i)(tile|block|^b[mnk]$|step|chunk|split|cluster|stage|^kt$)")
_IDENT = re.compile(r"[A-Za-z_]\w*")
_NUM = re.compile(r"^(0[xX][0-9a-fA-F]+|\d+\.?\d*(e[+-]?\d+)?)[uUlLfF]*$")


def strip_comments(text: str) -> str:
    """``text`` without ``//`` and ``/* */`` comments, each comment replaced
    by its own newlines so that line numbers stay where they were; string
    literals (PTX in ``asm``) are kept."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("\n" * text.count("\n", i, j))
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


@dataclasses.dataclass
class Function:
    """One function definition of a CUDA source (bodies of lambdas and
    structs' methods nested in it belong to it)."""

    name: str
    line: int  # 1-based line of the header's first line
    header: str
    body: str
    body_line: int  # 1-based line of the body's opening brace
    fastpath: bool

    @property
    def device(self) -> bool:
        return "__global__" in self.header or "__device__" in self.header

    def template_params(self) -> Set[str]:
        m = re.search(r"template\s*<(.*?)>", self.header, re.S)
        if not m:
            return set()
        return {p.split()[-1].split("=")[0] for p in m.group(1).split(",") if p.split()}


def _function_name(header: str) -> Optional[str]:
    """The defined function's name if ``header`` (the text before a ``{``)
    is a function header, else None."""
    h = re.sub(r"\b(const|noexcept|override|mutable)\s*$", "", header.rstrip()).rstrip()
    if not h.endswith(")"):
        return None
    depth, i = 0, len(h) - 1
    while i >= 0:
        depth += {")": 1, "(": -1}.get(h[i], 0)
        if depth == 0:
            break
        i -= 1
    m = re.search(r"([A-Za-z_]\w*)\s*$", h[:i])
    if not m or m.group(1) in _CONTROL:
        return None
    before = h[:m.start()].rstrip()
    if before.endswith(("=", "return", ",", "(")) or "#define" in h:
        return None
    return m.group(1)


def parse_functions(raw: str, text: str) -> List[Function]:
    """Function definitions of ``text`` (comment-stripped ``raw``), outermost
    only; a ``// det: fastpath`` line of ``raw`` directly above a header
    marks its function."""
    raw_lines = raw.splitlines()
    funcs: List[Function] = []
    stack: List[Optional[int]] = []  # per open brace: index into funcs or None
    seg_start = 0
    in_func = 0
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            i = j + 1
            continue
        if c == "#" and (i == 0 or text[i - 1] == "\n"):
            # a preprocessor line (and its continuations) is no header part
            j = i
            while True:
                k = text.find("\n", j)
                if k < 0 or text[k - 1] != "\\":
                    break
                j = k + 1
            i = n if k < 0 else k
            seg_start = i
            continue
        if c == "{":
            name = None if in_func else _function_name(text[seg_start:i])
            if name is not None:
                lead = len(text[seg_start:i]) - len(text[seg_start:i].lstrip())
                start = seg_start + lead
                line = text.count("\n", 0, start) + 1
                above = raw_lines[line - 2] if line >= 2 else ""
                funcs.append(Function(name, line, text[start:i], "", text.count("\n", 0, i) + 1,
                                      bool(FASTPATH_RE.match(above))))
                funcs[-1]._open = i  # type: ignore[attr-defined]
                stack.append(len(funcs) - 1)
                in_func += 1
            else:
                stack.append(None)
            seg_start = i + 1
        elif c == "}":
            top = stack.pop() if stack else None
            if top is not None:
                f = funcs[top]
                f.body = text[f._open:i + 1]  # type: ignore[attr-defined]
                in_func -= 1
            seg_start = i + 1
        elif c == ";":
            seg_start = i + 1
        i += 1
    return funcs


def _constants(text: str) -> Dict[str, str]:
    """``#define NAME value``, ``constexpr ... NAME = value`` and ``const
    ... NAME = value`` bindings of ``text`` (last one wins)."""
    out: Dict[str, str] = {}
    for m in re.finditer(r"^\s*#\s*define\s+([A-Za-z_]\w*)[ \t]+([^\n]+)", text, re.M):
        out[m.group(1)] = m.group(2).strip()
    for m in re.finditer(r"\b(?:constexpr|const)\s+(?:static\s+)?[\w:<>]+\s+([A-Za-z_]\w*)\s*=\s*([^;{]+);",
                         text):
        out[m.group(1)] = m.group(2).strip()
    return out


def _literal_derived(expr: str, consts: Dict[str, str], ok: Set[str], depth: int = 0) -> bool:
    """True if every identifier of ``expr`` is a literal, an allowed name or
    a constant whose value is itself literal-derived."""
    if depth > 8:
        return False
    expr = re.sub(r"\.\s*[xyz]\b", "", expr)
    for tok in _IDENT.findall(expr):
        if tok in ok or tok in _STEP_OK:
            continue
        if tok in consts and _literal_derived(consts[tok], consts, ok, depth + 1):
            continue
        if _NUM.match(tok):
            continue
        return False
    return True


def _includes(path: Path, seen: Optional[Set[Path]] = None) -> List[Path]:
    """``path`` and the local headers it includes, recursively."""
    seen = seen if seen is not None else set()
    if path in seen or not path.exists():
        return []
    seen.add(path)
    out = [path]
    for m in re.finditer(r'^\s*#\s*include\s*"([^"]+)"', path.read_text(), re.M):
        out += _includes(path.parent / m.group(1), seen)
    return out


def _statement_after(body: str, pos: int) -> str:
    """The statement or braced block starting at ``pos`` of ``body``."""
    i = pos
    while i < len(body) and body[i].isspace():
        i += 1
    if i < len(body) and body[i] == "{":
        depth = 0
        for j in range(i, len(body)):
            depth += {"{": 1, "}": -1}.get(body[j], 0)
            if depth == 0:
                return body[i:j + 1]
        return body[i:]
    j = body.find(";", i)
    return body[i:] if j < 0 else body[i:j + 1]


def _paren_group(body: str, pos: int) -> tuple:
    """(text inside the parentheses opening at ``pos``, index after them)."""
    depth = 0
    for j in range(pos, len(body)):
        depth += {"(": 1, ")": -1}.get(body[j], 0)
        if depth == 0:
            return body[pos + 1:j], j + 1
    return body[pos + 1:], len(body)


_LAUNCH = re.compile(r"<<<|cudaLaunchKernel|\w+\s*<[^<>;()]*\b\d+\b[^<>;()]*>\s*\(")


def _batch_names(expr: str) -> Set[str]:
    return set(_IDENT.findall(re.sub(r"\.\s*\w+", "", expr))) & BATCH_NAMES


def _lint_function(f: Function, rel: str, consts: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    where = f"{rel}::{f.name}"
    body = f.body
    tparams = f.template_params()
    local = dict(consts, **_constants(body))

    def line_of(pos: int) -> int:
        return f.body_line + body.count("\n", 0, pos)

    def emit(rule: str, pos: int, message: str) -> None:
        findings.append(Finding(pass_name="kernel_lint", rule=rule, where=where,
                                message=f"line {line_of(pos)}: {message}"))

    # atomic-in-commit-kernel
    for m in re.finditer(r"\batomic\w*|(?<![\w.])(?:red|atom)\.[a-z]", body):
        emit("atomic-in-commit-kernel", m.start(),
             f"'{m.group(0)}' in commit code: the combine order of an atomic "
             "follows the hardware's scheduling, not a fixed tree")

    # grid-reduction-extent: the card or the grid shaping a partition
    if f.device:
        for m in re.finditer(r"\bgridDim\b|%n?smid|\bclock(?:64)?\s*\(|%clock", body):
            emit("grid-reduction-extent", m.start(),
                 f"'{m.group(0).strip('( ')}' in commit device code: a partition "
                 "read from the grid or the SM follows the launch, not a literal")
    for m in re.finditer(r"multiProcessorCount|cudaDevAttrMultiProcessorCount|"
                         r"cudaOccupancyMaxActiveBlocksPerMultiprocessor", body):
        emit("grid-reduction-extent", m.start(),
             f"'{m.group(0)}' in commit code: a partition sized by the card's "
             "SM count changes with the card")
    if f.device:
        for m in re.finditer(r"\bfor\s*\(", body):
            inside, _ = _paren_group(body, m.end() - 1)
            parts = inside.split(";")
            if len(parts) != 3:
                continue
            inc = parts[2].strip()
            s = (re.match(r"^\w+\s*(?:\+=|-=|\*=|>>=|<<=)\s*(.+)$", inc)
                 or re.match(r"^(\w+)\s*=\s*\1\s*[-+*]\s*(.+)$", inc))
            if s is None:
                continue
            step = s.group(s.lastindex)
            if not _literal_derived(step, local, tparams):
                emit("grid-reduction-extent", m.start(),
                     f"loop step '{step}' is not a literal-derived constant: the "
                     "partition it walks can follow a runtime count")

    # adaptive-block-size: a tile chosen by min/max over a count ...
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*=\s*(?:std::)?(min|max)\s*\(", body):
        args, _ = _paren_group(body, m.end() - 1)
        if _TILE_NAME.search(m.group(1)) and _batch_names(args):
            emit("adaptive-block-size", m.start(),
                 f"'{m.group(1)} = {m.group(2)}(...)' clamps a tile or partition "
                 f"with {sorted(_batch_names(args))}: the geometry adapts to the "
                 "workload")
    # ... or a launcher branch on a count that picks the launch
    if not f.device:
        for m in re.finditer(r"\b(if|switch)\s*\(", body):
            cond, after = _paren_group(body, m.end() - 1)
            names = _batch_names(cond)
            if not names:
                continue
            governed = _statement_after(body, after)
            if m.group(1) == "if":
                rest = body[after + len(governed):].lstrip()
                if rest.startswith("else"):
                    governed += _statement_after(body, body.index("else", after + len(governed)) + 4)
            if _LAUNCH.search(governed):
                emit("adaptive-block-size", m.start(),
                     f"launcher {m.group(1)} on {sorted(names)} picks a launch or "
                     "template instantiation: the reduction geometry follows the "
                     "workload")
        for m in re.finditer(r"[^;{}]*\?[^;{}]*;", body):
            stmt = m.group(0)
            cond = re.split(r"[=(,]", stmt.split("?")[0])[-1]
            if _batch_names(cond) and _LAUNCH.search(stmt):
                emit("adaptive-block-size", m.start(),
                     f"'?:' on {sorted(_batch_names(cond))} picks a launch or "
                     "template instantiation")

    # accum-dtype: MMA accumulators and narrow accumulators
    for m in re.finditer(r"\b(wgmma\.mma_async|mma)\.(?:sync\.)?(?:aligned\.)?"
                         r"m\d+n\d+k\d+((?:\.[a-z0-9]+)+)", body):
        toks = [t for t in m.group(2).split(".") if t and t not in ("row", "col")]
        if toks and toks[0] not in ("f32", "s32"):
            emit("accum-dtype", m.start(),
                 f"'{m.group(0)}' accumulates in .{toks[0]}, not .f32: sub-f32 "
                 "partials make the result depend on the fold order")
    narrow = "|".join(re.escape(t) for t in NARROW_TYPES)
    for m in re.finditer(rf"\b(?:{narrow})\s+([A-Za-z_]\w*)", body):
        name = m.group(1)
        acc = re.search(rf"\b{name}\s*(?:\[[^\]]*\]\s*)*\+=|\b{name}\s*=\s*(?:__hadd2?\s*\(\s*)?"
                        rf"{name}\b\s*[+,]", body)
        if acc:
            emit("accum-dtype", m.start(),
                 f"'{name}' is declared narrower than float and accumulated "
                 f"(line {line_of(acc.start())}): the contract's combine dtype is f32")
    return findings


def lint_file(path: Path, rel: str) -> List[Finding]:
    raw = path.read_text()
    first = next((ln for ln in raw.splitlines() if ln.strip()), "")
    if FASTPATH_RE.match(first):
        return []
    text = strip_comments(raw)
    consts: Dict[str, str] = {}
    for p in reversed(_includes(path)):
        consts.update(_constants(strip_comments(p.read_text())))
    findings: List[Finding] = []
    for f in parse_functions(raw, text):
        if not f.fastpath:
            findings.extend(_lint_function(f, rel, consts))
    return findings


def run_pass(repo_root: Path, files: Optional[List[Path]] = None) -> List[Finding]:
    if files is None:
        csrc = repo_root / CSRC
        files = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    findings: List[Finding] = []
    for path in files:
        if path.suffix not in (".cu", ".cuh"):
            continue
        rel = str(path.relative_to(repo_root)) if path.is_absolute() else str(path)
        findings.extend(lint_file(path, rel))
    return findings
