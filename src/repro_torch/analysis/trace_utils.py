"""Recorded programs: the eager port's counterpart of ``jaxpr_utils``.

The reference proves its contract on jaxprs.  The port runs eagerly, so
this module records the program a step actually runs and gives it the
jaxpr tools' shape:

* ``Recorder`` — a ``TorchDispatchMode`` that logs each aten op a step
  issues (overload name, input and output shapes and dtypes, non-tensor
  arguments, whether it writes in place, producer edges by tensor
  identity).  Kernel wrappers enter the log as one **kernel node** each,
  carrying their reduction geometry (``kernels.recording``): the card's
  launches go through ``ctypes``, which no dispatch mode sees, and the
  aten ops of a wrapper's plain version on the CPU are left out, so a CPU
  trace and a card trace of one step hold the same nodes.  Each node is
  attributed to the first Python frame under ``src/repro_torch`` (the
  checker's own frames aside; kernel nodes to the caller of the
  ``kernels`` package), and f32 contractions record the TF32 switches in
  force.
* ``canonicalize(log, batch)`` / ``compare_canonical(a, b, b1, b2)`` —
  the reference's text-level semantics (``repro.analysis.jaxpr_utils``):
  values alpha-renamed by first appearance, and two forms equal when their
  lines agree but for integers that differ as ``k*B + c`` with ``k >= 1``,
  ``|c| <= AFFINE_C_MAX``, consistently across the pair.
* ``dce(log)`` — liveness back from the step's returned tensors and from
  every write into a tensor the step did not create (the port updates pool
  leaves in place where JAX returns new caches); dead code, such as
  ``moe_ffn``'s aux statistics, leaves the program before the hazard pass.

Imports ``torch`` and the standard library only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import recording

# Largest |c| accepted in the batch-affine dimension model d = k*B + c (the
# reference's constant: real offsets are tiny, and batches are primes >= 13).
AFFINE_C_MAX = 8

REPO_ROOT = Path(__file__).resolve().parents[3]
_ROOT = str(REPO_ROOT) + "/"
_PKG = _ROOT + "src/repro_torch/"
_SKIP = _PKG + "analysis/"
_KERNELS = _PKG + "kernels/"

#: the aten contractions the hazard pass and the TF32 switches concern
CONTRACTIONS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul", "addbmm",
                          "addmv", "mv", "dot", "vdot", "linear"})
CONVOLUTIONS = frozenset({"convolution", "_convolution", "cudnn_convolution",
                          "convolution_overrideable"})


def _batch_affine(d: int, batch: int) -> bool:
    """Could ``d`` be ``k*batch + c`` for some ``k >= 1``, ``|c| <= C_MAX``?"""
    if d < batch - AFFINE_C_MAX:
        return False
    k = max(1, round(d / batch))
    return abs(d - k * batch) <= AFFINE_C_MAX


@dataclasses.dataclass
class Node:
    """One recorded op: an aten overload or a kernel wrapper's call."""

    index: int
    op: str  # "aten.mm.default" or "kernel.gemm_batch_invariant"
    args: Any  # arguments, tensors replaced by ``Val``
    outs: List[int]  # value ids produced (a write in place: the new version)
    mutated: List[int]  # value ids (old versions) written in place
    deps: List[int]  # node indices this node reads from
    where: str  # "path::function" of the attributed frame
    line: int
    geometry: Optional[Dict[str, Any]] = None  # kernel nodes
    tf32: Optional[Tuple[bool, bool, str]] = None  # f32 contractions
    argnames: Tuple[str, ...] = ()  # the aten schema's argument names
    loop: Optional[Tuple[int, int]] = None  # (loop id, iteration): ``recording.steps``

    def arg(self, name: str, default: Any = None) -> Any:
        """The argument ``name`` as recorded (positional or keyword)."""
        args, kw = self.args
        if name in kw:
            return kw[name]
        if name in self.argnames:
            i = self.argnames.index(name)
            if i < len(args):
                return args[i]
        return default

    @property
    def kernel(self) -> bool:
        return self.geometry is not None

    @property
    def name(self) -> str:
        """``mm`` of ``aten.mm.default``, ``gemm_splitk`` of a kernel node."""
        return self.op.split(".")[1]


@dataclasses.dataclass(frozen=True)
class Val:
    """A tensor argument: its value id."""

    vid: int


@dataclasses.dataclass
class Value:
    dtype: torch.dtype
    shape: Tuple[int, ...]
    producer: Optional[int]  # node index; None for a tensor from outside
    base: int  # alias group: views and writes in place share it


@dataclasses.dataclass
class Log:
    """A recorded step: its nodes, values and outputs."""

    nodes: List[Node]
    values: List[Value]
    outputs: List[int]  # value ids of the tensors the step returned
    external_bases: frozenset  # alias groups the step did not create


def _flat_vals(x: Any) -> Iterator[Val]:
    if isinstance(x, Val):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _flat_vals(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _flat_vals(e)


def _flat_tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _flat_tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _flat_tensors(e)


_CODE_CACHE: Dict[Any, Tuple[Optional[str], str, bool]] = {}


def _code_info(code) -> Tuple[Optional[str], str, bool]:
    """(repo-relative path or None, qualified name, in ``kernels/``)."""
    info = _CODE_CACHE.get(code)
    if info is None:
        fname = code.co_filename.replace("\\", "/")
        rel = None
        if fname.startswith(_ROOT) and not fname.startswith(_SKIP):
            rel = fname[len(_ROOT):]
        qual = getattr(code, "co_qualname", code.co_name).replace(".<locals>", "")
        info = (rel, qual, fname.startswith(_KERNELS))
        _CODE_CACHE[code] = info
    return info


def attribute(skip_kernels: bool = False) -> Tuple[str, int]:
    """``(path::function, line)`` of the innermost calling frame under the
    repository (the checker's own frames aside; with ``skip_kernels`` the
    ``kernels`` package's too), preferring ``src/repro_torch`` to other
    files of the repository (tests, fixtures)."""
    f = sys._getframe(1)
    fallback = None
    while f is not None:
        rel, qual, in_kernels = _code_info(f.f_code)
        if rel is not None and not (skip_kernels and in_kernels):
            if rel.startswith("src/repro_torch/"):
                return f"{rel}::{qual}", f.f_lineno
            if fallback is None:
                fallback = (f"{rel}::{qual}", f.f_lineno)
        f = f.f_back
    return fallback or ("<untracked>", 0)


_SCHEMAS: Dict[Any, Tuple[Tuple[str, ...], bool, Tuple[int, ...]]] = {}


def _schema_info(func) -> Tuple[Tuple[str, ...], bool, Tuple[int, ...]]:
    """(argument names, returns a view, indices of arguments written)."""
    info = _SCHEMAS.get(func)
    if info is None:
        schema = func._schema
        names = tuple(a.name for a in schema.arguments)
        written = tuple(i for i, a in enumerate(schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        info = (names, view, written)
        _SCHEMAS[func] = info
    return info


def tf32_flags() -> Tuple[bool, bool, str]:
    """(cuBLAS TF32, cuDNN TF32, float32 matmul precision) now."""
    return (bool(torch.backends.cuda.matmul.allow_tf32),
            bool(torch.backends.cudnn.allow_tf32),
            torch.get_float32_matmul_precision())


class Recorder(TorchDispatchMode):
    """Record the ops a step issues.  Use ``record(fn, *args)``."""

    def __init__(self):
        super().__init__()
        self.nodes: List[Node] = []
        self.values: List[Value] = []
        self._vid = WeakIdKeyDictionary()  # tensor -> current value id
        self._writers: Dict[int, List[int]] = {}
        self._external: set = set()
        self._ext_base: Dict[Tuple[str, int], int] = {}
        self._paused = 0
        self._nbase = 0
        self._loop: Optional[Tuple[int, int]] = None
        self._nloops = 0

    # -- values ----------------------------------------------------------
    def _new_base(self) -> int:
        self._nbase += 1
        return self._nbase

    def _value_of(self, t: torch.Tensor) -> int:
        vid = self._vid.get(t)
        if vid is None:  # first seen: a tensor from outside the step
            key = (str(t.device), t.untyped_storage().data_ptr()
                   if t.device.type != "meta" else id(t))
            base = self._ext_base.get(key)
            if base is None:
                base = self._ext_base[key] = self._new_base()
                self._external.add(base)
            vid = self._add_value(t, None, base)
        return vid

    def _add_value(self, t: torch.Tensor, producer: Optional[int], base: int) -> int:
        vid = len(self.values)
        self.values.append(Value(t.dtype, tuple(int(d) for d in t.shape), producer, base))
        self._vid[t] = vid
        return vid

    def _convert(self, x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return Val(self._value_of(x))
        if isinstance(x, (list, tuple)):
            return type(x)(self._convert(e) for e in x)
        return x

    def _deps(self, args: Any, upto: int) -> List[int]:
        deps = set()
        for v in _flat_vals(args):
            val = self.values[v.vid]
            if val.producer is not None:
                deps.add(val.producer)
            deps.update(w for w in self._writers.get(val.base, ()) if w < upto)
        return sorted(deps)

    def _log(self, op: str, args: Any, out: Any, *, written: Sequence[torch.Tensor] = (),
             view: bool = False, geometry=None, kernel: bool = False,
             argnames: Tuple[str, ...] = ()) -> None:
        idx = len(self.nodes)
        where, line = attribute(skip_kernels=kernel)
        base_in = None
        for v in _flat_vals(args):
            base_in = self.values[v.vid].base
            break
        mutated, outs = [], []
        written_ids = {id(t) for t in written}
        for t in written:
            old = self._value_of(t)
            mutated.append(old)
            base = self.values[old].base
            self._writers.setdefault(base, []).append(idx)
            outs.append(self._add_value(t, idx, base))
        for t in _flat_tensors(out):
            if id(t) in written_ids:
                continue
            base = base_in if (view and base_in is not None) else self._new_base()
            outs.append(self._add_value(t, idx, base))
        tf32 = None
        name = op.split(".")[1]
        if not kernel and (name in CONTRACTIONS or name in CONVOLUTIONS):
            tf32 = tf32_flags()
        self.nodes.append(Node(idx, op, args, outs, mutated, self._deps(args, idx),
                               where, line, geometry, tf32, argnames, self._loop))

    # -- the dispatch mode -------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        names, view, written_idx = _schema_info(func)
        cargs = self._convert(list(args))
        ckw = {k: self._convert(v) for k, v in sorted(kwargs.items())}
        out = func(*args, **kwargs)
        written = []
        for i in written_idx:
            a = args[i] if i < len(args) else kwargs.get(names[i])
            written.extend(_flat_tensors(a))
        self._log(str(func), (cargs, ckw), out, written=written, view=view,
                  argnames=names)
        return out

    def kernel(self, fn: Callable, args: tuple, **geometry) -> Any:
        """A kernel wrapper's call as one node (``kernels.recording``)."""
        cargs = self._convert(list(args))
        recording.active = None
        self._paused += 1
        try:
            out = fn(*args, **geometry)
        finally:
            self._paused -= 1
            recording.active = self
        self._log(f"kernel.{fn.__name__}", (cargs, {}), out, geometry=dict(geometry),
                  kernel=True)
        return out

    def loop(self, n: int) -> Iterator[int]:
        """``range(n)`` whose iterations tag the nodes recorded in them
        (``kernels.recording.steps``)."""
        self._nloops += 1
        lid, prev = self._nloops, self._loop
        try:
            for t in range(n):
                self._loop = (lid, t)
                yield t
        finally:
            self._loop = prev

    @contextlib.contextmanager
    def recording(self) -> Iterator["Recorder"]:
        prev = recording.active
        recording.active = self
        try:
            with self:
                yield self
        finally:
            recording.active = prev

    def log(self, outputs: Any) -> Log:
        outs = [self._vid[t] for t in _flat_tensors(outputs) if t in self._vid]
        return Log(self.nodes, self.values, outs, frozenset(self._external))


def record(fn: Callable, *args, **kwargs) -> Tuple[Log, Any]:
    """Run ``fn(*args, **kwargs)`` under a ``Recorder``; returns ``(log,
    result)``."""
    rec = Recorder()
    with rec.recording():
        result = fn(*args, **kwargs)
    return rec.log(result), result


# ---------------------------------------------------------------------------
# liveness


def live_nodes(log: Log) -> List[bool]:
    """Per node: does it feed a returned tensor or a tensor from outside?"""
    live = [False] * len(log.nodes)
    work: List[int] = []
    for vid in log.outputs:
        v = log.values[vid]
        if v.producer is not None:
            work.append(v.producer)
    for n in log.nodes:
        if any(log.values[m].base in log.external_bases for m in n.mutated):
            work.append(n.index)
    # a returned tensor's alias group: every write into it counts
    out_bases = {log.values[vid].base for vid in log.outputs}
    for n in log.nodes:
        if any(log.values[m].base in out_bases for m in n.mutated):
            work.append(n.index)
    while work:
        i = work.pop()
        if live[i]:
            continue
        live[i] = True
        work.extend(d for d in log.nodes[i].deps if not live[d])
    return live


def dce(log: Log) -> Log:
    """The live program: nodes that feed no returned tensor and write no
    tensor from outside the step are dropped (values keep their ids)."""
    live = live_nodes(log)
    return dataclasses.replace(log, nodes=[n for n in log.nodes if live[n.index]])


# ---------------------------------------------------------------------------
# canonical form


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class _Canon:
    def __init__(self, log: Log, batch: int):
        self.log = log
        self.batch = batch
        self.names: Dict[int, str] = {}
        self.n_in = 0
        self.n_val = 0
        # value id -> (loop id, iteration, node position in the iteration,
        # output position) for the values a folded loop produces
        self.folded: Dict[int, Tuple[int, int, int, int]] = {}
        self.producer: Dict[int, int] = {}

    def vname(self, vid: int) -> str:
        name = self.names.get(vid)
        if name is None:
            if self.log.values[vid].producer is None:
                name = f"a{self.n_in}"
                self.n_in += 1
            else:
                name = f"v{self.n_val}"
                self.n_val += 1
            self.names[vid] = name
        v = self.log.values[vid]
        return f"{name}:{_dtype_name(v.dtype)}[{','.join(map(str, v.shape))}]"

    def value(self, x: Any) -> str:
        if isinstance(x, Val):
            return self.vname(x.vid)
        if isinstance(x, bool) or x is None:
            return str(x)
        if isinstance(x, int):
            return str(x)
        if isinstance(x, float):
            return repr(x)
        if isinstance(x, str):
            return repr(x)
        if isinstance(x, torch.dtype):
            return _dtype_name(x)
        if isinstance(x, torch.device):
            return "dev"
        if isinstance(x, (list, tuple)):
            each = self._per_iteration(x)
            if each is not None:
                return f"each({self.value(x[0])})x{len(x)}"
            return "(" + ",".join(self.value(e) for e in x) + ")"
        if isinstance(x, dict):
            return "{" + ",".join(f"{k}={self.value(v)}" for k, v in x.items()) + "}"
        s = str(x)
        return f"<{type(x).__name__}>" if ("0x" in s or len(s) > 120 or not s) else s

    def _per_iteration(self, xs) -> bool:
        """Are ``xs`` one value of each iteration of a folded loop, in order
        (``torch.stack`` of a per-position loop's outputs)?"""
        if len(xs) < 2 or not all(isinstance(e, Val) for e in xs):
            return None
        tags = [self.folded.get(e.vid) for e in xs]
        if any(t is None for t in tags):
            return None
        return (len({(t[0], t[2], t[3]) for t in tags}) == 1
                and [t[1] for t in tags] == list(range(len(xs)))) or None

    def line(self, n: Node) -> str:
        args, kw = n.args
        params = [self.value(a) for a in args]
        params += [f"{k}={self.value(v)}" for k, v in kw.items()]
        if n.geometry is not None:
            params += [f"{k}={self.value(v)}" for k, v in sorted(n.geometry.items())]
        outs = " ".join(self.vname(v) for v in n.outs)
        return f"{outs} = {n.op}({', '.join(params)})"

    def run(self) -> str:
        lines: List[str] = []
        nodes = self.log.nodes
        i = 0
        while i < len(nodes):
            n = nodes[i]
            if n.loop is None:
                lines.append(self.line(n))
                i += 1
                continue
            j = i
            while j < len(nodes) and nodes[j].loop is not None and nodes[j].loop[0] == n.loop[0]:
                j += 1
            iters: Dict[int, List[Node]] = {}
            for m in nodes[i:j]:
                iters.setdefault(m.loop[1], []).append(m)
            body = iters[min(iters)]
            if _foldable([iters[t] for t in sorted(iters)], self.log, self.batch):
                for t, its in iters.items():
                    for pos, m in enumerate(its):
                        for o, vid in enumerate(m.outs):
                            self.folded[vid] = (n.loop[0], t, pos, o)
                lines.append(f"loop(trips={len(iters)}) {{")
                lines.extend("  " + self.line(m) for m in body)
                lines.append("}")
            else:
                lines.extend(self.line(m) for m in nodes[i:j])
            i = j
        lines.append("out " + " ".join(self.vname(v) for v in self.log.outputs))
        return "\n".join(lines)


def _iteration_text(nodes: List[Node], log: Log, batch: int) -> str:
    """One iteration's lines, its values named by first appearance in it."""
    c = _Canon(log, batch)
    return "\n".join(c.line(n) for n in nodes)


def _foldable(iterations: List[List[Node]], log: Log, batch: int) -> bool:
    """Do the iterations run one body, their integers differing at most as
    the iteration index does (``select(x, 1, t)``)?"""
    if len({len(it) for it in iterations}) != 1:
        return False
    ref = _iteration_text(iterations[0], log, batch).splitlines()
    for t, it in enumerate(iterations[1:], start=1):
        for la, lb in zip(ref, _iteration_text(it, log, batch).splitlines()):
            if la == lb:
                continue
            sa, na = _skeleton(la)
            sb, nb = _skeleton(lb)
            if sa != sb or len(na) != len(nb):
                return False
            if any(x != y and (isinstance(x, float) or y - x != t) for x, y in zip(na, nb)):
                return False
    return True


def canonicalize(log: Log, batch: int) -> str:
    """The recorded program as canonical text: one line an op, values
    alpha-renamed by first appearance (``aN`` tensors from outside the
    step, ``vN`` the step's own), devices erased, no source attribution."""
    return _Canon(log, batch).run()


# numeric tokens in canonical lines: floats (kept verbatim) and ints
# (compared under the batch-affine model)
_NUM_RE = re.compile(r"-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\d+")


def _skeleton(line: str) -> Tuple[str, list]:
    nums: list = []

    def rep(m: re.Match) -> str:
        s = m.group(0)
        nums.append(float(s) if ("." in s or "e" in s or "E" in s) else int(s))
        return "§"

    return _NUM_RE.sub(rep, line), nums


def _lines_match(la: str, lb: str, b1: int, b2: int) -> bool:
    if la == lb:
        return True
    sa, na = _skeleton(la)
    sb, nb = _skeleton(lb)
    if sa != sb or len(na) != len(nb):
        return False
    for x, y in zip(na, nb):
        if x == y:
            continue
        if isinstance(x, float) or isinstance(y, float):
            return False
        # batch-affine: x = k*b1 + c, y = k*b2 + c, k >= 1, |c| <= C_MAX
        num, den = x - y, b1 - b2
        if den == 0 or num % den:
            return False
        k = num // den
        if k < 1:
            return False
        if abs(x - k * b1) > AFFINE_C_MAX:
            return False
    return True


def compare_canonical(a: str, b: str, b1: int, b2: int) -> Optional[Tuple[int, str, str]]:
    """First structurally-divergent line between two canonical forms recorded
    at batch sizes ``b1``/``b2``, or None when batch-invariant."""
    la, lb = a.splitlines(), b.splitlines()
    for i, (x, y) in enumerate(zip(la, lb)):
        if not _lines_match(x, y, b1, b2):
            return i, x, y
    if len(la) != len(lb):
        i = min(len(la), len(lb))
        longer = la if len(la) > len(lb) else lb
        extra = longer[i]
        return (i, extra, "<end>") if len(la) > len(lb) else (i, "<end>", extra)
    return None


def kernel_summary(log: Log) -> Dict[str, int]:
    """``name(geometry)`` of every kernel node -> its count."""
    out: Dict[str, int] = {}
    for n in log.nodes:
        if n.kernel:
            geo = ", ".join(f"{k}={v}" for k, v in sorted(n.geometry.items())
                            if k not in ("null_bid", "scale", "eps"))
            key = f"{n.name}({geo})"
            out[key] = out.get(key, 0) + 1
    return out
