"""One program per shape class: the counterpart of ``jax.jit`` and of the
reference engine's ``_fns`` cache.

The reference runs every device step as one compiled program per shape
class (``repro.serving.engine.Engine._fns``: ``("decode", B, schedule)``,
``("prefill", P)``, ``("prefill_chunk", C)``, ``("cross", Se)``,
``("fused", C, B, schedule, n_groups)``, and ``make_verify_fn``'s verify
pass).  Here a :class:`Program` wraps one engine body under one key.  At its
first call it allocates an input buffer per input tensor, of the key's
shapes, on the engine's device.  Every call copies its inputs into those
buffers (a host tensor through a pinned staging buffer, without blocking
the host), then:

* on the card, the first call runs the body on a side stream (the warm-up,
  and this call's real work: the state it updates is updated once), then
  captures the body into a CUDA graph on that stream; every later call
  replays the graph and returns its static outputs.  Every warm-up and
  capture of the process runs on one side stream a device: the caching
  allocator reuses a block only on the stream it was made on, so captures
  on streams of their own would each keep their own memory.  The graphs
  of one owner (an engine, a training program) share that owner's
  :class:`Pool`; when its last graph goes, the pool is given up and its
  memory returned to the card at once;
* on the CPU, every call runs the body on the same buffers.

Outputs of a replay are the graph's own tensors: the next replay of any
program may overwrite them, so a caller reads them before it runs another
program.  A capture that fails raises, naming the key; nothing
falls back to running the body eagerly.  ``eager()`` is the counterpart of
``jax.disable_jit()``: inside it every program calls its body directly on
its arguments (moved to the device), as the port ran before it had
programs; the determinism checker records bodies and ``chip_smoke.py``
compares streams under it.

A body may also update state it closes over rather than takes as input (a
training program's parameters and optimizer state).  Such a program is made
with ``warm_up``, a run of the body that leaves the state as it found it:
the card's first call runs ``warm_up`` on the side stream and captures
``fn``, so every call, the first included, is a replay; ``capture`` does
the warm-up and the capture ahead of the first call.

Each program counts its captures, its replays and the runs of its body
outside a capture (``runs``: the card's one warm-up, every call on the CPU
and every call under ``eager()``) as plain attributes.  The kernel
wrappers' ``launches`` counters count Python calls; a capture makes calls
but launches nothing, and a replay launches without calls, so a program
takes its capture's counts back out and adds them at every replay
(``kernels.recording.add_launches``).
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Callable, Hashable, Iterator, List, Optional

import torch

from repro_torch.kernels import recording

_eager_depth = 0


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """Run every program's body directly (no buffers, no capture) inside
    the block: the counterpart of ``jax.disable_jit()``."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def _flatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """The structure of a tree of tuples, lists, dicts, None and tensors,
    its tensors appended to ``leaves`` in order."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return True
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree), [_flatten(x, leaves) for x in tree]
    if isinstance(tree, dict):
        return dict, {k: _flatten(v, leaves) for k, v in tree.items()}
    raise TypeError(f"a program's inputs and outputs are tensors, not {type(tree)}")


def _unflatten(spec: Any, leaves: Iterator[torch.Tensor]) -> Any:
    if spec is True:
        return next(leaves)
    if spec is None:
        return None
    kind, items = spec
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in items.items()}
    return kind(_unflatten(x, leaves) for x in items)


#: per device: the side stream every warm-up and capture runs on
_sides: dict = {}
#: captures running now, and graphs given up meanwhile (released after it)
_capturing = 0
_deferred: list = []


def _side(device: torch.device) -> torch.cuda.Stream:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sides:
        _sides[idx] = torch.cuda.Stream(idx)
    return _sides[idx]


class Pool:
    """The graph memory pool of one owner's programs (an engine's, a
    training program's).  It lives while a graph captured into it does:
    when the last one goes, the caching allocator gives the pool up, its
    handle must not be used again (the next capture starts a new one), and
    the pool's memory goes back to the card (``torch.cuda.empty_cache``,
    which frees every cached block no tensor holds; the allocator itself
    frees a given-up pool only when an allocation fails)."""

    def __init__(self) -> None:
        self.handle: Any = None
        self.graphs = 0

    def take(self) -> Any:
        """The handle a capture starts with: read just before it, since a
        collection in between may have given the pool up."""
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


def _release(pool: Pool, graph: torch.cuda.CUDAGraph, *held: list) -> None:
    """A captured program is going (its finalizer runs before its
    attributes are dropped): reset its graph, which gives up its share of
    the pool, empty its lists of buffers and outputs (``held``), and
    return the pool's memory if that was the pool's last graph.  Deferred
    to the end of a capture that is running: nothing may be freed to the
    card inside one."""
    if _capturing:
        _deferred.append((pool, graph) + held)
        return
    graph.reset()
    for tensors in held:
        tensors.clear()
    pool.graphs -= 1
    if pool.graphs == 0:
        pool.handle = None
        torch.cuda.empty_cache()


class Program:
    """One engine body under one shape-class key (see the module
    docstring).  ``fn`` takes and returns trees of tensors; ``pool`` is
    the owner's (a pool of the program's own when None); ``warm_up``, when
    given, is ``fn`` without its effects on closed-over state."""

    def __init__(self, key: Hashable, fn: Callable, device: torch.device, *,
                 pool: Optional[Pool] = None, warm_up: Optional[Callable] = None):
        self.key = key
        self.fn = fn
        self.warm_up = warm_up
        self.device = torch.device(device)
        self.pool = pool if pool is not None else Pool()
        self.captures = 0
        self.replays = 0
        self.runs = 0  # body runs outside a capture
        self.capture_s = 0.0  # host seconds of the warm-up and the capture
        self._spec: Any = None
        self._inputs: List[torch.Tensor] = []
        self._staging: List[Optional[torch.Tensor]] = []
        self._staged: Optional[torch.cuda.Event] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out_spec: Any = None
        self._outputs: List[torch.Tensor] = []
        self._launches: dict = {}

    def __call__(self, *args: Any) -> Any:
        if _eager_depth:
            self.runs += 1
            leaves: List[torch.Tensor] = []
            spec = _flatten(args, leaves)
            return self.fn(*_unflatten(spec, iter(
                [t.to(self.device) for t in leaves])))
        self._fill(args)
        if self.device.type != "cuda":
            self.runs += 1
            return self._run(self.fn)
        if self._graph is None:
            out = self._warm_up_and_capture()
            if self.warm_up is None:
                return out  # the warm-up was this call's work
        self._graph.replay()
        self.replays += 1
        recording.add_launches(self._launches)
        return _unflatten(self._out_spec, iter(self._outputs))

    def capture(self, *args: Any) -> None:
        """Take ``args`` as the first call's inputs and, on the card, warm
        up and capture without running a step (a program with ``warm_up``
        only); nothing to do on the CPU, under ``eager()`` or once
        captured."""
        assert self.warm_up is not None, f"program {self.key!r} has no warm-up"
        if _eager_depth:
            return
        self._fill(args)
        if self.device.type == "cuda" and self._graph is None:
            self._warm_up_and_capture()

    # -- inputs ----------------------------------------------------------

    def _fill(self, args: Any) -> None:
        """Copy the call's tensors into the input buffers (allocated at the
        first call, with the first call's shapes and dtypes)."""
        leaves: List[torch.Tensor] = []
        spec = _flatten(args, leaves)
        if self._spec is None:
            self._spec = spec
            cuda = self.device.type == "cuda"
            self._inputs = [torch.empty_like(t, device=self.device) for t in leaves]
            self._staging = [
                torch.empty_like(t, device="cpu").pin_memory()
                if cuda and t.device.type == "cpu" else None for t in leaves]
            self._staged = torch.cuda.Event() if cuda else None
        elif spec != self._spec or any(
                t.shape != b.shape or t.dtype != b.dtype
                for t, b in zip(leaves, self._inputs)):
            raise ValueError(
                f"program {self.key!r}: inputs "
                f"{[(tuple(t.shape), t.dtype) for t in leaves]} do not match its "
                f"buffers {[(tuple(b.shape), b.dtype) for b in self._inputs]}")
        if self._staged is not None:
            self._staged.synchronize()  # the last call's copies left the staging
        for t, buf, host in zip(leaves, self._inputs, self._staging):
            if host is not None and t.device.type == "cpu":
                host.copy_(t)
                t = host
            buf.copy_(t, non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def _run(self, fn: Callable) -> Any:
        return fn(*_unflatten(self._spec, iter(self._inputs)))

    # -- the card ----------------------------------------------------------

    def _warm_up_and_capture(self) -> Any:
        global _capturing
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = _side(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # lazy one-time setup runs here; without ``warm_up`` this is
            # the call's work, and the state it updates is updated once
            out = self._run(self.warm_up or self.fn)
        self.runs += 1
        cur.wait_stream(side)
        if self.warm_up is not None:
            out = None
            # the warm-up's transients leave the side stream's cache, so
            # that the capture's pool does not stand beside them
            side.synchronize()
            torch.cuda.empty_cache()
        before = recording.launch_counts()
        graph = torch.cuda.CUDAGraph()
        _capturing += 1
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self.pool.take())
                try:
                    outs = self._run(self.fn)
                finally:
                    graph.capture_end()
        except Exception as exc:
            raise RuntimeError(
                f"capture of program {self.key!r} failed: {exc}") from exc
        finally:
            _capturing -= 1
            while _deferred and not _capturing:
                _release(*_deferred.pop())
        cur.wait_stream(side)
        after = recording.launch_counts()
        # the capture launched nothing: its counts move to the replays
        self._launches = {fn: after[fn] - before[fn] for fn in after
                          if after[fn] != before[fn]}
        recording.add_launches({fn: -n for fn, n in self._launches.items()})
        leaves: List[torch.Tensor] = []
        self._out_spec = _flatten(outs, leaves)
        self._outputs = leaves
        self._graph = graph
        self.pool.graphs += 1
        weakref.finalize(self, _release, self.pool, graph, self._outputs, self._inputs,
                         self._staging).atexit = False
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return out
