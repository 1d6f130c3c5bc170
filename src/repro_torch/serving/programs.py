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
  capture of the process runs on one side stream a device, and the graphs
  alive at once share one memory pool (``torch.cuda.graph_pool_handle``):
  the caching allocator reuses a block only on the stream it was made on
  and within its pool, so captures on streams or in pools of their own
  would each keep their own memory; a pool is freed with its last graph;
* on the CPU, every call runs the body on the same buffers.

Outputs of a replay are the graph's own tensors: the next replay of any
program may overwrite them, so a caller reads them before it runs another
program.  A capture that fails raises, naming the key; nothing
falls back to running the body eagerly.  ``eager()`` is the counterpart of
``jax.disable_jit()``: inside it every program calls its body directly on
its arguments (moved to the device), as the port ran before it had
programs; the determinism checker records bodies and ``chip_smoke.py``
compares streams under it.

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


#: per device: [the side stream, the graph pool handle (None until the
#: next capture), the captured programs alive]
_sides: dict = {}


def _side(device: torch.device) -> list:
    """``device``'s entry of ``_sides``, with a pool handle.  The pool
    lives while a graph captured into it does: when the last one goes,
    the caching allocator frees the pool, and its handle must not be used
    again (``_released``), so the next capture starts a new one."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    side = _sides.setdefault(idx, [torch.cuda.Stream(idx), None, 0])
    if side[1] is None:
        side[1] = torch.cuda.graph_pool_handle()
    return side


def _released(side: list) -> None:
    side[2] -= 1
    if side[2] == 0:
        side[1] = None


class Program:
    """One engine body under one shape-class key (see the module
    docstring).  ``fn`` takes and returns trees of tensors."""

    def __init__(self, key: Hashable, fn: Callable, device: torch.device):
        self.key = key
        self.fn = fn
        self.device = torch.device(device)
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
        if self._graph is not None:
            self._graph.replay()
            self.replays += 1
            recording.add_launches(self._launches)
            return _unflatten(self._out_spec, iter(self._outputs))
        if self.device.type != "cuda":
            self.runs += 1
            return self._run()
        return self._warm_up_and_capture()

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

    def _run(self) -> Any:
        return self.fn(*_unflatten(self._spec, iter(self._inputs)))

    # -- the card ----------------------------------------------------------

    def _warm_up_and_capture(self) -> Any:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        entry = _side(self.device)
        side = entry[0]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._run()  # this call's work; lazy one-time setup runs here
        self.runs += 1
        cur.wait_stream(side)
        before = recording.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                # the handle read just before the capture takes the pool:
                # a collection in between could have given it up
                graph.capture_begin(pool=_side(self.device)[1])
                try:
                    outs = self._run()
                finally:
                    graph.capture_end()
        except Exception as exc:
            raise RuntimeError(
                f"capture of program {self.key!r} failed: {exc}") from exc
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
        entry[2] += 1
        weakref.finalize(self, _released, entry)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return out

