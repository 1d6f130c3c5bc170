"""The kernel wrappers' hook for the determinism-contract checker.

``active`` is None on the serving path, and each kernel wrapper reads it
once before anything else: that read is all the hook costs there.  While
``repro_torch.analysis.trace_utils.Recorder`` records a step it holds the
recorder, and a wrapper call becomes ``active.kernel(wrapper, args,
**geometry)``: one kernel node carrying the call's reduction geometry, with
the aten ops of the wrapper's own body (its plain version on the CPU, its
allocations on the card) left out of the log, so that a CPU trace and a
card trace of one step hold the same nodes.  The card's launches go through
``ctypes``, which no dispatch mode sees; this hook is how they enter a
trace.  No ``torch.library`` op is registered: a dispatcher hop per launch
would cost the serving path.  ``steps`` marks a model's per-position loop
for the recorder (one read of ``active`` a loop).

Each kernel wrapper's ``launches`` attribute counts the launches its
Python body makes.  A captured program (``serving.programs``) runs no
Python when it replays, so it reads the counts its capture made
(``launch_counts``), takes them back out (the capture launched nothing on
the card) and adds them again at every replay (``add_launches``): the
counters keep meaning launches on the card.  ``counted`` registers a
wrapper.
"""

from typing import Callable, Dict, List

active = None

#: every kernel wrapper that counts its launches (``counted``)
COUNTED: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper whose ``launches`` attribute counts its
    launches, starting at zero."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def launch_counts() -> Dict[Callable, int]:
    """``{wrapper: launches}`` of every registered wrapper."""
    return {fn: fn.launches for fn in COUNTED}


def add_launches(counts: Dict[Callable, int]) -> None:
    """Add ``counts`` (``{wrapper: n}``, n may be negative) to the wrappers'
    counters."""
    for fn, n in counts.items():
        fn.launches += n


def steps(n: int):
    """``range(n)`` for a model's per-position loop.  Under a recorder each
    iteration's nodes are tagged, so that the canonical form folds the loop
    into one body and a trip count, as the reference's ``scan`` equation
    does; otherwise it is ``range(n)`` itself."""
    rec = active
    return range(n) if rec is None else rec.loop(n)
