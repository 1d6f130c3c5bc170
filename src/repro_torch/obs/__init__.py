"""Unified observability layer (ISSUE 9): tracing + metrics + audit.

One bundle, three concerns, one wiring point (``Engine(trace=..., audit=...)``):

* :mod:`repro.obs.metrics` — the typed metrics registry every subsystem
  registers into; always on (pure host bookkeeping), ``snapshot()`` is the
  single source of truth ``mem_stats()`` and the benchmarks now read.
* :mod:`repro.obs.trace` — dual-stream request tracing on the engine's
  stream clocks, exported as Chrome/Perfetto trace-event JSON
  (``serve.py --trace-out``).  Off by default (:class:`NullTracer`).
* :mod:`repro.obs.audit` — the per-committed-token determinism audit log
  (``serve.py --audit-out``).  Off by default (:class:`NullAudit`).

Everything here is observer-effect-free by construction: recorders are
host-side, device programs are identical with recording on or off, and
``tests/test_obs.py`` proves committed streams bitwise-identical across
the on/off matrix.
"""

from __future__ import annotations

from repro_torch.obs.audit import AuditLog, NullAudit, TokenProvenance
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    GaugeFn,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import NullTracer, Tracer, validate_chrome_trace


class Observability:
    """The engine's observability bundle.

    ``metrics`` is always a live registry (snapshotting is free until
    called); ``tracer`` and ``audit`` are real recorders only when asked
    for — their Null twins cost one attribute check per call site.
    """

    def __init__(self, *, trace: bool = False, audit: bool = False,
                 registry: MetricsRegistry | None = None) -> None:
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer() if trace else NullTracer()
        self.audit = AuditLog() if audit else NullAudit()


__all__ = [
    "AuditLog",
    "Counter",
    "Gauge",
    "GaugeFn",
    "Histogram",
    "MetricsRegistry",
    "NullAudit",
    "NullTracer",
    "Observability",
    "TokenProvenance",
    "Tracer",
    "validate_chrome_trace",
]
