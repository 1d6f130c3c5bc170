"""Typed metrics registry: counters, gauges, histograms, one snapshot.

The serving stack used to scatter its telemetry: ``Engine.mem_stats()``
(block pool + preemption lane), raw attributes on the dual-clock runtime
(``peak_outstanding``, ``outstanding_verdicts``), per-request stat fields
summed ad hoc by every benchmark, and prefix-cache counters behind their
own ``stats()``.  This module is the one source of truth those callers now
share: the engine registers every series at construction, ``snapshot()``
returns a flat ``{name: value}`` dict, and ``describe()`` is the
machine-readable catalog (name, kind, unit, help) the README table is
generated from.

Design constraints (ISSUE 9):

* **Always on, observer-effect-free.**  The registry is pure host-side
  bookkeeping over values the engine already computes — it never touches
  device code, so committed streams are bitwise identical whether anyone
  ever calls ``snapshot()``.
* **Pull-based gauges.**  Occupancy-style series (blocks in use, stream
  backlog, queue depths) register a ``gauge_fn`` callback instead of being
  pushed every iteration: reading them costs nothing until a snapshot is
  taken, and they can never go stale.  Callbacks must close over ``self``
  lookups (e.g. ``lambda: self.runtime.peak_outstanding``), not over the
  objects themselves — ``Engine.bind_cost_model`` replaces the runtime
  wholesale.
* **Exact histograms.**  Histograms keep raw observations (these are
  discrete-event runs of bounded length, not an unbounded prod firehose),
  so snapshot percentiles are exact, not bucket-interpolated.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional


def _num(v: float) -> Any:
    """ints stay ints in snapshots (JSON-friendly, test-friendly)."""
    f = float(v)
    return int(f) if f.is_integer() else f


@dataclasses.dataclass
class Counter:
    """Monotone non-negative accumulator."""

    name: str
    unit: str = ""
    help: str = ""
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counter {self.name} cannot decrease"
        self.value += n


@dataclasses.dataclass
class Gauge:
    """Point-in-time value, set by the owner."""

    name: str
    unit: str = ""
    help: str = ""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def set_max(self, v: float) -> None:
        """High-watermark update (peak concurrency, peak depth)."""
        self.value = max(self.value, float(v))


@dataclasses.dataclass
class GaugeFn:
    """Pull-based gauge: ``fn()`` is evaluated at snapshot time."""

    name: str
    fn: Callable[[], float]
    unit: str = ""
    help: str = ""

    @property
    def value(self) -> float:
        return float(self.fn())


class Histogram:
    """Exact-value histogram; snapshot reports count/sum/min/max/mean and
    the p50/p90/p99 percentiles (nearest-rank, matching
    ``serving.online.percentile``)."""

    PERCENTILES = (50, 90, 99)

    def __init__(self, name: str, unit: str = "", help: str = "") -> None:
        self.name = name
        self.unit = unit
        self.help = help
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def summary(self) -> Dict[str, Any]:
        vs = self.values
        if not vs:
            return {"count": 0, "sum": 0, "min": 0, "max": 0, "mean": 0,
                    **{f"p{p}": 0 for p in self.PERCENTILES}}
        s = sorted(vs)
        out: Dict[str, Any] = {
            "count": len(vs),
            "sum": _num(sum(vs)),
            "min": _num(s[0]),
            "max": _num(s[-1]),
            "mean": sum(vs) / len(vs),
        }
        for p in self.PERCENTILES:
            idx = min(int(p / 100.0 * len(s)), len(s) - 1)
            out[f"p{p}"] = _num(s[idx])
        return out


class MetricsRegistry:
    """Get-or-create registry of named series.

    Names are dot-namespaced by subsystem (``blockpool.blocks_in_use``,
    ``verify.rollbacks``, ``latency.ttft``).  Re-registering a name returns
    the existing series (so idempotent wiring is safe) but re-registering
    it as a *different kind* is a bug and asserts.
    """

    def __init__(self) -> None:
        self._series: Dict[str, Any] = {}

    def _get_or_create(self, kind: type, name: str, make: Callable[[], Any]):
        existing = self._series.get(name)
        if existing is not None:
            assert isinstance(existing, kind), (
                f"metric {name!r} already registered as "
                f"{type(existing).__name__}, not {kind.__name__}"
            )
            return existing
        series = make()
        self._series[name] = series
        return series

    def counter(self, name: str, unit: str = "", help: str = "") -> Counter:
        return self._get_or_create(
            Counter, name, lambda: Counter(name, unit, help)
        )

    def gauge(self, name: str, unit: str = "", help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, lambda: Gauge(name, unit, help))

    def gauge_fn(
        self, name: str, fn: Callable[[], float], unit: str = "",
        help: str = "",
    ) -> GaugeFn:
        g = self._get_or_create(
            GaugeFn, name, lambda: GaugeFn(name, fn, unit, help)
        )
        g.fn = fn  # re-wiring replaces the callback (engine re-binds)
        return g

    def histogram(self, name: str, unit: str = "", help: str = "") -> Histogram:
        return self._get_or_create(
            Histogram, name, lambda: Histogram(name, unit, help)
        )

    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{name: value}`` view of every series.  Histograms expand
        to ``name.count`` / ``name.sum`` / ``name.mean`` / ``name.min`` /
        ``name.max`` / ``name.p50|p90|p99`` keys."""
        out: Dict[str, Any] = {}
        for name in sorted(self._series):
            s = self._series[name]
            if isinstance(s, Histogram):
                for k, v in s.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = _num(s.value)
        return out

    def describe(self) -> List[Dict[str, str]]:
        """Catalog rows: (name, kind, unit, help) per registered series."""
        kinds = {Counter: "counter", Gauge: "gauge", GaugeFn: "gauge",
                 Histogram: "histogram"}
        return [
            {
                "name": name,
                "kind": kinds[type(s)],
                "unit": s.unit,
                "help": s.help,
            }
            for name, s in sorted(self._series.items())
        ]

    def dump(self, path: str) -> None:
        """Write ``{"snapshot": ..., "catalog": ...}`` as JSON."""
        with open(path, "w") as f:
            json.dump(
                {"snapshot": self.snapshot(), "catalog": self.describe()},
                f, indent=1,
            )

    def __contains__(self, name: str) -> bool:
        return name in self._series

    def get(self, name: str) -> Optional[Any]:
        return self._series.get(name)
