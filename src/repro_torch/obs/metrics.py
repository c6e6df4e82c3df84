"""Counters / gauges / histograms with JSON snapshot export.

Framework-free copy of ``repro/obs/metrics.py``.

A :class:`MetricsRegistry` is a flat, thread-safe namespace of named
instruments.  The serving engines each own a private registry (so two
engines in one process don't mix their cache stats); executor-level caches
(`cache_fifo`, the AOT bucket ladder) report into the process-global
:data:`REGISTRY` unless handed one explicitly.

Instruments are deliberately minimal:

* :class:`Counter`   — monotonically increasing float/int (``inc``).
* :class:`Gauge`     — last-write-wins value (``set``), plus the observed
  min/max so a sampled gauge (queue depth) still shows its envelope.
* :class:`Histogram` — append-only sample list with bounded reservoir
  (keeps the first ``cap`` samples + running count/sum/min/max), and
  percentile queries.  Used for latencies and lowering times.

``registry.snapshot()`` returns a plain-JSON dict; ``registry.dump(path)``
writes it.  No background threads, no global sampling loop — callers
instrument their own hot paths explicitly.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Optional, Union


class Counter:
    """Monotonic counter.  ``inc`` under the owning registry's lock."""

    kind = "counter"

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def to_json(self):
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins value plus the min/max envelope seen so far."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def to_json(self):
        return {"kind": self.kind, "value": self.value,
                "min": self.min, "max": self.max}


class Histogram:
    """Bounded-reservoir histogram: keeps the first ``cap`` samples verbatim
    (enough for every workload in this repo) plus running aggregates, so an
    unbounded stream can't grow memory without bound."""

    kind = "histogram"

    def __init__(self, cap: int = 4096) -> None:
        self.cap = int(cap)
        self.samples: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self.samples) < self.cap:
            self.samples.append(v)

    def percentile(self, pct: float) -> float:
        """Nearest-rank percentile over the retained samples; 0.0 when no
        samples have been observed (same contract as ServeStats.latency_ms)."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        i = min(len(xs) - 1, max(0, int(round(pct / 100.0 * (len(xs) - 1)))))
        return xs[i]

    def to_json(self):
        return {
            "kind": self.kind, "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Thread-safe flat namespace of instruments.

    ``counter/gauge/histogram(name)`` are get-or-create and idempotent;
    asking for an existing name with a different kind raises.  All
    instrument mutation helpers (``inc``/``set_gauge``/``observe``) take the
    registry lock so cross-thread updates (dispatcher vs completer) are
    safe.
    """

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, name: str, cls, **kwargs) -> Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(**kwargs)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is a {inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        return self._get(name, Histogram, cap=cap)

    # -- convenience mutators (lock-protected) ---------------------------
    def inc(self, name: str, n: float = 1) -> None:
        c = self.counter(name)
        with self._lock:
            c.inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        g = self.gauge(name)
        with self._lock:
            g.set(v)

    def observe(self, name: str, v: float) -> None:
        h = self.histogram(name)
        with self._lock:
            h.observe(v)

    def value(self, name: str):
        """Current value of a counter/gauge (None if the name is unknown)."""
        with self._lock:
            inst = self._instruments.get(name)
            return None if inst is None else getattr(inst, "value", None)

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """A consistent plain-JSON view of every instrument."""
        with self._lock:
            return {name: inst.to_json()
                    for name, inst in sorted(self._instruments.items())}

    def dump(self, path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.snapshot(), indent=1, sort_keys=True)
                        + "\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()


#: Process-global default registry: executor-level caches report here.
REGISTRY = MetricsRegistry("global")
