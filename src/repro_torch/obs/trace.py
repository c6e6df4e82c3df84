"""Thread-safe span tracer with Chrome trace-event JSON export.

Framework-free copy of ``repro/obs/trace.py``.

Design constraints (DESIGN.md §11):

* **Low overhead, true no-op when disabled.**  ``tracer.span(...)`` on a
  disabled tracer returns a shared singleton context manager whose
  ``__enter__``/``__exit__`` do nothing and take no lock; ``instant``/
  ``counter``/``async_begin``/``async_end`` early-return on one attribute
  check.  The serving engines read ``self.tracer.enabled`` once per event,
  so a traced-off engine stays within noise of an untraced one.
* **Monotonic clocks.**  All timestamps come from ``time.monotonic()``;
  export rebases to the tracer's construction time so ``ts`` starts near 0.
* **Bounded ring buffer.**  At most ``cap`` events are retained (oldest
  dropped first, ``dropped`` counts them) so a long-running engine cannot
  grow memory without bound.
* **Chrome trace-event JSON.**  ``export()`` emits the
  ``{"traceEvents": [...]}`` object format understood by Perfetto
  (https://ui.perfetto.dev) and chrome://tracing.  Spans on a thread are
  duration events (``ph: "X"``, microsecond ``ts``/``dur``); request
  lifetimes — which overlap freely across one thread — are async events
  (``ph: "b"``/``"e"`` with an ``id``); gauges are counter events
  (``ph: "C"``); thread names are metadata events (``ph: "M"``).

Span taxonomy used by the serving layer (args carry batch id / bucket /
lane): ``request`` (async, one per rid, queued→done), ``coalesce``,
``stage``, ``dispatch`` (dispatcher thread), ``device``, ``complete``
(completer thread), ``prefill``/``decode`` (LLM engine).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Optional


class _NullSpan:
    """Shared do-nothing context manager returned by disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one complete ("X") duration event."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        self._tracer._record({
            "ph": "X", "name": self.name,
            "ts": self._tracer._us(self._t0),
            "dur": max(0, round((t1 - self._t0) * 1e6)),
            "tid": threading.get_ident(),
            **({"args": self.args} if self.args else {}),
        })
        return False


class Tracer:
    """Bounded, thread-safe span/counter recorder.

    One tracer per traced component (a serving engine run, a report pass).
    All mutation and export happen under one lock; the disabled path takes
    no lock at all.
    """

    def __init__(self, enabled: bool = True, cap: int = 65536,
                 pid: int = 1, process_name: str = "repro"):
        self.enabled = enabled
        self.cap = int(cap)
        self.pid = pid
        self.process_name = process_name
        self._epoch = time.monotonic()
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.cap)
        self.dropped = 0
        self._thread_names: dict = {}

    # -- recording -------------------------------------------------------
    def _us(self, t: float) -> int:
        return max(0, round((t - self._epoch) * 1e6))

    def _record(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self.cap:
                self.dropped += 1
            self._events.append(ev)

    def span(self, name: str, **args):
        """``with tracer.span("stage", batch=3, bucket=8): ...`` — a "X"
        duration event on the calling thread.  No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def complete(self, name: str, t0: float, t1: Optional[float] = None,
                 **args) -> None:
        """Record an "X" span retroactively from monotonic timestamps —
        for spans whose start is only known to be interesting after the
        fact (e.g. ``coalesce``: the wait for the *first* request of a
        batch is idle time, not span time)."""
        if not self.enabled:
            return
        t1 = time.monotonic() if t1 is None else t1
        self._record({
            "ph": "X", "name": name,
            "ts": self._us(t0),
            "dur": max(0, round((t1 - t0) * 1e6)),
            "tid": threading.get_ident(),
            **({"args": args} if args else {}),
        })

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._record({
            "ph": "i", "name": name, "s": "t",
            "ts": self._us(time.monotonic()),
            "tid": threading.get_ident(),
            **({"args": args} if args else {}),
        })

    def counter(self, name: str, **series) -> None:
        """A "C" counter sample, e.g. ``tracer.counter("queue", depth=4)``.
        Perfetto renders each kwarg as one series on the counter track."""
        if not self.enabled:
            return
        self._record({
            "ph": "C", "name": name,
            "ts": self._us(time.monotonic()),
            "tid": threading.get_ident(),
            "args": {k: float(v) for k, v in series.items()},
        })

    def async_begin(self, name: str, aid, **args) -> None:
        """Begin an async ("b") span: overlapping lifetimes (one per request)
        that can't nest on a single thread track."""
        if not self.enabled:
            return
        self._record({
            "ph": "b", "cat": name, "name": name, "id": str(aid),
            "ts": self._us(time.monotonic()),
            "tid": threading.get_ident(),
            **({"args": args} if args else {}),
        })

    def async_end(self, name: str, aid, **args) -> None:
        if not self.enabled:
            return
        self._record({
            "ph": "e", "cat": name, "name": name, "id": str(aid),
            "ts": self._us(time.monotonic()),
            "tid": threading.get_ident(),
            **({"args": args} if args else {}),
        })

    def name_thread(self, label: str) -> None:
        """Label the calling thread's track in the exported trace."""
        if not self.enabled:
            return
        with self._lock:
            self._thread_names[threading.get_ident()] = label

    # -- introspection / export ------------------------------------------
    def events(self):
        """A consistent copy of the retained events (for tests)."""
        with self._lock:
            return list(self._events)

    def spans(self, name: Optional[str] = None):
        """Completed "X" spans, optionally filtered by name, each as
        ``(ts_us, dur_us, event)`` sorted by start time."""
        out = [(e["ts"], e["dur"], e) for e in self.events()
               if e["ph"] == "X" and (name is None or e["name"] == name)]
        return sorted(out, key=lambda t: t[0])

    def export(self) -> dict:
        """The Chrome trace-event object: ``{"traceEvents": [...]}``."""
        with self._lock:
            events = list(self._events)
            tnames = dict(self._thread_names)
        out = []
        out.append({"ph": "M", "name": "process_name", "pid": self.pid,
                    "tid": 0, "ts": 0,
                    "args": {"name": self.process_name}})
        for tid, label in sorted(tnames.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                        "tid": tid, "ts": 0, "args": {"name": label}})
        for ev in events:
            out.append({"pid": self.pid, **ev})
        meta = {"dropped_events": self.dropped,
                "retained_events": len(events)}
        return {"traceEvents": out, "otherData": meta}

    def dump(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.export()) + "\n")
        return path


#: Shared disabled tracer: the default for every engine, so the untraced
#: hot path costs one attribute check per would-be event.
NULL_TRACER = Tracer(enabled=False, cap=1)


def validate_chrome_trace(trace: dict) -> None:
    """Assert ``trace`` is structurally valid Chrome trace-event JSON.

    Checks (raises ``AssertionError`` with a specific message):

    * the ``{"traceEvents": [...]}`` object form;
    * every event has ``ph``/``pid``/``tid``/``ts``, a known phase, and
      ``name``;
    * "X" events have a non-negative integer ``dur``;
    * on each (pid, tid) track the "X" spans are *properly nested*: sorted
      by start, every pair either nests or is disjoint (Perfetto renders a
      partial overlap as a corrupt track);
    * every async "b" has a matching "e" with the same (cat, id), begun
      before ended.

    Used by tests and the CI bench-smoke guard on exported artifacts.
    """
    assert isinstance(trace, dict) and "traceEvents" in trace, \
        "trace must be the {'traceEvents': [...]} object form"
    events = trace["traceEvents"]
    assert isinstance(events, list) and events, "traceEvents empty"

    known = {"X", "B", "E", "i", "I", "C", "b", "e", "n", "M", "m"}
    tracks: dict = {}
    async_open: dict = {}
    for i, ev in enumerate(events):
        for field in ("ph", "pid", "tid", "ts", "name"):
            assert field in ev, f"event {i} missing {field!r}: {ev}"
        assert ev["ph"] in known, f"event {i} unknown phase {ev['ph']!r}"
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0, \
            f"event {i} bad ts {ev['ts']!r}"
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), (int, float)) \
                and ev["dur"] >= 0, f"event {i} 'X' bad dur: {ev}"
            tracks.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        elif ev["ph"] == "b":
            assert "id" in ev, f"event {i} async 'b' missing id"
            async_open.setdefault(
                (ev.get("cat", ""), ev["id"]), []).append(ev["ts"])
        elif ev["ph"] == "e":
            assert "id" in ev, f"event {i} async 'e' missing id"
            key = (ev.get("cat", ""), ev["id"])
            assert async_open.get(key), \
                f"event {i} async 'e' with no open 'b' for {key}"
            t0 = async_open[key].pop()
            assert ev["ts"] >= t0, f"async span {key} ends before it begins"

    leftovers = {k: v for k, v in async_open.items() if v}
    assert not leftovers, f"async spans never ended: {sorted(leftovers)}"

    for (pid, tid), spans in tracks.items():
        spans.sort()
        stack: list = []  # (start, end) of currently-open enclosing spans
        for t0, t1, nm in spans:
            while stack and t0 >= stack[-1][1]:
                stack.pop()
            if stack:
                assert t1 <= stack[-1][1], (
                    f"track (pid={pid}, tid={tid}): span {nm!r} "
                    f"[{t0},{t1}] partially overlaps enclosing "
                    f"[{stack[-1][0]},{stack[-1][1]}]")
            stack.append((t0, t1))
