"""Reduce a ``torch.profiler`` trace of the traced slice to what the
per-layer metrics read: the device operations by card, each card's busy
time (the union of its operations' intervals) over the slice, and the
idle gaps named by the benchmark's own host span that was open when each
gap began.

The slice is the host span ``SLICE`` that the harness opens around the
profiled batches, their drain included; host spans (``HOST_SPANS``) are
the harness's ``record_function`` ranges around the staging copy, the
executor call, the copy back and the wait.  Device events are the
profiler's CUDA events less its annotations (``ProfilerStep*`` and the
device mirrors of the host ranges).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

SLICE = "perfbench.slice"
HOST_SPANS = ("perfbench.stage", "perfbench.executor", "perfbench.copy_back",
              "perfbench.wait")


@dataclasses.dataclass
class DeviceOp:
    name: str
    card: int
    start_s: float
    end_s: float

    @property
    def seconds(self) -> float:
        return self.end_s - self.start_s


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # the slice's length on the host clock
    busy_s: Dict[int, float]  # card -> union of its operations' intervals in the slice
    ops: List[DeviceOp]
    idle_by_span: Dict[str, float]  # host span -> idle seconds, averaged over the cards
    images: int = 0
    batches: int = 0

    def op_seconds(self, pattern: str) -> float:
        return sum(op.seconds for op in self.ops if pattern in op.name)

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        by: Dict[str, float] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0.0) + op.seconds
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]


def is_copy(name: str) -> bool:
    """A copy or fill done by the copy engines, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _span_at(t: float, spans: List[Tuple[str, float, float]]) -> str:
    """The innermost host span open at ``t``, else "other"."""
    best, best_start = "other", float("-inf")
    for name, s, e in spans:
        if s <= t < e and s > best_start:
            best, best_start = name, s
    return best


def reduce_events(events, cards: List[int]) -> TraceSummary:
    """``events``: the profiler's ``events()`` (``FunctionEvent`` with
    ``name``, ``device_type``, ``device_index``, ``time_range`` in µs and
    ``is_user_annotation``)."""
    from torch.autograd import DeviceType

    slice_span = None
    host: List[Tuple[str, float, float]] = []
    ops: List[DeviceOp] = []
    labels = set(HOST_SPANS) | {SLICE}
    for ev in events:
        name = ev.name
        start, end = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == DeviceType.CPU:
            if name == SLICE:
                slice_span = (start, end)
            elif name in HOST_SPANS:
                host.append((name.split(".", 1)[1], start, end))
            continue
        if ev.device_type != DeviceType.CUDA:
            continue
        if (getattr(ev, "is_user_annotation", False) or name in labels
                or name.startswith("ProfilerStep")):
            continue
        ops.append(DeviceOp(name=name, card=int(ev.device_index), start_s=start, end_s=end))
    if slice_span is None:
        raise RuntimeError(f"the trace holds no {SLICE!r} span")
    s0, s1 = slice_span
    busy: Dict[int, float] = {}
    idle: Dict[str, float] = {}
    for card in cards:
        ivs = _union([(max(op.start_s, s0), min(op.end_s, s1)) for op in ops
                      if op.card == card and op.end_s > s0 and op.start_s < s1])
        busy[card] = sum(e - s for s, e in ivs)
        edges = [s0] + [t for iv in ivs for t in iv] + [s1]
        for gs, ge in zip(edges[0::2], edges[1::2]):
            if ge > gs:
                label = _span_at(gs, host)
                idle[label] = idle.get(label, 0.0) + (ge - gs) / len(cards)
    return TraceSummary(window_s=s1 - s0, busy_s=busy, ops=ops, idle_by_span=idle)
