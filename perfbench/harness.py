"""One run of one cell: set-up, the loop (warm-up, the measured window and
the traced slice), the comparison with the plain reference, and the result
line.

The cell and everything it is made of are found by the names
``BENCHMARK.json`` and their files give them; a later cell brings its
own files and edits none of these:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  the network, and under ``"system"`` its kind;
* ``systems/<system>.py``: the kind's set-up from the seed (``prepare``,
  ``inputs``, ``out_shape``), the system under test built through the
  port's public API (``build``), its plain reference (``reference_fn``),
  the control (``control``) and the counts its readers use
  (``macs_per_image``, ``kernel_bound_s``, ``runs_kernel``);
* ``traffic/<traffic>.json``: a traffic mix's parameters, and under
  ``"loop"`` the generator that reads them;
* ``loops/<loop>.py``: a generator, ``pool_rows(traffic)`` and
  ``run(LoopContext) -> LoopResult``;
* ``metrics/<metric>.py``: a reader ``read(record) -> float | None`` of
  the :class:`Record` of the run; ``None`` leaves the metric out.

The comparison is the harness's own: every output row the window
completed against the reference's output for the same input row.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import trace as tracing

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class MetricError(RuntimeError):
    """A reader found the run unable to give its metric (a kernel the cell
    runs has no device record): the run fails."""


# ---------------------------------------------------------------------------
# Resolution: names in BENCHMARK.json -> files
# ---------------------------------------------------------------------------

def load_module(root: Path, folder: str, name: str) -> ModuleType:
    """``perfbench/<folder>/<name>.py`` under ``root``."""
    path = root / "perfbench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{folder[:-1]} {name!r}: no module at {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up while it runs
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, name: str) -> Callable:
    return load_module(root, "metrics", name).read


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable[["Record"], Optional[float]]


@dataclasses.dataclass
class Cell:
    name: str
    net: dict
    traffic: dict
    chips: int
    system: ModuleType
    loop: ModuleType
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its files loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    net = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())

    def metrics(key):
        return [Metric(m["name"], m["unit"], load_reader(root, m["name"]))
                for m in bench[key] if _applies(m, name)]

    return Cell(name=name, net=net, traffic=traffic, chips=int(w["chips"]),
                system=load_module(root, "systems", net["system"]),
                loop=load_module(root, "loops", traffic["loop"]),
                end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"))


# ---------------------------------------------------------------------------
# What a loop is given and gives back
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoopContext:
    run: Callable  # (params, x) -> y: the timed path, x and y on devices[0]
    params: object
    pool: torch.Tensor  # the seeded input rows, in pinned host memory on a card
    out_shape: Tuple[int, ...]  # an output row's shape
    traffic: dict
    devices: List[torch.device]
    seconds: float
    trace: bool
    window_opens: Callable[[], None]  # call as the window opens


@dataclasses.dataclass
class LoopResult:
    setup_end: float  # perf_counter once the warm-up has drained
    rows_per_call: int  # rows of one executor call over the whole mesh
    window_s: float = 0.0
    outputs: List[Tuple[int, np.ndarray]] = dataclasses.field(default_factory=list)
    host_call_s: List[float] = dataclasses.field(default_factory=list)
    calls: int = 0  # executor calls completed in the window
    dispatched_rows: int = 0
    trace: Optional[tracing.TraceSummary] = None  # with ``images`` and ``batches`` set


def sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def profile_slice(devices, warm: Callable[[], None], body: Callable[[], None]
                  ) -> tracing.TraceSummary:
    """Profile ``body`` inside the span ``tracing.SLICE``, after ``warm``,
    which the profiler traces and drops (a kernel launched as tracing
    starts can go unrecorded)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        sync(devices)
        prof.step()
        with record_function(tracing.SLICE):
            body()
        prof.step()
    cards = sorted({d.index if d.index is not None else 0 for d in devices})
    return tracing.reduce_events(prof.events(), cards)


# ---------------------------------------------------------------------------
# What the readers read
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Record:
    """Everything a metric reader may read of one run."""
    platform: str  # "gpu" or "cpu" (a rehearsal: no device metric)
    chips: int
    net: dict
    batch: int  # rows of one executor call, over the whole mesh
    setup_s: float
    window_s: float
    images: int  # rows whose outputs reached host memory in the window
    batches: int
    host_call_s: List[float]  # host seconds of each counted executor call
    busy_span_s: Dict[int, float]  # card -> sum of its shard calls' CUDA-event spans
    readings: dict  # what the system under test read of itself (``System.readings``)
    trace: Optional[tracing.TraceSummary] = None
    system: Optional[ModuleType] = None  # the kind's module, for its counts

    def _count(self, name: str):
        fn = getattr(self.system, name, None)
        if fn is None:
            raise MetricError(f"the system kind has no {name}")
        return fn

    @property
    def macs_per_image(self) -> int:
        return self._count("macs_per_image")(self.net)

    def kernel_bound_s(self, kernel: str, batches: int) -> float:
        """Least seconds of ``kernel`` over ``batches`` batches, one launch a
        layer a card over that card's shard."""
        per_card = self.batch // self.chips
        return self._count("kernel_bound_s")(self.net, kernel, per_card) * self.chips * batches

    def runs_kernel(self, kernel: str) -> bool:
        fn = getattr(self.system, "runs_kernel", None)
        return bool(fn and fn(self.net, kernel))


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Result:
    correct: bool
    line: dict
    checks: Dict[str, dict]


def power_limit() -> Optional[str]:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip().replace("\n", "; ") or None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices: List[torch.device],
             t_start: float, timed: Optional[Callable] = None) -> Result:
    """One run of ``cell`` on ``devices`` (its first device stages and
    gathers).  ``timed``, when given, replaces the port on the timed path:
    ``timed(net, data, device)`` returns the ``(params, x) -> y`` the window
    drives (the control of :mod:`perfbench.control`)."""
    net, kind = cell.net, cell.system
    dev0 = devices[0]
    cuda = dev0.type == "cuda"

    # -- set-up: what both sides get, from the seed; the system under test ------------
    phases = {"imports": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def phase(name, now=None):
        nonlocal mark
        now = time.perf_counter() if now is None else now
        phases[name] = now - mark
        mark = now

    gen = torch.Generator(device=dev0)
    gen.manual_seed(seed)
    data = kind.prepare(net, gen, dev0)
    phase("weights_and_calibration_batch")
    pool = kind.inputs(net, data, cell.loop.pool_rows(cell.traffic), gen, dev0)
    phase("input_pool")

    spans: list = []
    sut = None
    if timed is None:
        sut = kind.build(net, data, devices, spans)
        run, params = sut.run, sut.params
    else:
        run, params = timed(net, data, dev0), None
    phase("model_plan_executor")

    res = cell.loop.run(LoopContext(
        run=run, params=params, pool=pool, out_shape=tuple(kind.out_shape(net)),
        traffic=cell.traffic, devices=devices, seconds=seconds, trace=trace,
        window_opens=spans.clear))
    phase("warm_up", res.setup_end)
    setup_s = res.setup_end - t_start

    shards = len(devices) if len(devices) > 1 else 1
    busy: Dict[int, float] = {}
    for card, a, b in spans[:res.calls * shards]:
        busy[card] = busy.get(card, 0.0) + a.elapsed_time(b) / 1e3

    readings = sut.readings() if sut is not None else {}
    checks: Dict[str, dict] = sut.checks(readings) if sut is not None else {}
    peak = max((torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(devices)
                if d.type == "cuda"), default=0)
    if sut is not None:
        sut.close()
    del run, params, sut, spans
    if cuda:
        torch.cuda.empty_cache()

    # -- the comparison with the plain reference -------------------------------------
    # Every output row of the window, against the reference over the same input
    # rows; the reference runs once over each distinct range of pool rows.
    ref = kind.reference_fn(net, data, dev0)
    want: Dict[Tuple[int, int], np.ndarray] = {}
    wrong_values = wrong_rows = rows = 0
    for start, got in res.outputs:
        key = (start, len(got))
        if key not in want:
            want[key] = ref(pool[start:start + len(got)]).cpu().numpy()
        diff = (got != want[key]).reshape(len(got), -1)
        wrong_values += int(diff.sum())
        wrong_rows += int(diff.any(axis=1).sum())
        rows += len(got)
    del ref, want

    checks = {"mismatched_values": {"value": wrong_values, "limit": 0, "rule": "<="},
              "rows_compared": {"value": rows, "limit": max(rows, 1), "rule": ">="},
              **checks}
    correct = all(_passes(c) for c in checks.values())

    rec = Record(platform="gpu" if cuda else "cpu", chips=len(devices), net=net,
                 batch=res.rows_per_call, setup_s=setup_s, window_s=res.window_s, images=rows,
                 batches=res.calls, host_call_s=res.host_call_s, busy_span_s=busy,
                 readings=readings, trace=res.trace, system=kind)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(rec)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}

    device = {"platform": rec.platform,
              "kind": torch.cuda.get_device_name(dev0) if cuda else "cpu",
              "count": len(dict.fromkeys(devices)),
              "memory_peak_bytes": int(peak)}
    if cuda:
        device["power_limit"] = power_limit()
    line = {"correct": correct, "attempted": res.dispatched_rows, "failed": wrong_rows,
            "metrics": metrics, "device": device}
    summary = res.trace
    if summary is not None:
        device["busy_s"] = sum(summary.busy_s.values()) / len(summary.busy_s)
        device["window_s"] = summary.window_s
        line["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in summary.top_ops(10)],
            "idle_gaps": sorted(([k, v] for k, v in summary.idle_by_span.items()),
                                key=lambda kv: -kv[1])[:10]}
    line["setup_phases_s"] = phases
    line["checks"] = checks
    return Result(correct=correct, line=line, checks=checks)


def _passes(check: dict) -> bool:
    v, lim, rule = check["value"], check["limit"], check["rule"]
    return v <= lim if rule == "<=" else v >= lim if rule == ">=" else v == lim


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def emit(result: Result) -> None:
    for name, c in result.checks.items():
        print(f"check {name}: {c['value']} (limit {c['rule']} {c['limit']})", file=sys.stderr)
    print(json.dumps(result.line), flush=True)
