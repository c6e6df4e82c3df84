"""Compile-time reports: segment coverage, arena timelines, segment timing.

The port's counterpart of ``repro/obs/report.py``.  Reports over any planned
workload, float or int8:

* :func:`segment_report` — one row per compiled segment (kind ``single`` /
  ``scan`` / ``batched`` / ``periodic-scan``, its shape) with a **static
  cost model** per step from the layer specs: MACs (``LayerSpec.macs``) and
  activation bytes moved, so segments can be ranked before anything runs;
* :func:`streaming_report` — the same model for the streaming executor's
  per-frame step (`repro_torch.core.streaming`);
* :func:`arena_timeline` — the planner's buffer lifetimes × offsets played
  back over the schedule: per-position live sets, occupancy, peak and
  fragmentation, plus :func:`ascii_memory_map`.  The peak is derived from
  the buffer table alone and must equal ``plan.arena_bytes``;
* :func:`timed_segments` — each compiled segment run on its own through
  ``pingpong.apply_dag_segment`` (what ``DagArenaExecutor`` runs), timed
  best of ``iters`` with CUDA events on the card (``perf_counter`` on the
  CPU), joined to the static model, and ranked by measured time and by the
  gap between measured share and MAC share.  Opt-in: the barriers between
  segments change the execution the engine runs.

:func:`build_workload` resolves the named workloads to one bundle; every
workload goes through the DAG path (sequential graphs via
``DAGGraph.from_sequential``), so one implementation covers all of them.
"""
from __future__ import annotations

import string
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve

WORKLOADS = ("lenet", "residual_cifar", "ds_cnn", "ds_cnn_kws",
             "mobilenet_v1_025")

_CALIB_BATCH = 16


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def build_workload(name: str, *, int8: bool = False, seed: int = 0, device="cuda",
                   params: Optional[dict] = None) -> dict:
    """Resolve a named workload to a report-ready bundle on ``device``.

    Returns ``{name, dtype, graph, plan, params, apply_node_fn, in_shape,
    make_input}``: ``graph`` is the *fused DAG* the plan names, ``params``
    the executor-ready params on ``device`` (int8: ``int8_params`` of the
    quantized model, also under ``qm``), and ``make_input(rng)`` one
    wire-format input image on ``device``.  Float weights come from
    ``nn.init_params`` with a generator seeded by ``seed``, or from
    ``params`` (the fused graph's names, any device); the int8 calibration
    batch from ``numpy.random.default_rng(seed)``.
    """
    from repro_torch.core import fusion, nn, quantize, schedule
    from repro_torch.core.graph import (DAGGraph, ds_cnn, ds_cnn_kws, lenet5,
                                        mobilenet_v1, residual_cifar)
    from repro_torch.core.pingpong import apply_node

    if name not in WORKLOADS:
        raise ValueError(f"unknown workload {name!r}; pick from {WORKLOADS}")
    dev = resolve(device)
    g = {"lenet": lenet5, "residual_cifar": residual_cifar,
         "ds_cnn": ds_cnn, "ds_cnn_kws": ds_cnn_kws,
         "mobilenet_v1_025": lambda: mobilenet_v1(width=0.25)}[name]()
    if not isinstance(g, DAGGraph):
        g = DAGGraph.from_sequential(g)
    in_shape = tuple(g.nodes[0].layer.shape)
    fused = fusion.fuse_dag(g)
    if params is None:
        params = fusion.rename_params(
            fused, nn.init_params(g, torch.Generator().manual_seed(seed), device="cpu"))
    params_cpu = {k: {kk: (v if isinstance(v, torch.Tensor)
                           else torch.as_tensor(np.array(v))).cpu()
                      for kk, v in p.items()}
                  for k, p in params.items()}

    if not int8:
        def make_input(rng):
            return torch.as_tensor(rng.standard_normal(in_shape), dtype=torch.float32,
                                   device=dev)

        return {"name": name, "dtype": "f32", "graph": fused,
                "plan": schedule.plan_dag(g),
                "params": {k: {kk: v.to(dev) for kk, v in p.items()}
                           for k, p in params_cpu.items()},
                "apply_node_fn": apply_node, "in_shape": in_shape,
                "make_input": make_input}

    from repro_torch.quant.exec import apply_int8_node, int8_params

    calib = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (_CALIB_BATCH, *in_shape)), dtype=torch.float32)
    qm = quantize.quantize_dag(fused, params_cpu, calib)

    def make_input(rng, _qm=qm):
        x = torch.as_tensor(rng.standard_normal(in_shape), dtype=torch.float32,
                            device=dev)
        return quantize.quantize_input(_qm, x)

    return {"name": name, "dtype": "int8", "graph": qm.graph,
            "plan": schedule.plan_dag(g, io_dtype_bytes=1), "qm": qm,
            "params": int8_params(qm, dev), "apply_node_fn": apply_int8_node,
            "in_shape": in_shape, "make_input": make_input}


# ---------------------------------------------------------------------------
# Segment-compiler coverage + static cost model
# ---------------------------------------------------------------------------


def _segment_kind(seg) -> str:
    if seg.batched:
        return "batched"
    if seg.periodic:
        return "periodic-scan"
    if seg.length > 1:
        return "scan"
    return "single"


def _step_cost(step, dtype_bytes: int) -> dict:
    """Static cost of one materialized step: MACs from the layer spec at its
    scheduled input shape, bytes = activations read + written (weights
    excluded: they live in flash, not the arena)."""
    macs = step.layer.macs(step.in_shapes[0]) if step.in_shapes else 0
    bytes_in = sum(_prod(sh) for sh in step.in_shapes) * dtype_bytes
    bytes_out = _prod(step.out_shape) * dtype_bytes
    return {
        "step": step.name,
        "layer": step.layer.kind,
        "out_shape": list(step.out_shape),
        "macs": int(macs),
        "bytes_in": int(bytes_in),
        "bytes_out": int(bytes_out),
    }


def segment_report(graph, plan, *, batch_branches: bool = True) -> dict:
    """Per-segment coverage + static MAC/byte cost model for (graph, plan)."""
    from repro_torch.core import segments as segments_mod

    mat, order, segs = segments_mod.segments_for_plan(
        graph, plan, batch_branches=batch_branches)
    steps = {s.name: s for s in mat.steps}
    db = plan.io_dtype_bytes

    rows: List[dict] = []
    for i, seg in enumerate(segs):
        step_rows = [_step_cost(steps[nm], db) for br in seg.branches for nm in br]
        rows.append({
            "index": i,
            "kind": _segment_kind(seg),
            "n_branches": seg.n_branches,
            "length": seg.length,
            "period": seg.period,
            "steps_total": seg.steps_per_branch * seg.n_branches,
            "first": seg.branches[0][0],
            "last": seg.branches[0][-1],
            "macs": int(sum(r["macs"] for r in step_rows)),
            "bytes_moved": int(sum(r["bytes_in"] + r["bytes_out"] for r in step_rows)),
            "steps": step_rows,
        })

    by_kind: Dict[str, int] = {}
    for r in rows:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0) + 1
    return {
        "strategy": plan.strategy,
        "io_dtype_bytes": db,
        "schedule_len": len(order),
        "n_segments": len(rows),
        "segments_by_kind": by_kind,
        "total_macs": int(sum(r["macs"] for r in rows)),
        "total_bytes_moved": int(sum(r["bytes_moved"] for r in rows)),
        "segments": rows,
    }


# ---------------------------------------------------------------------------
# Streaming cost model (per-frame MACs of the ring-buffer executor)
# ---------------------------------------------------------------------------


def streaming_report(graph, splan=None) -> dict:
    """Static per-frame cost model of the streaming executor.

    Per emission, backbone layer ℓ computes ``new_rows + top + bottom``
    output rows; MACs a row come from the layer spec (``layer.macs`` is
    proportional to output rows, so the division is exact).  Head layers
    recompute full-window.  Emissions come every ``emit_stride`` frames, so
    the per-frame cost is the per-emission cost over the stride: for
    ``ds_cnn()`` 775,360 MACs an emission, 387,680 a frame, 15.3% of the
    2,539,840 full-window MACs.
    """
    from repro_torch.core import streaming as streaming_mod
    from repro_torch.core.graph import as_sequential
    from repro_torch.core.planner import materialized_steps

    if splan is None:
        splan = streaming_mod.plan_streaming(graph)
    seq = as_sequential(graph, caller="streaming_report")
    _, steps = materialized_steps(seq)
    db = splan.plan.io_dtype_bytes

    rows: List[dict] = []
    per_emission = 0
    for spec, (layer, _views, in_sh, _out_sh) in zip(splan.rings, steps):
        macs_per_row = layer.macs(in_sh) // spec.height
        macs = macs_per_row * (spec.new_rows + spec.top + spec.bottom)
        per_emission += macs
        rows.append({
            "step": spec.name,
            "layer": spec.kind,
            "ring_rows": spec.rows,
            "new_rows": spec.new_rows,
            "edge_rows": spec.top + spec.bottom,
            "ring_bytes": spec.ring_elems * db,
            "macs_per_row": int(macs_per_row),
            "macs_per_emission": int(macs),
        })
    head_rows: List[dict] = []
    for layer, _views, in_sh, out_sh in steps[len(splan.rings):]:
        macs = layer.macs(in_sh)
        per_emission += macs
        head_rows.append({
            "step": layer.name or layer.kind,
            "layer": layer.kind,
            "out_shape": list(out_sh),
            "macs_per_emission": int(macs),
        })

    full = sum(layer.macs(in_sh) for layer, _v, in_sh, _o in steps)
    e = splan.emit_stride
    per_frame = per_emission / e
    return {
        "strategy": splan.plan.strategy,
        "io_dtype_bytes": db,
        "emit_stride": e,
        "full_window_macs": int(full),
        "per_emission_macs": int(per_emission),
        "per_frame_macs": int(per_frame),
        "per_frame_frac": round(per_frame / full, 4) if full else 0.0,
        "ring_arena_bytes": int(splan.plan.arena_bytes),
        "ring_state_bytes": int(splan.ring_elems * db),
        "rings": rows,
        "head": head_rows,
    }


# ---------------------------------------------------------------------------
# Arena memory timeline
# ---------------------------------------------------------------------------


def arena_timeline(plan) -> dict:
    """Play the plan's buffer lifetimes over the schedule.

    For each schedule position: the live buffers, the bytes they occupy and
    the highest occupied address.  ``peak_bytes`` is the largest of those
    addresses, from the buffer table alone, so it cross-checks the
    planner's ``arena_bytes``.  Fragmentation at a position is the share of
    the occupied address range that holds no live buffer.
    """
    db = plan.io_dtype_bytes
    bufs = [b for b in plan.buffers if b.bank != "scratch"]
    n_pos = max((b.live_until for b in bufs), default=-1) + 1

    positions = []
    peak_elems = 0
    for t in range(n_pos):
        live = [b for b in bufs if b.live_from <= t <= b.live_until]
        top = max((b.offset_elems + b.size_elems for b in live), default=0)
        live_elems = sum(b.size_elems for b in live)
        peak_elems = max(peak_elems, top)
        positions.append({
            "pos": t,
            "step": plan.buffers[t].name if t < len(plan.buffers) else "",
            "live": [b.name for b in live],
            "live_bytes": live_elems * db,
            "top_bytes": top * db,
            "frag_frac": round(1.0 - live_elems / top, 4) if top else 0.0,
        })

    return {
        "strategy": plan.strategy,
        "io_dtype_bytes": db,
        "arena_bytes": int(plan.arena_bytes),
        "scratch_bytes": int(plan.scratch_elems * db),
        "peak_bytes": int(peak_elems * db),
        "peak_pos": int(max(range(len(positions)),
                            key=lambda t: positions[t]["top_bytes"])
                        if positions else 0),
        "max_frag_frac": max((p["frag_frac"] for p in positions), default=0.0),
        "buffers": [{
            "name": b.name, "kind": b.kind, "bank": b.bank,
            "offset_bytes": b.offset_elems * db,
            "size_bytes": b.size_elems * db,
            "live_from": b.live_from, "live_until": b.live_until,
        } for b in bufs],
        "positions": positions,
    }


def ascii_memory_map(plan, width: int = 64) -> str:
    """Rows = schedule positions, columns = arena addresses (scaled to
    ``width`` chars); each live buffer renders as a letter at its planned
    offset, ``.`` is free arena.  The rightmost column edge is the arena
    end, so a full-width row *is* the peak."""
    db = plan.io_dtype_bytes
    bufs = [b for b in plan.buffers if b.bank != "scratch"]
    arena = max(int(plan.arena_elems), 1)
    letters = string.ascii_uppercase + string.ascii_lowercase
    n_pos = max((b.live_until for b in bufs), default=-1) + 1

    lines = [
        f"arena {plan.arena_bytes} B ({plan.strategy}, "
        f"{db} B/elem); one row per schedule position",
        f"    0{'-' * (width - 9)}{plan.arena_bytes:>7} B",
    ]
    for t in range(n_pos):
        row = ["."] * width
        for j, b in enumerate(bufs):
            if not (b.live_from <= t <= b.live_until):
                continue
            c0 = b.offset_elems * width // arena
            c1 = max(c0 + 1, (b.offset_elems + b.size_elems) * width // arena)
            ch = letters[j % len(letters)]
            for c in range(c0, min(c1, width)):
                row[c] = ch
        step = plan.buffers[t].name if t < len(plan.buffers) else ""
        lines.append(f"{t:3d} {''.join(row)} {step}")
    legend = ", ".join(f"{letters[j % len(letters)]}={b.name}" for j, b in enumerate(bufs))
    lines.append(f"legend: {legend}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Per-segment timing (opt-in)
# ---------------------------------------------------------------------------


def _best_s(fn, iters: int, cuda: bool) -> float:
    """Best of ``iters`` calls of ``fn``, in seconds: CUDA events around
    each call on the card, ``perf_counter`` on the CPU."""
    best = float("inf")
    for _ in range(iters):
        if cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def timed_segments(bundle: dict, *, iters: int = 5, seed: int = 0) -> dict:
    """Measure each compiled segment on its own, joined to the static model.

    Each segment runs through ``pingpong.apply_dag_segment`` (the function
    ``DagArenaExecutor`` runs it with) on a batch of one, fed the real
    intermediate values, once to warm, then timed best of ``iters``.  The
    join ranks segments by measured time and by the gap between the
    measured share and the static-MAC share (a segment whose measured share
    far exceeds its MAC share is memory-, launch- or host-bound).
    """
    from repro_torch.core import pingpong
    from repro_torch.core import segments as segments_mod

    graph, plan = bundle["graph"], bundle["plan"]
    apply_fn = bundle["apply_node_fn"]
    params = bundle["params"]
    mat, order, segs = segments_mod.segments_for_plan(graph, plan)
    steps = {s.name: s for s in mat.steps}
    static = segment_report(graph, plan)

    x = bundle["make_input"](np.random.default_rng(seed))[None]
    first = steps[order[0]]
    vals = {order[0]: pingpong.run_step(apply_fn, first, {}, [x]) if first.views else x}
    cuda = x.device.type == "cuda"

    rows = []
    for i, seg in enumerate(segs):
        def fn(_seg=seg):
            return pingpong.apply_dag_segment(steps, _seg, params, vals,
                                              apply_node_fn=apply_fn)

        out = fn()  # warm: kernel builds, first launches
        if cuda:
            torch.cuda.synchronize(x.device)
        best = _best_s(fn, iters, cuda)
        vals.update(out)
        srow = static["segments"][i]
        rows.append({
            "index": i, "kind": srow["kind"],
            "first": srow["first"], "last": srow["last"],
            "macs": srow["macs"], "bytes_moved": srow["bytes_moved"],
            "measured_s": best,
        })

    total_s = sum(r["measured_s"] for r in rows) or 1.0
    total_macs = static["total_macs"] or 1
    for r in rows:
        r["measured_frac"] = round(r["measured_s"] / total_s, 4)
        r["model_frac"] = round(r["macs"] / total_macs, 4)
        r["discrepancy"] = round(r["measured_frac"] - r["model_frac"], 4)
    return {
        "iters": iters,
        "clock": "cuda-events" if cuda else "perf_counter",
        "total_s": total_s,
        "total_macs": static["total_macs"],
        "by_time": sorted(rows, key=lambda r: -r["measured_s"]),
        "by_discrepancy": sorted(rows, key=lambda r: -abs(r["discrepancy"])),
    }


# ---------------------------------------------------------------------------
# One-call assembly
# ---------------------------------------------------------------------------


def workload_report(name: str, *, int8: bool = False, timed: bool = False,
                    iters: int = 5, device="cuda") -> dict:
    """All reports for one (workload, dtype) config as one JSON-ready dict;
    ``timed=True`` adds the per-segment timing section."""
    bundle = build_workload(name, int8=int8, device=device)
    report = {
        "workload": name,
        "dtype": bundle["dtype"],
        "segments": segment_report(bundle["graph"], bundle["plan"]),
        "arena": arena_timeline(bundle["plan"]),
    }
    if timed:
        report["timing"] = timed_segments(bundle, iters=iters)
    return report
