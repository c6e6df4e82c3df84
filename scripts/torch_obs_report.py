"""Dump the port's observability reports for the named workloads.

The port's counterpart of ``scripts/obs_report.py``.  For each requested
(workload, dtype) config this writes, under ``--out``:

  * ``<config>.segments.json`` — segment coverage + static MAC/byte cost
    model (``repro_torch.obs.report.segment_report``),
  * ``<config>.arena.json``    — arena memory timeline (peak must equal the
    planner's arena bytes — asserted here, not just reported),
  * ``<config>.arena.txt``     — the ASCII memory map,
  * ``<config>.trace.json``    — a Chrome trace of one traced serving burst
    through the continuous-batching engine (open in https://ui.perfetto.dev),
    schema-validated before writing,

plus a combined ``obs_report.json`` with every config's summary.  With
``--timed`` the per-segment timing mode runs too (each segment on its own,
timed with CUDA events on the card: kernels K1-K4 — measures segments, not
the pipelined engine).

    python scripts/torch_obs_report.py [WORKLOAD ...]
        [--int8 | --f32] [--timed] [--no-trace] [--out OUTDIR] [--device cuda|cpu]

``scripts/torch_obs_report.py ds_cnn --int8`` asserts what the reference's
CI invocation does: valid Perfetto trace + MAC total 2,539,840 + 16000 B
arena peak.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

# ds_cnn hand-verified totals (tests/test_obs.py derives them layer by
# layer): conv1 200_000 + 4x(dw 72_000 + pw 512_000) + fc 3_840.
DS_CNN_MACS = 2_539_840
DS_CNN_INT8_ARENA_B = 16_000


def serving_trace(bundle, device, n_requests: int = 24):
    """One traced burst through the CNN engine on ``device``; returns the
    trace dict."""
    import torch

    from repro_torch.core import pingpong
    from repro_torch.obs.trace import Tracer, validate_chrome_trace
    from repro_torch.quant.exec import apply_int8_node
    from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy

    if bundle["dtype"] == "int8":
        fn = pingpong.make_dag_executor(
            bundle["graph"], bundle["plan"], apply_node_fn=apply_int8_node)
        dtype = torch.int8
    else:
        fn = pingpong.make_dag_executor(bundle["graph"], bundle["plan"])
        dtype = torch.float32
    tracer = Tracer(process_name=f"{bundle['name']}.{bundle['dtype']}")
    eng = CNNEngine(
        fn, bundle["params"], bundle["in_shape"], dtype, device=device,
        buckets=(1, 4, 8), policy=CoalescePolicy(max_batch=8),
        tracer=tracer,
    )
    rng = np.random.default_rng(7)
    xs = np.stack([bundle["make_input"](rng).cpu().numpy()
                   for _ in range(n_requests)])
    with eng:
        eng.serve(xs)
    trace = tracer.export()
    validate_chrome_trace(trace)
    return trace


def main(argv=None) -> None:
    from repro_torch.device import resolve
    from repro_torch.kernels import launch_counts
    from repro_torch.obs import report as rep

    ap = argparse.ArgumentParser()
    ap.add_argument("workloads", nargs="*", default=None,
                    help=f"subset of {rep.WORKLOADS} (default: all)")
    ap.add_argument("--int8", action="store_true", help="int8 configs only")
    ap.add_argument("--f32", action="store_true", help="float configs only")
    ap.add_argument("--timed", action="store_true",
                    help="add per-segment device timing (slower)")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the traced serving burst")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="obs_reports")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    names = args.workloads or list(rep.WORKLOADS)
    dtypes = ["f32", "int8"]
    if args.int8 and not args.f32:
        dtypes = ["int8"]
    elif args.f32 and not args.int8:
        dtypes = ["f32"]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    combined = {}
    for name in names:
        for dtype in dtypes:
            key = f"{name}.{dtype}"
            bundle = rep.build_workload(name, int8=dtype == "int8", device=dev)
            segments = rep.segment_report(bundle["graph"], bundle["plan"])
            arena = rep.arena_timeline(bundle["plan"])
            assert arena["peak_bytes"] == arena["arena_bytes"], (
                f"{key}: timeline peak {arena['peak_bytes']} != planner "
                f"arena {arena['arena_bytes']}")
            (outdir / f"{key}.segments.json").write_text(
                json.dumps(segments, indent=1) + "\n")
            (outdir / f"{key}.arena.json").write_text(
                json.dumps(arena, indent=1) + "\n")
            (outdir / f"{key}.arena.txt").write_text(
                rep.ascii_memory_map(bundle["plan"]) + "\n")
            summary = {
                "total_macs": segments["total_macs"],
                "n_segments": segments["n_segments"],
                "segments_by_kind": segments["segments_by_kind"],
                "arena_bytes": arena["arena_bytes"],
                "peak_bytes": arena["peak_bytes"],
                "max_frag_frac": arena["max_frag_frac"],
            }
            if args.timed:
                timing = rep.timed_segments(bundle, iters=args.iters)
                (outdir / f"{key}.timing.json").write_text(
                    json.dumps(timing, indent=1) + "\n")
                top = timing["by_time"][0]
                summary["slowest_segment"] = {
                    k: top[k] for k in
                    ("first", "last", "kind", "measured_s", "discrepancy")}
            if not args.no_trace:
                trace = serving_trace(bundle, dev)
                (outdir / f"{key}.trace.json").write_text(
                    json.dumps(trace) + "\n")
                summary["trace_events"] = len(trace["traceEvents"])
            combined[key] = summary
            print(f"{key}: {segments['n_segments']} segments, "
                  f"{segments['total_macs']} MACs, arena "
                  f"{arena['arena_bytes']} B (peak ok)")

    if "ds_cnn" in names:
        for key in combined:
            if key == "ds_cnn.int8":
                assert combined[key]["total_macs"] == DS_CNN_MACS
                assert combined[key]["arena_bytes"] == DS_CNN_INT8_ARENA_B
    (outdir / "obs_report.json").write_text(
        json.dumps(combined, indent=1, sort_keys=True) + "\n")
    print(f"wrote {outdir}/ ({len(combined)} configs)")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
