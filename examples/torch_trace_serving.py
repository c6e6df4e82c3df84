"""End-to-end serving-trace export demo on the port.

Stands up the continuous-batching CNN engine (kernel K1 on the card) with an
*enabled* :class:`repro_torch.obs.trace.Tracer`, drives one burst of
traffic, and writes a Chrome trace-event JSON you can open directly in
Perfetto:

  1. ``python examples/torch_trace_serving.py --out build/trace``
  2. open https://ui.perfetto.dev and drag ``serving_trace.json`` in
     (or chrome://tracing on older Chrome).

What to look at in the UI (DESIGN.md §11):

* the ``cnn-engine-dispatch`` track: ``coalesce → stage → dispatch`` spans
  per batch — the host side of the pipeline;
* the ``cnn-engine-complete`` track: ``device`` (waiting on the batch's CUDA
  event) and ``complete`` (output scatter) spans — watch ``stage`` of batch
  *k+1* sit on top of ``device`` of batch *k*: that overlap *is* the
  double-buffered pipeline;
* the async ``request`` track: one span per request id from submit to
  completion, with batch id / bucket / lane stamped in the end-event args;
* the ``queue_depth`` / ``batch_occupancy`` counter tracks.

Also dumps the engine's metrics registry (cache hits/lowerings, batch
occupancy, latency histogram) as ``serving_metrics.json``.

    python examples/torch_trace_serving.py [--requests N] [--out DIR] [--device cuda|cpu]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import fusion, nn, schedule
from repro_torch.core.graph import DAGGraph, lenet5
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.obs.trace import Tracer, validate_chrome_trace
from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--out", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    g = DAGGraph.from_sequential(lenet5())
    fused = fusion.fuse_dag(g)
    plan = schedule.plan_dag(g)
    params = fusion.rename_params(
        fused, nn.init_params(g, torch.Generator().manual_seed(0), device=dev))

    tracer = Tracer(process_name="lenet.f32 serving")
    engine = CNNEngine.from_graph(
        fused, plan, params, device=dev,
        buckets=(1, 4, 8), policy=CoalescePolicy(max_batch=8, max_wait_s=0.002),
        tracer=tracer,
    )

    rng = np.random.default_rng(0)
    images = rng.standard_normal((args.requests, 1, 32, 32)).astype(np.float32)
    arrivals = [(i // 8) * 0.001 for i in range(args.requests)]  # burst-8
    with engine:
        reqs, run = engine.serve(images, arrivals)

    trace = tracer.export()
    validate_chrome_trace(trace)  # schema-checked before anyone loads it
    out = Path(args.out)
    trace_path = tracer.dump(out / "serving_trace.json")
    metrics_path = engine.metrics.dump(out / "serving_metrics.json")

    devices = tracer.spans("device")
    stages = tracer.spans("stage")
    overlaps = sum(
        1 for (t0, d0, _) in devices for (t1, d1, _) in stages
        if t1 < t0 + d0 and t0 < t1 + d1
    )
    print(f"served {run.requests} requests in {run.batches} batches "
          f"({run.qps:.0f} qps, p99 {run.latency_ms(99):.2f} ms)")
    print(f"trace: {trace_path} ({len(trace['traceEvents'])} events, "
          f"{len(devices)} device spans, {overlaps} stage/device overlaps)")
    print(f"metrics: {metrics_path}")
    print("open https://ui.perfetto.dev and drag the trace file in")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
