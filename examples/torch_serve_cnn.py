"""Continuous-batching CNN serving demo on the port.

Stands up :class:`repro_torch.serve.cnn_engine.CNNEngine` over the arena
executors — bucket ladder, ping-pong staging banks, async
dispatch/complete pipeline — and drives it with two traffic shapes:

* burst arrivals in groups of 8 (the throughput case: the coalescer fills
  batch-8 buckets, sustained QPS vs the no-batching baseline),
* Poisson open-loop arrivals (the latency case: p50/p95/p99 under load),

for float LeNet-5 (kernel K1 on the card) and the int8 DS-CNN
keyword-spotting net (K4 and K2; requests arrive already q7-encoded — int8
wire format, int8 arena banks).  Finishes with the cold-start comparison:
first-request latency of an engine that prepares its bucket inline (its
first executor run and arena allocation) vs the pre-warmed ladder.

    python examples/torch_serve_cnn.py [--requests N] [--device cuda|cpu]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import fusion, nn, planner, quantize, schedule
from repro_torch.core.graph import ds_cnn, lenet5
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy


def build_lenet_engine(device, params=None, **kw):
    """LeNet-5's float engine; ``params`` (the unfused graph's names) replace
    the seeded init."""
    g = lenet5()
    fused = fusion.fuse(g)
    if params is None:
        params = nn.init_params(g, torch.Generator().manual_seed(0), device=device)
    params = fusion.rename_params(fused, params)
    return CNNEngine.from_graph(fused, planner.plan_pingpong(g), params,
                                device=device, **kw)


def build_dscnn_int8_engine(rng, device, **kw):
    """DS-CNN's int8 engine, calibrated on 16 draws of ``rng``; returns
    (engine, quantized model)."""
    g = ds_cnn()
    fused = fusion.fuse_dag(g)
    params = fusion.rename_params(
        fused, nn.init_params(g, torch.Generator().manual_seed(6), device=device))
    calib = torch.as_tensor(rng.standard_normal((16, 1, 49, 10)), dtype=torch.float32,
                            device=device)
    qm = quantize.quantize_dag(fused, params, calib)
    plan_q = schedule.plan_dag(g, io_dtype_bytes=1)
    return CNNEngine.from_quantized(qm, plan_q, device=device, **kw), qm


def drive(engine, name, images, rng):
    print(f"\n== {name} ==")
    print(f"  ladder {engine._cache.buckets}, pre-warm "
          f"{engine.stats.prewarm_s * 1e3:.0f} ms "
          f"({engine._cache.misses} executors)")
    with engine:
        engine.serve(images[:8])  # settle threads + dispatch path
        # burst-8 arrivals: the throughput shape
        arrivals = [(i // 8) * 0.001 for i in range(len(images))]
        _, burst = engine.serve(images, arrivals)
        print(f"  burst-8 : {burst.qps:7.0f} qps  avg batch "
              f"{burst.avg_batch:.1f}  padding {burst.padding_frac:.0%}")
        # Poisson open-loop at ~60% of that capacity: the latency shape
        lam = max(burst.qps * 0.6, 1.0)
        gaps = rng.exponential(1.0 / lam, len(images))
        _, pois = engine.serve(images, np.cumsum(gaps) - gaps[0])
        print(f"  poisson : {pois.qps:7.0f} qps  p50 {pois.latency_ms(50):6.2f} ms"
              f"  p95 {pois.latency_ms(95):6.2f} ms  p99 {pois.latency_ms(99):6.2f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    rng = np.random.default_rng(0)
    policy = CoalescePolicy(max_batch=8, max_wait_s=0.002)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name}  policy: max_batch="
          f"{policy.max_batch}, max_wait={policy.max_wait_s * 1e3:.0f} ms")

    eng = build_lenet_engine(dev, buckets=(1, 2, 4, 8), policy=policy)
    imgs = rng.standard_normal((args.requests, 1, 32, 32)).astype(np.float32)
    drive(eng, "LeNet-5 float32", imgs, rng)

    engq, qm = build_dscnn_int8_engine(rng, dev, buckets=(1, 2, 4, 8), policy=policy)
    xs = rng.standard_normal((args.requests, 1, 49, 10)).astype(np.float32)
    xq = quantize.quantize_input(qm, torch.from_numpy(xs)).numpy()
    drive(engq, "DS-CNN int8 (q7 wire format)", xq, rng)

    # cold start vs the prepared ladder: what pre-warm buys the first request
    print("\n== first-request latency: cold vs pre-warmed (LeNet) ==")
    cold = build_lenet_engine(dev, buckets=(1,), policy=CoalescePolicy(max_batch=1),
                              prewarm=False)
    with cold:
        r = cold.submit(imgs[0])
        r.result(timeout=120.0)
        print(f"  cold (bucket prepared inline): {r.latency_s * 1e3:8.1f} ms")
    warm = build_lenet_engine(dev, buckets=(1,), policy=CoalescePolicy(max_batch=1))
    with warm:
        warm.serve(imgs[:2])
        r = warm.submit(imgs[0])
        r.result(timeout=120.0)
        print(f"  pre-warmed ladder            : {r.latency_s * 1e3:8.1f} ms "
              f"({r.latency_s and warm.stats.prewarm_s / r.latency_s:.0f}x "
              f"paid once at deploy)")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
