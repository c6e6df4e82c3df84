#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py [--out FILE]

Drives the port's main path — the paper's pipeline, served — and holds its
kernels against their plain PyTorch versions:

1. builds kernels K1 (``src/repro_torch/csrc/conv_pool.cu``) and K2
   (``src/repro_torch/csrc/conv_pool_q8.cu``) with ``nvcc``, in parallel;
2. holds each kernel against its plain version on the card: K1 on the
   reference's kernel test geometries plus an average-pool, a multi-tile
   (128x128) and a rectangular case, batches 1/8/16, f32 at
   rtol=atol=1e-5 and bf16 at 5e-2; K2 bit-exact on the §5 CIFAR conv1-conv3 geometries, batches
   1/4/16, max and average pools; plus one call of each through strided
   arena views, as the executors make them;
3. serves 64 requests in bursts of 8 through the float LeNet-5 engine and
   the int8 §5 CIFAR engine (bucket ladder 1/2/4/8/16), with the launch
   counters set to 0 just before and read just after each; checks the
   outputs against the port's plain path on a CPU copy (f32 at 1e-5, int8
   bit-exact), that K1 launched twice per LeNet batch and K2 three times per
   CIFAR batch, and that each executor's arena is exactly the plan's
   (LeNet 8,800 B f32, CIFAR 11,264 B int8, per image); the engines' span
   tracer gives the host time of each stage of a batch (coalesce, stage,
   dispatch, device, complete);
4. times each kernel at the main path's shapes (batch 1 and 16) with CUDA
   events and the profiler, beside its plain version, a PyTorch library
   chain computing the same function, and its bound from the shapes.

Prints one JSON object per line: the phases' results, then the card's
``nvidia-smi`` name and power limit, then ``{"kernels": [...]}``, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without that last line.  It also exits non-zero, printing
nothing to stdout, when ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 on
# the CUDA cores, int8 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}

# The reference's kernel test geometries (tests/test_kernel_conv_pool.py),
# (H, W, cin, cout, k, conv_stride, padding, pool_k, pool_stride, pool).
K1_CASES = [
    (32, 32, 1, 6, 5, 1, 0, 2, 2, "max"),
    (14, 14, 6, 16, 5, 1, 0, 2, 2, "max"),
    (32, 32, 3, 32, 5, 1, 2, 2, 2, "max"),
    (16, 16, 32, 16, 5, 1, 2, 2, 2, "max"),
    (16, 16, 4, 8, 3, 1, 0, 3, 3, "max"),
    (16, 16, 4, 8, 3, 1, 0, 3, 2, "max"),
    (20, 20, 2, 4, 3, 2, 1, 2, 2, "max"),
    (16, 16, 4, 8, 3, 1, 0, 2, 2, "avg"),
    # the multi-tile image of tests/test_hotpaths.py: at batch 16 each CTA
    # takes two pooled rows
    (128, 128, 4, 8, 3, 1, 0, 2, 2, "max"),
    # the true DS-CNN stem: rectangular kernel, stride, padding and pool
    (49, 10, 1, 8, (10, 4), (2, 2), (5, 1), (5, 1), (5, 1), "avg"),
    (49, 10, 1, 8, (10, 4), (2, 2), (5, 1), (5, 1), (5, 1), "max"),
]
K1_BATCHES = (1, 8, 16)
K2_BATCHES = (1, 4, 16)
BUCKETS = (1, 2, 4, 8, 16)
N_REQUESTS, BURST = 64, 8


class Report:
    """Prints each result as one JSON line, and keeps a copy in ``--out``."""

    def __init__(self, out):
        self.out = Path(out) if out else None
        if self.out:
            self.out.parent.mkdir(parents=True, exist_ok=True)
            self.out.write_text("")

    def emit(self, obj) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        if self.out:
            with self.out.open("a") as f:
                f.write(line + "\n")


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _taps(size: int, k: int, cs: int, pad: int, p: int, pk: int, ps: int) -> int:
    """Along one axis: the (conv position, tap) pairs that the p pooled
    positions need and that fall inside the input, not on its padding."""
    used = {q * ps + i for q in range(p) for i in range(pk)}
    return sum(0 <= o * cs - pad + d < size for o in used for d in range(k))


def bound(kind: str, n, cin, h, w, cout, k, cs, pad, pk, ps):
    """(ms, "bytes" | "operations"): the least time for one call, the larger
    of each input byte read once and each output byte written once (the bias
    is 4-byte f32 or int32) over HBM bandwidth, and the conv MACs the pooled
    outputs need, padding taps excluded, over the peak rate of the type."""
    (kh, kw), (csh, csw), (ph_, pw_) = _pair(k), _pair(cs), _pair(pad)
    (pkh, pkw), (psh, psw) = _pair(pk), _pair(ps)
    oh, ow = (h + 2 * ph_ - kh) // csh + 1, (w + 2 * pw_ - kw) // csw + 1
    ph, pw = (oh - pkh) // psh + 1, (ow - pkw) // psw + 1
    elem = {"f32": 4, "int8": 1}[kind]
    nbytes = (n * cin * h * w + cout * cin * kh * kw + n * cout * ph * pw) * elem
    nbytes += cout * 4
    macs = (n * cout * cin * _taps(h, kh, csh, ph_, ph, pkh, psh)
            * _taps(w, kw, csw, pw_, pw, pkw, psw))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def event_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Wall time per call on the card's clock: CUDA events around a loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(torch, fn, iters: int = 50):
    """Device time per call, summed over every kernel ``fn`` launches, from
    the profiler; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


def build_phase(report) -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build()
    usage = {}
    for name, p in paths.items():
        log = p.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        usage[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln]
    report.emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
                 "libraries": {n: p.name for n, p in paths.items()},
                 "ptxas": usage})


def k1_checks(torch, np, report) -> None:
    from repro_torch.kernels.conv_pool import ref
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool

    worst = {"f32": 0.0, "bf16": 0.0}
    n_checks = 0
    for ci, (H, W, cin, cout, k, cs, pad, pk, ps, pool) in enumerate(K1_CASES):
        kh, kw = _pair(k)
        for n in K1_BATCHES:
            rng = np.random.default_rng(1000 * ci + n)
            x = rng.standard_normal((n, cin, H, W))
            w = rng.standard_normal((cout, cin, kh, kw)) * 0.2
            b = rng.standard_normal((cout,)) * 0.1
            for kind, dtype, tol in (("f32", torch.float32, 1e-5),
                                     ("bf16", torch.bfloat16, 5e-2)):
                xt, wt, bt = (torch.as_tensor(a, dtype=dtype, device="cuda")
                              for a in (x, w, b))
                geom = dict(conv_stride=cs, padding=pad, pool_k=pk,
                            pool_stride=ps, activation="relu", pool=pool)
                y = fused_conv_pool(xt, wt, bt, **geom)
                y_ref = ref.conv_pool_ref(xt, wt, bt, **geom)
                torch.cuda.synchronize()
                if y.dtype != dtype or y.shape != y_ref.shape:
                    raise AssertionError(f"K1 case {ci} n={n} {kind}: "
                                         f"{y.dtype}{tuple(y.shape)} vs "
                                         f"{y_ref.dtype}{tuple(y_ref.shape)}")
                yf, rf = y.float(), y_ref.float()
                if not torch.allclose(yf, rf, rtol=tol, atol=tol):
                    raise AssertionError(
                        f"K1 case {ci} {K1_CASES[ci]} n={n} {kind}: max abs err "
                        f"{float((yf - rf).abs().max())} beyond {tol}")
                worst[kind] = max(worst[kind], float((yf - rf).abs().max()))
                n_checks += 1
    report.emit({"phase": "k1_vs_plain", "checks": n_checks,
                 "max_abs_err": worst, "tolerance": {"f32": 1e-5, "bf16": 5e-2}})


def k2_checks(torch, np, report) -> None:
    from repro_torch.core.graph import cifar_testnet
    from repro_torch.core.fusion import fuse
    from repro_torch.quant.kernel_q8 import conv_pool_q8_ref, fused_conv_pool_q8

    layers = _fused_conv_layers(fuse(cifar_testnet()))
    n_checks = 0
    for li, (name, layer, (cin, H, W)) in enumerate(layers):
        conv = layer.conv
        for n in K2_BATCHES:
            for pool in ("max", "avg"):
                rng = np.random.default_rng(100 * li + n)
                x = torch.as_tensor(rng.integers(-128, 128, (n, cin, H, W)),
                                    dtype=torch.int8, device="cuda")
                w = torch.as_tensor(
                    rng.integers(-127, 128, (conv.out_channels, cin,
                                             *conv.kernel_size)),
                    dtype=torch.int8, device="cuda")
                b = torch.as_tensor(rng.integers(-4000, 4000, (conv.out_channels,)),
                                    dtype=torch.int32, device="cuda")
                geom = dict(multiplier=float(np.float32(3e-4)),
                            conv_stride=conv.stride, padding=conv.padding,
                            pool_k=layer.pool_kernel,
                            pool_stride=layer.pool_stride, activation="relu",
                            pool=pool)
                y = fused_conv_pool_q8(x, w, b, **geom)
                y_ref = conv_pool_q8_ref(x, w, b, **geom)
                torch.cuda.synchronize()
                if y.dtype != torch.int8 or not torch.equal(y, y_ref):
                    raise AssertionError(
                        f"K2 {name} n={n} {pool}: not bit-exact, "
                        f"{int((y.int() - y_ref.int()).abs().max())} max diff")
                n_checks += 1
    report.emit({"phase": "k2_vs_plain", "checks": n_checks, "bit_exact": True})


def strided_view_checks(torch, np, report) -> None:
    """One call of each kernel reading one bank of an (N, arena) tensor and
    writing the other, as the executors do."""
    from repro_torch.kernels.conv_pool import ref
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool
    from repro_torch.quant.kernel_q8 import conv_pool_q8_ref, fused_conv_pool_q8

    rng = np.random.default_rng(7)
    n, arena_elems = 5, 2200
    arena = torch.zeros((n, arena_elems), device="cuda")
    x = arena[:, 1024:1024 + 1176].view(n, 6, 14, 14)
    x.copy_(torch.as_tensor(rng.standard_normal((n, 6, 14, 14)),
                            dtype=torch.float32))
    w = torch.as_tensor(rng.standard_normal((16, 6, 5, 5)) * 0.2,
                        dtype=torch.float32, device="cuda")
    b = torch.as_tensor(rng.standard_normal(16) * 0.1, dtype=torch.float32,
                        device="cuda")
    out = arena[:, 0:400].view(n, 16, 5, 5)
    fused_conv_pool(x, w, b, out=out)
    y_ref = ref.conv_pool_ref(x.contiguous(), w, b)
    if not torch.allclose(out, y_ref, rtol=1e-5, atol=1e-5):
        raise AssertionError("K1 through arena views disagrees with plain")

    arena8 = torch.zeros((n, 11264), dtype=torch.int8, device="cuda")
    xq = arena8[:, 0:3072].view(n, 3, 32, 32)
    xq.copy_(torch.as_tensor(rng.integers(-128, 128, (n, 3, 32, 32)),
                             dtype=torch.int8))
    wq = torch.as_tensor(rng.integers(-127, 128, (32, 3, 5, 5)),
                         dtype=torch.int8, device="cuda")
    bq = torch.as_tensor(rng.integers(-4000, 4000, 32), dtype=torch.int32,
                         device="cuda")
    outq = arena8[:, 3072:3072 + 8192].view(n, 32, 16, 16)
    geom = dict(multiplier=float(np.float32(2e-3)), padding=2)
    fused_conv_pool_q8(xq, wq, bq, out=outq, **geom)
    if not torch.equal(outq, conv_pool_q8_ref(xq.contiguous(), wq, bq, **geom)):
        raise AssertionError("K2 through arena views disagrees with plain")
    torch.cuda.synchronize()
    report.emit({"phase": "arena_views", "ok": True})


def _fused_conv_layers(fused_graph):
    """(name, FusedConvPool layer, input (C, H, W)) along a fused graph."""
    out = []
    shapes = fused_graph.shapes()
    for i, layer in enumerate(fused_graph.layers):
        if layer.kind == "FusedConvPool":
            out.append((layer.name, layer, tuple(shapes[i - 1])))
    return out


def engine_phase(torch, np, report):
    """Serve 64 requests through each engine; returns per-network results."""
    from repro_torch.core import fusion, nn, pingpong, planner, quantize
    from repro_torch.core.graph import cifar_testnet, lenet5
    from repro_torch.kernels.conv_pool.kernel import K1_LAUNCHES
    from repro_torch.quant import exec as qexec
    from repro_torch.quant.kernel_q8 import K2_LAUNCHES
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.cnn_engine import CNNEngine, CoalescePolicy

    policy = CoalescePolicy(max_batch=BUCKETS[-1], max_wait_s=0.002)
    arrivals = [(i // BURST) * 0.002 for i in range(N_REQUESTS)]
    rng = np.random.default_rng(0)
    results = {}

    def serve(engine, images):
        with engine:
            K1_LAUNCHES.reset()
            K2_LAUNCHES.reset()
            reqs, run = engine.serve(images, arrivals)
            counts = (K1_LAUNCHES.count, K2_LAUNCHES.count,
                      dict(K1_LAUNCHES.by_key), dict(K2_LAUNCHES.by_key))
        return np.stack([r.y for r in reqs]), run, counts

    def span_ms(tracer):
        """Host time of each engine span, batch by batch: {name: [ms, ...]}."""
        out = {}
        for _, dur_us, ev in tracer.spans():
            out.setdefault(ev["name"], []).append(dur_us / 1e3)
        return out

    def check_arena(engine, plan, name, want_bytes):
        for b in BUCKETS:
            a = engine.executor.arenas[b]
            if tuple(a.shape) != (b, plan.arena_elems):
                raise AssertionError(f"{name}: bucket {b} arena {tuple(a.shape)} "
                                     f"!= ({b}, {plan.arena_elems})")
            if plan.arena_elems * a.element_size() != want_bytes:
                raise AssertionError(f"{name}: arena {plan.arena_elems} x "
                                     f"{a.element_size()} B != {want_bytes} B")

    # -- LeNet-5, f32 (paper §3) ---------------------------------------------
    g = lenet5()
    fused = fusion.fuse(g)
    params = fusion.rename_params(
        fused, nn.init_params(g, torch.Generator().manual_seed(0), device="cuda"))
    plan = planner.plan_pingpong(g)
    engine = CNNEngine.from_graph(fused, plan, params, device="cuda",
                                  buckets=BUCKETS, policy=policy, tracer=Tracer())
    images = rng.standard_normal((N_REQUESTS, 1, 32, 32)).astype(np.float32)
    y, run, (k1, k2, k1_keys, _) = serve(engine, images)
    params_cpu = {k: {kk: v.cpu() for kk, v in p.items()} for k, p in params.items()}
    y_plain = pingpong.make_scan_executor(fused, plan)(
        params_cpu, torch.from_numpy(images)).numpy()
    if y.shape != (N_REQUESTS, 10) or not np.isfinite(y).all():
        raise AssertionError(f"LeNet engine output {y.shape} not finite")
    if not np.allclose(y, y_plain, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"LeNet engine vs plain CPU path: max abs err "
                             f"{float(np.abs(y - y_plain).max())}")
    if k1 != 2 * run.batches or k2 != 0:
        raise AssertionError(f"LeNet: K1 launched {k1} times, K2 {k2}, for "
                             f"{run.batches} batches (want 2 per batch, 0)")
    check_arena(engine, plan, "LeNet-5", 8800)
    results["lenet5_f32"] = {"run": run, "k1": k1, "keys": k1_keys, "fused": fused}
    report.emit({"phase": "engine", "net": "lenet5_f32", "requests": N_REQUESTS,
                 "max_abs_err_vs_cpu_plain": float(np.abs(y - y_plain).max()),
                 "k1_launches": k1, "k2_launches": k2,
                 "arena_bytes_per_image": plan.arena_elems * 4,
                 **run.summary(), "bucket_hist": run.bucket_hist,
                 "spans_ms": span_ms(engine.tracer)})

    # -- §5 CIFAR test net, int8 ---------------------------------------------
    c = cifar_testnet()
    cfused = fusion.fuse(c)
    cparams = fusion.rename_params(
        cfused, nn.init_params(c, torch.Generator().manual_seed(1), device="cpu"))
    calib = torch.from_numpy(rng.standard_normal((8, 3, 32, 32)).astype(np.float32))
    qm = quantize.quantize(cfused, cparams, calib)
    plan_q = planner.plan_pingpong(c, io_dtype_bytes=1)
    engine = CNNEngine.from_quantized(qm, plan_q, device="cuda",
                                      buckets=BUCKETS, policy=policy,
                                      tracer=Tracer())
    xs = torch.from_numpy(rng.standard_normal((N_REQUESTS, 3, 32, 32)).astype(np.float32))
    xq = quantize.quantize_input(qm, xs).numpy()
    yq, run, (k1, k2, _, k2_keys) = serve(engine, xq)
    y_sim = quantize.simulate_int8_forward(qm, torch.from_numpy(xq)).numpy()
    y_exec, _ = qexec.run_batch_int8_with_arena(qm, plan_q, torch.from_numpy(xq))
    if yq.dtype != np.int8 or yq.shape != (N_REQUESTS, 10):
        raise AssertionError(f"CIFAR engine output {yq.dtype}{yq.shape}")
    if not (np.array_equal(yq, y_sim) and np.array_equal(yq, y_exec.numpy())):
        raise AssertionError("CIFAR int8 engine is not bit-exact vs the CPU "
                             "simulator and executor")
    if k2 != 3 * run.batches or k1 != 0:
        raise AssertionError(f"CIFAR: K2 launched {k2} times, K1 {k1}, for "
                             f"{run.batches} batches (want 3 per batch, 0)")
    check_arena(engine, plan_q, "CIFAR int8", 11264)
    results["cifar_int8"] = {"run": run, "k2": k2, "keys": k2_keys, "fused": cfused}
    report.emit({"phase": "engine", "net": "cifar_int8", "requests": N_REQUESTS,
                 "bit_exact_vs_cpu_simulator": True,
                 "k1_launches": k1, "k2_launches": k2,
                 "arena_bytes_per_image": plan_q.arena_elems,
                 **run.summary(), "bucket_hist": run.bucket_hist,
                 "spans_ms": span_ms(engine.tracer)})
    return results


def timing_phase(torch, np, report, engines):
    """Time each kernel at the main path's shapes; returns kernel entries."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv_pool import ref
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool
    from repro_torch.quant.kernel_q8 import conv_pool_q8_ref, fused_conv_pool_q8

    specs = [
        ("K1", "conv_pool_f32", "f32", "lenet5_f32", "k1",
         "src/repro_torch/csrc/conv_pool.cu",
         "src/repro/kernels/conv_pool/kernel.py:89"),
        ("K2", "conv_pool_q8", "int8", "cifar_int8", "k2",
         "src/repro_torch/csrc/conv_pool_q8.cu",
         "src/repro/quant/kernel_q8.py:46"),
    ]
    entries = []
    rng = np.random.default_rng(3)
    for kname, fn_name, kind, net, _count, source, replaces in specs:
        keys = engines[net]["keys"]
        for name, layer, (cin, H, W) in _fused_conv_layers(engines[net]["fused"]):
            conv = layer.conv
            geom = dict(conv_stride=conv.stride, padding=conv.padding,
                        pool_k=layer.pool_kernel, pool_stride=layer.pool_stride,
                        activation=layer.activation, pool=layer.pool)
            launches = sum(
                v for key, v in keys.items()
                if key[0] == fn_name and key[2:] == (
                    cin, H, W, conv.out_channels, *conv.kernel_size,
                    *conv.stride, *conv.padding, *layer.pool_kernel,
                    *layer.pool_stride, layer.pool))
            for n in (1, BUCKETS[-1]):
                shape_w = (conv.out_channels, cin, *conv.kernel_size)
                if kind == "f32":
                    x = torch.as_tensor(rng.standard_normal((n, cin, H, W)),
                                        dtype=torch.float32, device="cuda")
                    w = torch.as_tensor(rng.standard_normal(shape_w) * 0.1,
                                        dtype=torch.float32, device="cuda")
                    b = torch.as_tensor(rng.standard_normal(conv.out_channels) * 0.1,
                                        dtype=torch.float32, device="cuda")
                    kern = lambda: fused_conv_pool(x, w, b, **geom)
                    plain = lambda: ref.conv_pool_ref(x, w, b, **geom)
                    pool_fn = F.max_pool2d if layer.pool == "max" else F.avg_pool2d

                    def library():
                        y = F.relu(F.conv2d(x, w, b, stride=conv.stride,
                                            padding=conv.padding))
                        return pool_fn(y, layer.pool_kernel, layer.pool_stride)

                    lib_note = "F.conv2d -> F.relu -> pool, f32, TF32 off"
                else:
                    x = torch.as_tensor(rng.integers(-128, 128, (n, cin, H, W)),
                                        dtype=torch.int8, device="cuda")
                    w = torch.as_tensor(rng.integers(-127, 128, shape_w),
                                        dtype=torch.int8, device="cuda")
                    b = torch.as_tensor(rng.integers(-4000, 4000, conv.out_channels),
                                        dtype=torch.int32, device="cuda")
                    m = float(np.float32(3e-4))
                    kern = lambda: fused_conv_pool_q8(x, w, b, multiplier=m, **geom)
                    plain = lambda: conv_pool_q8_ref(x, w, b, multiplier=m, **geom)
                    xd, wd, bd = x.double(), w.double(), b.double()

                    def library():
                        y = F.relu(F.conv2d(xd, wd, bd, stride=conv.stride,
                                            padding=conv.padding))
                        return F.max_pool2d(y, layer.pool_kernel, layer.pool_stride)

                    lib_note = ("float64 F.conv2d -> F.relu -> F.max_pool2d: a "
                                "reference of another type, not int8")
                y_k, y_p = kern(), plain()
                torch.cuda.synchronize()
                err = float((y_k.double() - y_p.double()).abs().max())
                t = {
                    "ms": event_ms(torch, kern), "plain_ms": event_ms(torch, plain),
                    "library_ms": event_ms(torch, library),
                    "device_ms": device_ms(torch, kern),
                    "plain_device_ms": device_ms(torch, plain),
                    "library_device_ms": device_ms(torch, library),
                }
                bms, bby = bound(kind, n, cin, H, W, conv.out_channels,
                                 conv.kernel_size, conv.stride, conv.padding,
                                 layer.pool_kernel, layer.pool_stride)
                rec = {"phase": "timing", "kernel": kname, "layer": f"{net}/{name}",
                       "batch": n, "max_abs_err": err, "bound_ms": bms, "bound_by": bby,
                       "library": lib_note, **t}
                report.emit(rec)
                if n == BUCKETS[-1]:
                    entries.append({
                        "name": f"{kname} {fn_name} [{net}/{name}, N={n}]",
                        "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches, "max_abs_err": err,
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": bms, "bound_by": bby,
                        "library_ms": t["library_ms"] if kind == "f32" else None,
                        "device_ms": t["device_ms"],
                    })
    return entries


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every JSON line to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 - fails here outside a checkout

    # f32 is compared at 1e-5: no TF32 anywhere.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = Report(args.out)
    t0 = time.perf_counter()
    report.emit({"phase": "start", "torch": torch.__version__,
                 "cuda": torch.version.cuda, "python": sys.version.split()[0],
                 "device": torch.cuda.get_device_name(0)})
    build_phase(report)
    k1_checks(torch, np, report)
    k2_checks(torch, np, report)
    strided_view_checks(torch, np, report)
    engines = engine_phase(torch, np, report)
    entries = timing_phase(torch, np, report, engines)
    for net in engines:
        run = engines[net]["run"]
        report.emit({"phase": "serving", "net": net, "qps": run.qps,
                     "p50_ms": run.latency_ms(50), "p99_ms": run.latency_ms(99),
                     "batches": run.batches})
    card = card_line()
    report.emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3),
                 "card": card})
    print(card, flush=True)
    report.emit({"kernels": entries})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
