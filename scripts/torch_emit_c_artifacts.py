"""Emit every C inference engine the port generates, and gcc-compile each.

The port's counterpart of ``scripts/emit_c_artifacts.py``: the same ten
engines from `repro_torch.core.export_c`, written under ``--out`` and each
built with gcc; a gcc failure (or gcc being absent) fails the run instead
of skipping.  Weights are drawn on ``--device`` and quantized there.

    python scripts/torch_emit_c_artifacts.py [--out OUTDIR] [--device cuda|cpu]

Engines:
  * lenet5_f32.c          — paper §3/§4 float path (fused + ping-pong plan)
  * cifar_testnet_q8.c    — paper §5 int8 path (CMSIS-NN comparison net)
  * residual_f32.c        — DAG path, reordered arena plan
  * residual_q8.c         — int8 DAG path, reordered arena plan
  * ds_cnn_f32.c          — DS-CNN (depthwise separable KWS net)
  * ds_cnn_q8.c           — int8 DS-CNN, per-channel dw requant
  * ds_cnn_kws_f32.c      — the Zhang-et-al DS-CNN: rectangular (10,4)
                            stem, fused AvgPool head
  * ds_cnn_kws_q8.c       — int8, fused-avg single requantize
  * mobilenet_v1_025_f32.c — MobileNet-V1 0.25x (stride-2 dw ladder)
  * mobilenet_v1_025_q8.c  — int8 MobileNet-V1 0.25x
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

# net -> (graph constructor name, DAG, params seed, calibration seed, input shape,
# f32 engine, int8 engine): the reference script's nets and seeds.
NETS = {
    "lenet5": ("lenet5", False, 0, None, (1, 32, 32), "lenet5_f32", None),
    "cifar_testnet": ("cifar_testnet", False, 1, 2, (3, 32, 32), None, "cifar_testnet_q8"),
    "residual": ("residual_cifar", True, 3, 4, (3, 32, 32), "residual_f32", "residual_q8"),
    "ds_cnn": ("ds_cnn", True, 5, 6, (1, 49, 10), "ds_cnn_f32", "ds_cnn_q8"),
    "ds_cnn_kws": ("ds_cnn_kws", True, 7, 8, (1, 49, 10), "ds_cnn_kws_f32", "ds_cnn_kws_q8"),
    "mobilenet_v1_025": ("mobilenet_v1", True, 9, 10, (3, 64, 64),
                         "mobilenet_v1_025_f32", "mobilenet_v1_025_q8"),
}
CALIB_BATCH = 8


def _graph(name: str):
    from repro_torch.core import graph

    return graph.mobilenet_v1(width=0.25) if name == "mobilenet_v1" else getattr(graph, name)()


def engine_sources(device, weights=None) -> dict:
    """``{file name: C source}`` for the ten engines.  ``weights`` maps a
    net of :data:`NETS` to ``(params, calibration)`` in place of the seeded
    draws (``torch.Generator().manual_seed(seed)`` for params,
    ``np.random.default_rng(seed)`` for the batch): the fused graph's params
    (tensors or numpy) and either the calibration batch (N, C, H, W) or the
    int8 model already quantized from it (a
    :class:`repro_torch.core.quantize.QuantizedModel`, such as
    `repro_torch.convert.quantized_from_numpy` rebuilds from another
    quantizer's records)."""
    from repro_torch.core import export_c, fusion, nn, planner, quantize, schedule
    from repro_torch.core.quantize import QuantizedModel

    weights = weights or {}
    out = {}
    for net, (ctor, dag, seed, calib_seed, in_shape, f32, q8) in NETS.items():
        g = _graph(ctor)
        fused = fusion.fuse_dag(g) if dag else fusion.fuse(g)
        if net in weights:
            params, calib = weights[net]
            params = {k: {kk: torch.as_tensor(np.array(v), device=device)
                          for kk, v in p.items()} for k, p in params.items()}
        else:
            params = fusion.rename_params(
                fused, nn.init_params(g, torch.Generator().manual_seed(seed), device=device))
            calib = (None if calib_seed is None else np.random.default_rng(calib_seed)
                     .standard_normal((CALIB_BATCH, *in_shape)).astype(np.float32))
        if f32:
            plan = schedule.plan_dag(g) if dag else planner.plan_pingpong(g)
            emit = export_c.generate_c_dag if dag else export_c.generate_c
            out[f"{f32}.c"] = emit(fused, plan, params, with_main=True)
        if q8:
            qm = calib
            if not isinstance(qm, QuantizedModel):
                quantizer = quantize.quantize_dag if dag else quantize.quantize
                qm = quantizer(fused, params, torch.as_tensor(np.asarray(calib, np.float32),
                                                              device=device))
            if dag:
                out[f"{q8}.c"] = export_c.generate_c_int8_dag(
                    qm, schedule.plan_dag(g, io_dtype_bytes=1), with_main=True)
            else:
                out[f"{q8}.c"] = export_c.generate_c_int8(
                    qm, planner.plan_pingpong(g, io_dtype_bytes=1), with_main=True)
    return out


def main(argv=None, weights=None) -> None:
    from repro_torch.device import resolve
    from repro_torch.kernels import launch_counts

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/c-engines")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    gcc = shutil.which("gcc")
    if gcc is None:
        raise SystemExit("gcc is required to validate the emitted engines — refusing to skip")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    paths = []
    for name, src in sorted(engine_sources(dev, weights).items()):
        paths.append(out / name)
        paths[-1].write_text(src)
    # every gcc at once, then wait for them together
    procs = {c: subprocess.Popen([gcc, "-O2", "-std=c99", str(c), "-o",
                                  str(c.with_suffix("")), "-lm"])
             for c in paths}
    for c, proc in procs.items():
        if proc.wait() != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args)
        print(f"emitted + compiled {c} ({c.stat().st_size} bytes)")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
