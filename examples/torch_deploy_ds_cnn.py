"""Deploy DS-CNN (keyword spotting) to a microcontroller target, on the port.

The CMSIS-NN flagship workload through the port's whole deployment stack:
build the depthwise-separable KWS net (`repro_torch.core.graph.ds_cnn`), plan
its arena four ways (naive / ping-pong / operator-reordered / CMSIS-NN
baseline), quantize to int8 with per-channel depthwise requantization, run
the int8 DAG arena executor (kernel K4 on the card, bit-exact vs the eager
simulator) and the float one (K3), emit the float and int8 C engines,
compile them with gcc and hold both to the card's executors.

    python examples/torch_deploy_ds_cnn.py [--device cuda|cpu]
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import export_c, fusion, nn, pingpong, planner, quantize, schedule
from repro_torch.core.graph import ds_cnn
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.quant import exec as qexec

# The float executor (K3 on the card) against the plain forward_dag: the DAG
# nets' f32 gate on the card, rtol = atol (chip_smoke.py's DAG_F32_TOL).  The
# C engine against the card's executor: the reference's C tolerance.
DAG_F32_TOL = 1e-4
C_TOL = (1e-4, 1e-5)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    g = ds_cnn()
    print("== DS-CNN (Zhang et al. 2017, square-kernel form) ==")
    print(f"  layers: {len(g.nodes)}  params: {g.param_count()} "
          f"({g.param_count() / 1e3:.1f}k, int8 flash ~{g.weight_count()} B "
          f"+ biases)")

    print("\n== arena plans (int8 bytes) ==")
    rows = [
        ("naive", planner.plan_naive(g.to_sequential(), io_dtype_bytes=1)),
        ("ping-pong", planner.plan_pingpong(g, io_dtype_bytes=1)),
        ("reordered", schedule.plan_dag(g, io_dtype_bytes=1)),
        ("CMSIS-NN baseline", planner.plan_cmsis_baseline(g)),
    ]
    for name, p in rows:
        print(f"  {name:<18} {p.activation_bytes():>7} B")
    reordered = dict(rows)["reordered"]
    cmsis = dict(rows)["CMSIS-NN baseline"]
    assert reordered.activation_bytes() < cmsis.activation_bytes()
    print(f"  -> reordered beats CMSIS by "
          f"{cmsis.activation_bytes() - reordered.activation_bytes()} B "
          f"({cmsis.activation_bytes() / reordered.activation_bytes():.2f}x)")

    fused = fusion.fuse_dag(g)
    params = fusion.rename_params(
        fused, nn.init_params(g, torch.Generator().manual_seed(0), device=dev))
    plan = schedule.plan_dag(g)
    planner.verify_plan(plan)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((1, 49, 10)),
                        dtype=torch.float32, device=dev)

    print("\n== int8 quantization (per-channel depthwise requant) ==")
    calib = torch.as_tensor(np.random.default_rng(2).standard_normal((32, 1, 49, 10)),
                            dtype=torch.float32, device=dev)
    qm = quantize.quantize_dag(fused, params, calib)
    dw = qm.layers["dw1"]
    ms = np.asarray(dw.multiplier)
    print(f"  dw1 multipliers: {ms.shape} per-channel, "
          f"range [{ms.min():.2e}, {ms.max():.2e}]")
    plan_q = schedule.plan_dag(g, io_dtype_bytes=1)
    x_q = quantize.quantize_input(qm, x)
    y_sim = quantize.simulate_int8_dag_forward(qm, x_q)
    y_fast, stats = qexec.run_int8_dag_with_arena_scan(qm, plan_q, x_q)
    assert torch.equal(y_fast, y_sim), \
        "int8 DAG arena executor diverged from the eager simulator"
    print(f"  int8 arena executor bit-exact vs simulator "
          f"({stats['segments']} segments, arena {stats['arena_bytes']} B)")

    print("\n== float DAG arena executor ==")
    y_ref = nn.forward_dag(fused, params, x)
    y_dev, fstats = pingpong.run_dag_with_arena_scan(fused, plan, params, x)
    assert torch.allclose(y_dev, y_ref, rtol=DAG_F32_TOL, atol=DAG_F32_TOL)
    print(f"  matches forward_dag ({fstats['segments']} segments, "
          f"arena {plan.arena_bytes} B)")

    print("\n== emit + gcc-verify the C engines ==")
    with tempfile.TemporaryDirectory() as td:

        def build_and_run(src, tag, x_bytes, dtype):
            c, b = Path(td) / f"{tag}.c", Path(td) / tag
            c.write_text(src)
            subprocess.run(["gcc", "-O2", "-std=c99", str(c), "-o", str(b),
                            "-lm"], check=True)
            out = subprocess.run([str(b)], input=x_bytes, capture_output=True,
                                 check=True).stdout
            return np.frombuffer(out, dtype)

        src = export_c.generate_c_dag(fused, plan, params, with_main=True)
        y_c = build_and_run(src, "ds_cnn_f32",
                            x.cpu().numpy().astype(np.float32).tobytes(), np.float32)
        assert np.allclose(y_c, y_dev.cpu().numpy().reshape(-1), rtol=C_TOL[0],
                           atol=C_TOL[1])
        print(f"  ds_cnn_f32: C matches the {dev.type} executor "
              f"(argmax {int(np.argmax(y_c))})")

        src = export_c.generate_c_int8_dag(qm, plan_q, with_main=True)
        y_c8 = build_and_run(src, "ds_cnn_q8", x_q.cpu().numpy().tobytes(), np.int8)
        assert np.array_equal(y_c8, y_sim.cpu().numpy().reshape(-1))
        print(f"  ds_cnn_q8:  C bit-exact vs int8 simulator "
              f"(argmax {int(np.argmax(y_c8))})")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
