"""Residual DAG → reordered arena plan → C engine, on the port.

Builds the branching residual CIFAR net, compares the naive (listing-order)
schedule against the operator-reordered one, runs the float and int8 DAG
executors inside the planned arena (kernels K1 and K2 on the card's fused
conv+pool steps), then emits + gcc-compiles both C engines and holds them to
the card's outputs (bit-exact for int8).

    python examples/torch_plan_residual_dag.py [--device cuda|cpu]
"""
import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import export_c, fusion, nn, pingpong, planner, quantize, schedule
from repro_torch.core.graph import residual_cifar
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.quant import exec as qexec

# The walker (K1 on the card) against the plain forward_dag: the DAG nets'
# f32 gate on the card, rtol = atol (chip_smoke.py's DAG_F32_TOL, which
# residual_phase holds this net to).  The C engine against the card's
# walker: the reference's C tolerance for this net.
DAG_F32_TOL = 1e-4
C_TOL = (1e-4, 1e-5)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    g = residual_cifar()
    fused = fusion.fuse_dag(g)
    params = fusion.rename_params(
        fused, nn.init_params(g, torch.Generator().manual_seed(0), device=dev))

    print("== operator reordering (schedule.plan_dag) ==")
    mat = schedule.materialize_dag(fused)
    naive = schedule.naive_order(mat)
    best, peak = schedule.search_order(mat)
    plan_naive = schedule.plan_dag(g, order=naive, io_dtype_bytes=1)
    plan = schedule.plan_dag(g, io_dtype_bytes=1)
    planner.verify_plan(plan_naive)
    planner.verify_plan(plan)
    print(f"  naive order     : {' -> '.join(naive[1:6])} ...")
    print(f"  reordered       : {' -> '.join(best[1:6])} ...")
    print(f"  arena (int8)    : naive {plan_naive.arena_bytes} B, "
          f"reordered {plan.arena_bytes} B "
          f"({100 * (1 - plan.arena_bytes / plan_naive.arena_bytes):.0f}% smaller)")

    print("\n== float DAG executors ==")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 32, 32)),
                        dtype=torch.float32, device=dev)
    plan_f32 = schedule.plan_dag(g)
    y_ref = nn.forward_dag(fused, params, x)
    y_walk, stats = pingpong.run_dag_with_arena(fused, plan_f32, params, x)
    assert torch.allclose(y_ref, y_walk, rtol=DAG_F32_TOL, atol=DAG_F32_TOL)
    print(f"  walker matches forward_dag oracle (arena {stats['arena_elems']} elems)")

    print("\n== int8 DAG runtime ==")
    calib = torch.as_tensor(np.random.default_rng(2).standard_normal((16, 3, 32, 32)),
                            dtype=torch.float32, device=dev)
    qm = quantize.quantize_dag(fused, params, calib)
    x_q = quantize.quantize_input(qm, x)
    y_sim = quantize.simulate_int8_dag_forward(qm, x_q)
    y_scan, qstats = qexec.run_int8_dag_with_arena_scan(qm, plan, x_q)
    assert torch.equal(y_scan, y_sim)
    print(f"  int8 arena executor bit-exact vs simulator "
          f"(arena {qstats['arena_bytes']} B)")

    print("\n== C engines (float + int8) ==")
    if shutil.which("gcc") is None:
        print("  gcc not found — skipping the C verification")
        return
    with tempfile.TemporaryDirectory() as td:
        for tag, src, inp, ref, dt in (
            ("f32", export_c.generate_c_dag(fused, plan_f32, params, with_main=True),
             x.cpu().numpy(), y_walk.cpu().numpy(), np.float32),
            ("q8", export_c.generate_c_int8_dag(qm, plan, with_main=True),
             x_q.cpu().numpy(), y_sim.cpu().numpy(), np.int8),
        ):
            c = Path(td) / f"residual_{tag}.c"
            b = Path(td) / f"residual_{tag}"
            c.write_text(src)
            subprocess.run(["gcc", "-O2", "-std=c99", str(c), "-o", str(b), "-lm"],
                           check=True)
            out = subprocess.run([str(b)], input=inp.tobytes(),
                                 capture_output=True, check=True).stdout
            y_c = np.frombuffer(out, dt)
            if dt == np.int8:
                assert np.array_equal(y_c, ref.reshape(-1)), "int8 C diverged"
                print(f"  {tag}: bit-exact vs the {dev.type} simulator")
            else:
                assert np.allclose(y_c, ref.reshape(-1), rtol=C_TOL[0], atol=C_TOL[1])
                print(f"  {tag}: matches the {dev.type} walker (rtol {C_TOL[0]:g})")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
