"""Quickstart on the PyTorch + CUDA port: the paper's pipeline in 60 seconds.

Builds LeNet-5, fuses conv+pool (paper §3.1), plans the ping-pong arena
(§3.2), runs inference *inside the planned arena* on a synthetic digit
(kernel K1 on the card), and prints the paper's memory table.

    python examples/torch_quickstart.py [--device cuda|cpu]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import fusion, nn, pingpong, planner
from repro_torch.core.graph import lenet5
from repro_torch.data.mnist_synth import make_dataset
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts

# K1 against the plain forward pass on the card (chip_smoke.py's k1_checks:
# f32 at rtol = atol = 1e-5; the summation order differs from cuDNN's).
K1_TOL = (1e-5, 1e-5)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    g = lenet5()
    fused = fusion.fuse(g)

    print("== paper §3 memory table ==")
    naive = planner.plan_naive(g)
    fzd = planner.plan_fused(g)
    pp = planner.plan_pingpong(g)
    print(f" params                : {g.param_bytes(4):>7} B (paper: 246824)")
    print(f" naive inter-layer     : {naive.activation_bytes(4):>7} B (paper: 36472)")
    print(f" fused in-place pool   : {fzd.activation_bytes(4):>7} B (paper: 11256, -69%)")
    print(f" ping-pong arena       : {pp.activation_bytes(4):>7} B (paper:  8800, -76%)")

    params = nn.init_params(g, torch.Generator().manual_seed(0), device=dev)
    fp = fusion.rename_params(fused, params)

    rtol, atol = K1_TOL
    imgs, labels = make_dataset(4, seed=1)
    print("\n== inference inside the planned 8800-byte arena ==")
    for i in range(4):
        x = torch.as_tensor(imgs[i], device=dev)
        y_ref = nn.forward(fused, fp, x)
        y_arena, stats = pingpong.run_with_arena(fused, pp, fp, x)
        assert torch.allclose(y_ref, y_arena, rtol=rtol, atol=atol)
        print(f" digit[{labels[i]}] -> argmax {int(torch.argmax(y_arena))} "
              f"(arena {stats['arena_elems'] * 4} B, matches functional oracle)")

    print("\n== arena executor: whole batch, one call ==")
    xs = torch.as_tensor(imgs, device=dev)
    ys, sstats = pingpong.run_batch_with_arena(fused, pp, fp, xs)
    for i in range(4):
        y_walk, _ = pingpong.run_with_arena(fused, pp, fp, xs[i])
        assert torch.allclose(y_walk, ys[i], rtol=rtol, atol=atol)
    print(f" batch {sstats['batch']} through {sstats['segments']} compiled "
          f"segments — matches the Python-loop walker per image")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
