"""The paper's tool on the port, end to end: train → quantize → plan → emit C → verify.

Trains LeNet-5 on the synthetic MNIST-like set (paper protocol: Adam 2e-3,
cross-entropy), fuses + plans memory, generates the C inference engine
(weights in .text, ping-pong arena in .bss), compiles it with gcc, and holds
the C engine to the port's arena executor (kernel K1 on the card); then
repeats the paper's §5 int8 comparison: quantize, run the int8 arena
executor (K2 on the card, bit-exact vs the eager simulator) and print the
float-vs-int8 activation-RAM table.

    python examples/torch_deploy_microcontroller.py [--steps N] [--device cuda|cpu]
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

from repro_torch.core import export_c, fusion, nn, pingpong, planner, quantize
from repro_torch.core.graph import lenet5
from repro_torch.data.mnist_synth import make_dataset
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.quant import exec as qexec
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, unflatten_like

# The C engine against the card's K1 executor: chip_smoke.py's LENET_C_TOL
# (gcc's float order against K1's; the reference holds C to its CPU forward
# pass at 1e-5 / 1e-6).
LENET_C_TOL = (1e-4, 1e-5)


def train_lenet(steps: int, device, params=None, batch: int = 32):
    """LeNet-5 trained ``steps`` AdamW steps on ``device`` (plain autograd
    through ``nn.forward``); ``params`` (LeNet-5's layer names, tensors on
    any device) replace the seeded init.  Returns (graph, params)."""
    g = lenet5()
    if params is None:
        params = nn.init_params(g, torch.Generator().manual_seed(0), device=device)
    params = {k: {kk: v.to(device) for kk, v in p.items()} for k, p in params.items()}
    imgs, labels = make_dataset(4096, seed=0)
    test_x, test_y = make_dataset(512, seed=99)
    imgs, labels = torch.as_tensor(imgs, device=device), torch.as_tensor(labels, device=device)

    acfg = opt.AdamWConfig(lr_peak=2e-3, warmup_steps=20, total_steps=steps,
                           weight_decay=0.0)  # paper: Adam, lr 2e-3
    state = opt.init_state(params)
    rng = np.random.default_rng(0)
    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, len(imgs), batch), device=device)
        flat = [p.requires_grad_(True) for p in leaves(params)]
        logits = nn.forward(g, params, imgs[idx])
        y = labels[idx].long()
        loss = (torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]).mean()
        grads = unflatten_like(params, torch.autograd.grad(loss, flat))
        params, state, _ = opt.apply_adamw(acfg, params, grads, state)
        params = {k: {kk: v.detach() for kk, v in p.items()} for k, p in params.items()}
        if (i + 1) % 50 == 0:
            print(f"  step {i+1}: loss {float(loss.detach()):.4f}")

    with torch.no_grad():
        logits = nn.forward(g, params, torch.as_tensor(test_x, device=device))
    acc = float((logits.argmax(-1).cpu().numpy() == test_y).mean())
    print(f"  test accuracy (synthetic digits): {acc:.4f} (paper, real MNIST: 0.9844)")
    return g, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    print("== train (paper §3 protocol) ==")
    g, params = train_lenet(args.steps, dev)

    fused = fusion.fuse(g)
    fp = fusion.rename_params(fused, params)
    plan = planner.plan_pingpong(g)
    planner.verify_plan(plan)

    print("\n== emit + compile the C engine (paper §4) ==")
    src = export_c.generate_c(fused, plan, fp, with_main=True)
    imgs, labels = make_dataset(8, seed=7)
    y_dev, _ = pingpong.run_batch_with_arena(fused, plan, fp, torch.as_tensor(imgs, device=dev))
    y_dev = y_dev.cpu().numpy()
    rtol, atol = LENET_C_TOL
    with tempfile.TemporaryDirectory() as td:
        cpath = Path(td) / "only_network.c"
        bpath = Path(td) / "only_network"
        opath = Path(td) / "only_network.o"
        cpath.write_text(src)
        subprocess.run(["gcc", "-O2", "-std=c99", str(cpath), "-o", str(bpath), "-lm"],
                       check=True)
        subprocess.run(["gcc", "-Os", "-c", str(cpath), "-o", str(opath)], check=True)
        size_out = subprocess.run(["size", str(opath)], capture_output=True,
                                  text=True, check=True).stdout
        print("  " + size_out.splitlines()[0])
        print("  " + size_out.splitlines()[1])
        agree = 0
        for i in range(len(imgs)):
            x = np.asarray(imgs[i], np.float32)
            out = subprocess.run([str(bpath)], input=x.tobytes(),
                                 capture_output=True, check=True).stdout
            y_c = np.frombuffer(out, np.float32)
            assert np.allclose(y_c, y_dev[i], rtol=rtol, atol=atol)
            agree += int(np.argmax(y_c) == labels[i])
        print(f"  C engine matches the {dev.type} arena executor on {len(imgs)}/{len(imgs)} "
              f"inputs; {agree}/{len(imgs)} correct labels")

    print("\n== int8 path (paper §5 accounting) ==")
    calib = torch.as_tensor(make_dataset(32, seed=3)[0], device=dev)
    qm = quantize.quantize(fused, fp, calib)
    print(f"  int8 weight bytes: {qm.weight_bytes()} "
          f"(fp32: {g.param_bytes(4)})")
    xs = torch.as_tensor(imgs, device=dev)
    x_q = quantize.quantize_input(qm, xs[0])
    y_q = quantize.simulate_int8_forward(qm, x_q)
    print(f"  int8 argmax: {int(torch.argmax(y_q))} vs float: "
          f"{int(torch.argmax(nn.forward(fused, fp, xs[0])))}")

    print("\n== int8 arena runtime (q8 arena executor) ==")
    plan_q8 = planner.plan_pingpong(g, io_dtype_bytes=1)
    planner.verify_plan(plan_q8)
    y_fast, stats = qexec.run_int8_with_arena_scan(qm, plan_q8, x_q)
    assert torch.equal(y_fast, y_q), \
        "int8 arena executor diverged from the eager simulator"
    print(f"  scan executor bit-exact vs simulator "
          f"({stats['segments']} segments, arena {stats['arena_bytes']} B)")
    xs_q = quantize.quantize_input(qm, xs)
    ys, bstats = qexec.run_batch_int8_with_arena(qm, plan_q8, xs_q)
    ys = ys.cpu().numpy()
    agree_q = sum(int(np.argmax(ys[i]) == labels[i]) for i in range(len(imgs)))
    print(f"  batch {bstats['batch']}: {agree_q}/{len(imgs)} correct labels")

    print("\n  activation RAM, float vs int8 (bytes):")
    print("  plan           float32      int8    ratio")
    for fn_name, fn in (("pingpong", planner.plan_pingpong),
                        ("optimal-arena", planner.plan_optimal_arena),
                        ("fused", planner.plan_fused)):
        pf = fn(g, io_dtype_bytes=4)
        pq = fn(g, io_dtype_bytes=1)
        print(f"  {fn_name:<13} {pf.activation_bytes():>8} {pq.activation_bytes():>9} "
              f"   {pf.activation_bytes() / pq.activation_bytes():>4.1f}x")
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
