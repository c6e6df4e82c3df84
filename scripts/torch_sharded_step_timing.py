"""Times the port's sharded train step on a ("data", "model") = (2, 2) mesh,
and the share of it that accumulates the gradients and updates the moments.

Two cells of ``chip_smoke.py``'s ``sharded_train`` phase, at their shapes:
Llama-3.2-1B at full width and depth, B 8 x S 512 (the batch split over
the data rows), and Seamless-M4T-large-v2's 2 + 2 layers at full width,
1 x 1,024 frames + 1 x 512 tokens (batch 1: the sequence and the frames
split over the data rows).  bf16 compute, f32 params from a seeded
generator, remat, the launcher's AdamW.  Per cell: one warm-up step, then
``--steps`` steps timed whole (every card synchronized before and after),
then ``--steps`` more with ``ShardedTrainStep._accumulate`` and
``_apply_adamw`` each timed alone (every card synchronized around each
call; those steps' own times are not reported); after them, the number of
param and moment blocks whose copies on two devices are not bit-equal.

    python scripts/torch_sharded_step_timing.py [--src DIR] [--tag NAME] [--steps 3]

``--src`` is the root of the checkout whose ``src/repro_torch`` is timed
(this one by default), so two commits compare on the same cards in one run:
unpack the other into a directory that ``.gitignore`` lists and run
parent, change, change, parent.  Over four cards when there are four,
else on ``cuda:0`` four times.  Prints the card's name and power limit,
then one JSON line a cell, also appended to
``chiprun_out/sharded_step_timing.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELLS = (  # (arch, seed, layers, batch, sequence, frames)
    ("llama3.2-1b", 20, None, 8, 512, None),
    ("seamless-m4t-large-v2", 25, 2, 1, 512, 1024),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import dataclasses

    import torch

    from repro_torch.configs import base as cfgbase
    from repro_torch.data import tokens as tok
    from repro_torch.ft.resilience import reshard_tree
    from repro_torch.launch import inputs as inp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import adamw_config
    from repro_torch.models.transformer import Model
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train.step import ShardedTrainStep, TrainStepConfig, jit_train_step
    from repro_torch.tree import leaves

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    cards = range(torch.cuda.device_count())

    def sync():
        for i in cards:
            torch.cuda.synchronize(i)

    spent = {"accumulate": 0.0, "apply_adamw": 0.0}

    def timing(name, fn):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            spent[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    accumulate, apply_adamw = ShardedTrainStep._accumulate, ShardedTrainStep._apply_adamw
    devices = ([torch.device("cuda", i) for i in range(4)] if len(cards) >= 4
               else [torch.device("cuda", 0)])
    mesh = make_mesh((2, 2), ("data", "model"), devices=devices)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for arch, seed, layers, B, S, T in CELLS:
        base = cfgbase.get_config(arch)
        changes = {} if layers is None else {"num_layers": layers}
        if layers is not None and base.is_encdec:
            changes["encoder_layers"] = layers
        cfg = dataclasses.replace(base, **changes)
        model = Model(cfg, xent_impl="chunked", remat=True, rwkv_chunk=64)
        params = model.init_params(torch.Generator("cuda").manual_seed(seed), device="cuda")
        policy = ShardingPolicy(mesh, cfg)
        total = 1 + 2 * args.steps
        step = jit_train_step(model, policy, inp.abstract_params(model),
                              TrainStepConfig(adamw=adamw_config(total)),
                              batch_specs=policy.batch_specs(
                                  cfgbase.ShapeConfig("train", S, B, "train")))
        params = reshard_tree(params, step.param_shardings)
        state = step.init_opt_state()
        pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                       seed=seed)
        step_ms, parts = [], []
        for s in range(total):
            batch = tok.device_batch(pipe, s, "cuda")
            if T is not None:
                gen = torch.Generator("cuda").manual_seed(1000 * seed + s)
                batch["src_embeds"] = torch.randn((B, T, cfg.d_model), generator=gen,
                                                  device="cuda")
            instrumented = s > args.steps
            if instrumented:
                spent.update(accumulate=0.0, apply_adamw=0.0)
                ShardedTrainStep._accumulate = staticmethod(timing("accumulate", accumulate))
                ShardedTrainStep._apply_adamw = timing("apply_adamw", apply_adamw)
            sync()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            sync()
            ms = 1e3 * (time.perf_counter() - t0)
            ShardedTrainStep._accumulate = staticmethod(accumulate)
            ShardedTrainStep._apply_adamw = apply_adamw
            if not torch.isfinite(metrics["loss"]).item():
                raise AssertionError(f"{arch} step {s + 1}: loss {metrics['loss']}")
            if instrumented:
                parts.append(dict(spent))
            elif s > 0:
                step_ms.append(ms)
        unequal = sum(not all(torch.equal(t.cpu(), held[0][1].cpu()) for _, t in held[1:])
                      for tree in (params, state.m, state.v) for x in leaves(tree)
                      for held in x.copies().values())
        line = {"tag": args.tag, "arch": arch, "mesh": [str(d) for d in mesh.devices.flat],
                "batch": B, "seq": S, "frames": T, "layers": cfg.num_layers,
                "step_ms": step_ms, "step_ms_min": min(step_ms),
                "accumulate_ms": [p["accumulate"] for p in parts],
                "apply_adamw_ms": [p["apply_adamw"] for p in parts],
                "blocks_with_unequal_copies": unequal}
        print(json.dumps(line), flush=True)
        with open(out_dir / "sharded_step_timing.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
        del params, state, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
