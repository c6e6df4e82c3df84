"""End-to-end LM serving on the port.

Builds a small llama-family model, runs the batched serving engine on a
stream of variable-length requests (continuous batching over KV lanes; each
prefill runs kernel K5 once an attention layer on the card), and prints
throughput + the planner's static arena accounting.

    python examples/torch_serve_llm.py [--requests N] [--lanes K] [--device cuda|cpu]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine, Request
from repro_torch.tree import leaves


def small_lm() -> ModelConfig:
    return ModelConfig(
        name="serve-demo-50m",
        family="dense",
        num_layers=4,
        d_model=256,
        num_heads=8,
        num_kv_heads=4,
        head_dim=32,
        d_ff=1024,
        vocab_size=8192,
        block_pattern=("attn",),
        mlp_act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = small_lm()
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params)")

    rng = np.random.default_rng(0)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, 48)).astype(np.int32),
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]

    eng = Engine(model, params, lanes=args.lanes, max_seq=args.max_seq, device=dev)
    plan = eng.plan_report()
    print(f"planned KV/state arena: {plan['kv_state_bytes']/1e6:.2f} MB; "
          f"ping-pong activations: {plan['pingpong_activation_bytes']} B")

    stats = eng.run(reqs)
    done = sum(r.done for r in reqs)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {done}/{len(reqs)} requests | prefills={stats.prefills} "
          f"decode_steps={stats.decode_steps} tokens={stats.tokens_out} "
          f"({stats.tokens_per_s:.1f} tok/s on {where})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt_len={len(r.prompt)} -> {len(r.out_tokens)} tokens")
    assert done == len(reqs)
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
