"""Training on the port: LM on the synthetic token stream with checkpoint/restart.

Demonstrates the full substrate: config-driven model, AdamW, microbatching,
data pipeline, checkpoint manager, straggler detection, preemption drain.
On the card each step runs kernel K5 (attention) and K6 (the LM head fused
with the cross-entropy, ``xent_impl="seq_chunked"``).  Default model is
small; ``--dmodel/--layers`` scale it up (the ~100M configuration is
``--dmodel 768 --layers 12`` — the paper's kind is inference, so serving
(torch_serve_llm.py) is the primary end-to-end entry point and this one
defaults to a fast demonstration).

Checkpoints go to ``--ckpt-dir`` (a run there resumes from its latest
checkpoint), or to a temporary directory removed at exit.

    python examples/torch_train_llm.py [--steps N] [--ckpt-dir DIR] [--device cuda|cpu]
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokens as tok
from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, LoopState, run
from repro_torch.train.step import TrainStepConfig, make_train_step


def lm_config(d_model: int, layers: int, vocab: int) -> ModelConfig:
    return ModelConfig(
        name=f"train-demo-{d_model}x{layers}",
        family="dense",
        num_layers=layers,
        d_model=d_model,
        num_heads=max(d_model // 64, 2),
        num_kv_heads=max(d_model // 128, 1),
        head_dim=64,
        d_ff=4 * d_model,
        vocab_size=vocab,
        block_pattern=("attn",),
        mlp_act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )


def train(args, dev, ckpt_dir: str):
    cfg = lm_config(args.dmodel, args.layers, args.vocab)
    model = Model(cfg, xent_impl="seq_chunked", xent_seq_chunk=64)
    n = cfg.param_count()
    print(f"model: {cfg.name} (~{n/1e6:.1f}M params analytic)")

    pipe = tok.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch
    )
    scfg = TrainStepConfig(
        microbatches=args.microbatches,
        adamw=opt.AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=args.steps),
    )
    train_step = make_train_step(model, scfg)
    print(f"checkpoints: {ckpt_dir}")

    def init_state():
        params = model.init_params(torch.Generator().manual_seed(0), device=dev)
        return LoopState(step=0, params=params, opt_state=opt.init_state(params))

    def batch_at(step):
        return tok.device_batch(pipe, step, device=dev)

    lcfg = LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=20,
                      log_every=10)
    state = run(lcfg, train_step, init_state, batch_at)
    uniform = float(np.log(cfg.vocab_size))
    print(f"finished at step {state.step}; uniform-entropy floor would be "
          f"{uniform:.3f} nats — the structured stream should train well below it.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dmodel", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    if args.ckpt_dir is not None:
        train(args, dev, args.ckpt_dir)
    else:
        with tempfile.TemporaryDirectory(prefix="repro-train-") as td:
            train(args, dev, td)
    print(f"kernels: {json.dumps(launch_counts())}")
    print("ok")


if __name__ == "__main__":
    main()
