"""Training launcher for a registry architecture.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --full

The port's counterpart of ``repro/launch/train.py``, with ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions) and
``--full`` (the published config; default the reduced one).  Params are
f32 (``param_dtype``) from a seeded ``torch.Generator``, compute in the
config's dtype; AdamW as :func:`adamw_config` sets it; batches from the
synthetic token pipeline (:func:`frontend_batch`: a vision config, Qwen2-VL,
trains on ``{"embeds", "targets"}`` with no tokens, and an enc-dec config,
Seamless-M4T, gets ``src_embeds`` beside its tokens); checkpoints every 10
steps.  Every family trains.
"""
from __future__ import annotations

import argparse
import tempfile

import torch
import torch.nn.functional as F

from repro_torch.configs import base as cfgbase
from repro_torch.data import tokens as tok
from repro_torch.device import resolve
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, LoopState, run
from repro_torch.train.step import TrainStepConfig, make_train_step


def adamw_config(steps: int) -> opt.AdamWConfig:
    """The launcher's AdamW: peak 1e-3 after 5 warmup steps, cosine over
    ``steps``."""
    return opt.AdamWConfig(lr_peak=1e-3, warmup_steps=5, total_steps=steps)


def frontend_batch(cfg, batch: dict) -> dict:
    """A token-pipeline batch as the config's stub frontend takes it, with
    the reference's stand-in for the frontend's output, the one-hot of each
    token id modulo ``d_model``: ``{"embeds", "targets"}`` for a vision
    config, the batch and ``src_embeds`` for an enc-dec config, the batch
    as it is otherwise."""
    if cfg.frontend != "vision" and not cfg.is_encdec:
        return batch
    stub = F.one_hot(batch["tokens"].long() % cfg.d_model, cfg.d_model).float()
    if cfg.frontend == "vision":
        return {"embeds": stub, "targets": batch["targets"]}
    return {**batch, "src_embeds": stub}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfgbase.arch_ids())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the reduced one)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = cfgbase.get_config(args.arch) if args.full else cfgbase.get_reduced_config(args.arch)
    model = Model(cfg, xent_impl="seq_chunked", xent_seq_chunk=max(args.seq // 4, 8),
                  rwkv_chunk=8)
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} device={dev}")

    pipe = tok.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                   global_batch=args.batch)
    step = make_train_step(model, TrainStepConfig(microbatches=args.microbatches,
                                                  adamw=adamw_config(args.steps)))

    def init_state():
        params = model.init_params(torch.Generator(dev).manual_seed(0), device=dev)
        return LoopState(step=0, params=params, opt_state=opt.init_state(params))

    def batch_at(s):
        return frontend_batch(cfg, tok.device_batch(pipe, s, dev))

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix=f"repro-torch-{args.arch}-")
    lcfg = LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir, ckpt_every=10, log_every=5)
    state = run(lcfg, step, init_state, batch_at)
    print(f"done at step {state.step}; checkpoints in {ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
