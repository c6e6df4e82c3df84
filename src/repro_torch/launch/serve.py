"""Serving launcher: the batched LM engine for a registry architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --full

The port's counterpart of ``repro/launch/serve.py``, with ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).  Weights are
random from a seeded ``torch.Generator``; with ``--full`` each layer is
stored in the config's compute dtype as soon as it is drawn.  As in the
reference, an enc-dec config (Seamless-M4T) and a vision config (Qwen2-VL)
serve their text decoder alone: ``Engine`` takes tokens and has no memory
argument.  To drive the encoder, call ``Model.encode``, then
``Model.prefill(..., memory=)`` and the steps of
``serve.step.make_decode_step(model, max_seq)`` with ``memory``; to start
from patch embeddings, ``Model.prefill(params, {"embeds": e}, max_seq)``,
then ``decode_step`` on tokens.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.device import resolve
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfgbase.arch_ids())
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = cfgbase.get_config(args.arch) if args.full else cfgbase.get_reduced_config(args.arch)
    if cfg.is_encdec or cfg.frontend == "vision":
        print(f"note: {cfg.name} serves its text decoder; frontends are stubs")
    model = Model(cfg, rwkv_chunk=8)
    params = model.init_params(torch.Generator(dev).manual_seed(0), device=dev,
                               store_dtype=getattr(torch, cfg.compute_dtype) if args.full
                               else None)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(4, 32))).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    eng = Engine(model, params, lanes=args.lanes, max_seq=args.max_seq, device=dev)
    print("planned arena:", eng.plan_report())
    stats = eng.run(reqs)
    if not all(r.done for r in reqs):
        raise RuntimeError("the engine stopped with requests not done")
    print(f"served {len(reqs)} requests: prefills={stats.prefills} "
          f"decode_steps={stats.decode_steps} tokens={stats.tokens_out} "
          f"({stats.tokens_per_s:.1f} tok/s)")


if __name__ == "__main__":
    main()
