"""Train-step factory: loss, gradients, optional microbatch accumulation, AdamW.

The port's counterpart of ``repro/train/step.py::make_train_step``:

* microbatch gradient accumulation (every leaf of the batch split into
  ``microbatches`` equal parts along its first axis: ``tokens`` or a
  vision batch's ``embeds``, ``targets``, ``mask``), summed in
  ``grad_dtype`` (``bfloat16`` is the reference's compressed
  accumulation), then loss/n and grads/n;
* remat comes from the model (``Model.remat``);
* AdamW with the reference's decay mask
  (:func:`repro_torch.train.optimizer.decay_mask_like_reference`).

Metrics: ``loss``, ``grad_norm`` (before clipping) and ``lr``, plus ``ce``
and ``aux`` from the model when there is one microbatch (the reference
drops them when it accumulates).  ``jit_train_step`` (sharded in/out
placements) waits for ``ShardingPolicy``, the multi-card half of item 6c
(ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    grad_dtype: str = "float32"  # "bfloat16" → compressed grad accumulation
    adamw: opt.AdamWConfig = opt.AdamWConfig()


def value_and_grad(model, params, batch: dict) -> Tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of ``model.train_loss`` at ``params``; grads
    is a tree like params (zeros for a leaf the loss does not use)."""
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    try:
        loss, metrics = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    finally:
        for t in flat:
            t.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, grads))


def make_train_step(model, step_cfg: TrainStepConfig = TrainStepConfig()):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and the optimizer moments are updated in place."""
    gdt = getattr(torch, step_cfg.grad_dtype)
    n = step_cfg.microbatches

    def train_step(params, opt_state, batch):
        if n > 1:
            B = batch["targets"].shape[0]
            if any(v.shape[0] != B for v in batch.values()) or B % n:
                raise ValueError(f"batch {B} does not split into {n} microbatches")
            loss_sum = torch.zeros((), dtype=torch.float32, device=batch["targets"].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt, device=p.device), params)
            for i in range(n):
                mb = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
                loss, _, g = value_and_grad(model, params, mb)
                grads = tree_map(lambda a, gi: a + gi.to(gdt), grads, g)
                loss_sum = loss_sum + loss
                del g
            loss = loss_sum / n
            grads = tree_map(lambda g: g / n, grads)
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(model, params, batch)
        params, opt_state, om = opt.apply_adamw(
            step_cfg.adamw, params, grads, opt_state,
            decay_mask=opt.decay_mask_like_reference(model.cfg, params))
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
