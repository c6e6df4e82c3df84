"""AdamW from scratch: clipping, the warmup + cosine schedule, decay mask.

The port's counterpart of ``repro/train/optimizer.py``, as plain functions
on the port's param tree (not ``torch.optim``, whose clipping, schedule and
decay differ).  The schedule and the bias corrections are computed in f32,
as the reference computes them; m and v are f32.

One difference of form: :func:`apply_adamw` updates the params, m and v in
place (leaf by leaf, so the peak is one leaf's temporaries) and returns
them, where the reference returns new arrays.

The reference's default decay mask is ``p.ndim >= 2`` on its *group-
stacked* leaves (``optimizer.py:82``), so every leaf of a layer inside a
pattern group — norm scales included — is decayed, and only remainder
layers and top-level leaves follow ``ndim >= 2``.
:func:`decay_mask_like_reference` gives that mask on the port's per-layer
lists; :func:`repro_torch.train.step.make_train_step` passes it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32
    m: Any  # tree like params, f32
    v: Any  # tree like params, f32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``·peak, in f32."""
    step = step.float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def init_state(params) -> AdamWState:
    """Step 0 and zero f32 moments, on the params' device."""
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params),
                      v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own dtype; the norm before scaling)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: scaled(g, scale), grads), norm


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a gradient of global norm ``norm`` to a norm
    of at most ``max_norm`` (1 when it is already there)."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g * scale`` computed in f32, in ``g``'s dtype."""
    return (g.float() * scale).to(g.dtype)


def decay_mask_like_reference(cfg, params) -> Any:
    """The reference's default decay mask, on the port's tree: True for
    every leaf of a layer that sits in a pattern group (an enc-dec config's
    encoder layers all do: the reference stacks them in ``enc_g0``),
    ``ndim >= 2`` for remainder layers and top-level leaves."""
    in_groups = cfg.num_layers // len(cfg.block_pattern) * len(cfg.block_pattern)
    out = {k: tree_map(lambda p: p.ndim >= 2, v) for k, v in params.items()
           if k not in ("layers", "enc_layers")}
    out["layers"] = [tree_map(lambda p, grouped=li < in_groups: grouped or p.ndim >= 2, layer)
                     for li, layer in enumerate(params["layers"])]
    if "enc_layers" in params:
        out["enc_layers"] = tree_map(lambda p: True, params["enc_layers"])
    return out


@torch.no_grad()
def apply_adamw(cfg: AdamWConfig, params, grads, state: AdamWState, *,
                decay_mask=None) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step, in place on ``params`` and ``state``'s m and v.
    ``decay_mask``: a tree of bools like params (default ``ndim >= 2``).
    Returns (params, new state, {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step, lr, bc1, bc2 = next_step(cfg, state.step)
    if decay_mask is None:
        decay_mask = tree_map(lambda p: p.ndim >= 2, params)
    tree_map(lambda p, g, m, v, decay: adamw_update(cfg, p, g, m, v, decay, lr, bc1, bc2),
             params, grads, state.m, state.v, decay_mask)
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}


def next_step(cfg: AdamWConfig, step: torch.Tensor):
    """(step + 1, its learning rate, the bias corrections 1 - b1^t and
    1 - b2^t), f32 scalars on the step's device."""
    step = step + 1
    stepf = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device) ** stepf
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device) ** stepf
    return step, lr_schedule(cfg, step), bc1, bc2


def adamw_update(cfg: AdamWConfig, p, g, m, v, decay: bool, lr, bc1, bc2) -> None:
    """One leaf's (or one shard's) AdamW update, in place on ``p``, ``m``
    and ``v``, from its clipped gradient ``g``; ``lr``, ``bc1`` and ``bc2``
    are the step's f32 scalars on the leaf's device."""
    b1, b2 = cfg.b1, cfg.b2
    gf = g.float()
    m.copy_(b1 * m + (1 - b1) * gf)
    v.copy_(b2 * v + (1 - b2) * torch.square(gf))
    delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    if cfg.weight_decay and decay:
        delta = delta + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))
