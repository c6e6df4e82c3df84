"""Shared model components: norms, RoPE, initializers.

The port's counterpart of ``repro/models/common.py``.  Modules are plain
functions over param dicts of tensors.  Params are stored in
``param_dtype`` (f32 by default) and cast to ``compute_dtype`` (bf16) at
use, as in the reference; a cast to the dtype a tensor already has is free,
so params stored once in the compute dtype (see
:func:`repro_torch.models.transformer.store_compute_dtype`) give the same
values without the per-use copy.

Initializers draw from an explicit :class:`torch.Generator` on the
generator's device and move the result to the caller's device.  They do not
reproduce the reference's JAX draws: tests carry the reference's weights
across with :func:`repro_torch.convert.lm_params_from_numpy`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def pdt(cfg) -> torch.dtype:
    """The config's parameter dtype."""
    return getattr(torch, cfg.param_dtype)


def cdt(cfg) -> torch.dtype:
    """The config's compute dtype."""
    return getattr(torch, cfg.compute_dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def make_norm_params(cfg, dim: int, device) -> dict:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=pdt(cfg), device=device)}
    return {"scale": torch.ones((dim,), dtype=pdt(cfg), device=device),
            "bias": torch.zeros((dim,), dtype=pdt(cfg), device=device)}


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if "bias" in p:
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies for half the head dim (f32, as the reference)."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x: torch.Tensor,  # (B, S, n, h)
               positions: torch.Tensor,  # (B, S)
               theta: float) -> torch.Tensor:
    """Standard rotary embedding over the full head dim (half-split layout)."""
    h = x.shape[-1]
    inv = torch.as_tensor(rope_freqs(h, theta), device=x.device)  # (h/2,)
    ang = positions[..., None].float() * inv  # (B, S, h/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor,  # (B, S, n, h)
                positions: torch.Tensor,  # (3, B, S): temporal / height / width
                theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: the half-dim frequency bands split into
    (t, h, w) sections (summing to h/2), each rotated by its own position
    stream.  With three equal streams (text) it is :func:`apply_rope`, bit
    for bit."""
    h = x.shape[-1]
    half = h // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    inv = torch.as_tensor(rope_freqs(h, theta), device=x.device)  # (h/2,)
    parts, start = [], 0
    for sec, pos in zip(sections, positions):
        parts.append(pos[..., None].float() * inv[start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)  # (B, S, h/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Initializers
# ----------------------------------------------------------------------------
def _trunc_normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``std``, drawn in f32 on the
    generator's device; on the ``meta`` device nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype=dtype, device=device)


def dense_init(gen: torch.Generator, shape, dtype, device,
               fan_in: Optional[int] = None) -> torch.Tensor:
    fi = fan_in if fan_in is not None else shape[0]
    return _trunc_normal(gen, shape, 1.0 / np.sqrt(max(fi, 1)), dtype, device)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    # std 1/sqrt(d): unit-variance logits under tied embeddings
    return _trunc_normal(gen, shape, 1.0 / np.sqrt(shape[-1]), dtype, device)
