"""MLP variants: SwiGLU / GeGLU / GELU / squared-ReLU.

The port's counterpart of ``repro/models/mlp.py``.  GELU is the tanh
approximation, as the reference's ``jax.nn.gelu(approximate=True)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import cdt, dense_init, pdt


def init_mlp_params(cfg, gen: torch.Generator, device, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    p = {"wi": dense_init(gen, (d, f), pdt(cfg), device, fan_in=d)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, (d, f), pdt(cfg), device, fan_in=d)
    p["wo"] = dense_init(gen, (f, d), pdt(cfg), device, fan_in=f)
    return p


def apply_mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    cd = cdt(cfg)
    x = x.to(cd)
    h = x @ p["wi"].to(cd)
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["wg"].to(cd)) * h
    elif cfg.mlp_act == "geglu":
        h = F.gelu(x @ p["wg"].to(cd), approximate="tanh") * h
    elif cfg.mlp_act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(cfg.mlp_act)
    return h @ p["wo"].to(cd)
