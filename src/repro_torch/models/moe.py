"""Mixture-of-Experts layer (Mixtral / Qwen2-MoE style).

The port's counterpart of ``repro/models/moe.py``: GShard one-hot
dispatch/combine einsums with per-sequence token groups and a capacity
factor, and shared experts (Qwen2-MoE) as a dense gated MLP over all
tokens with a sigmoid gate.  Router math in f32; top-k gates renormalised;
the Switch load-balancing loss returned beside the output.

Tokens past an expert's capacity are dropped (their gate zeroed), in the
reference's order: the capacity slot of each (token, choice) is its place
in the flattened (S·k) order of its batch row.  A drop changes a token's
output by a whole expert, so the port keeps exactly the reference's rule.
The expert products are plain ``torch.einsum`` (cuBLAS on the card): the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import cdt, dense_init, pdt


def capacity(cfg, tokens_per_group: int, factor: float = 1.25) -> int:
    """Slots per expert: ⌈tokens · k · factor / E⌉, padded to a multiple of
    8, at least 8."""
    m = cfg.moe
    c = int(math.ceil(tokens_per_group * m.top_k * factor / m.num_experts))
    return max(8, ((c + 7) // 8) * 8)


def init_moe_params(cfg, gen: torch.Generator, device) -> dict:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {
        "router": dense_init(gen, (d, E), torch.float32, device, fan_in=d),
        "wi": dense_init(gen, (E, d, f), pdt(cfg), device, fan_in=d),
        "wo": dense_init(gen, (E, f, d), pdt(cfg), device, fan_in=f),
    }
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, (E, d, f), pdt(cfg), device, fan_in=d)
    if m.d_ff_shared:
        p["shared"] = mlp_mod.init_mlp_params(cfg, gen, device, d_ff=m.d_ff_shared)
        p["shared_gate"] = dense_init(gen, (d, 1), pdt(cfg), device, fan_in=d)
    return p


def route(cfg, p: dict, x: torch.Tensor, C: int) -> dict:
    """The router's decisions for x (B, S, D) at capacity C: ``probs``
    (B, S, E), ``onehot_e`` (B, S, k, E; the top-k experts), ``gate``
    (B, S, k; renormalised, zeroed where dropped), ``pos`` (each choice's
    slot) and ``keep`` (pos < C)."""
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    B, S, _ = x.shape
    logits = x.float() @ p["router"].float()  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)  # (B, S, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    onehot_e = F.one_hot(idx, E).float()  # (B, S, k, E)
    flat = onehot_e.reshape(B, S * k, E)
    pos = torch.cumsum(flat, dim=1) - flat  # entries before me
    pos = (pos * flat).sum(dim=-1).reshape(B, S, k).to(torch.int32)
    keep = pos < C
    return {"probs": probs, "onehot_e": onehot_e, "pos": pos, "keep": keep,
            "gate": gate * keep.to(gate.dtype)}


def expert_mix(cfg, p: dict, x: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """The dispatch einsum, the experts' MLPs and the combine einsum:
    x (B, S, D) and combine (B, S, E, C) → (B, S, D) in the compute dtype."""
    cd = cdt(cfg)
    dispatch = (combine > 0).to(cd)
    xin = torch.einsum("bsec,bsd->becd", dispatch, x.to(cd))  # (B, E, C, D)
    h = torch.einsum("becd,edf->becf", xin, p["wi"].to(cd))
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", xin, p["wg"].to(cd))) * h
    elif cfg.mlp_act == "geglu":
        h = F.gelu(torch.einsum("becd,edf->becf", xin, p["wg"].to(cd)),
                   approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    out_e = torch.einsum("becf,efd->becd", h, p["wo"].to(cd))
    return torch.einsum("bsec,becd->bsd", combine.to(cd), out_e)


def apply_moe(cfg, p: dict, x: torch.Tensor, capacity_factor: float = 1.25,
              group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out, aux loss).  A row longer than ``group_size`` and
    a multiple of it is split into groups of ``group_size`` tokens, each
    with its own capacity, as in the reference."""
    m = cfg.moe
    B, S, D = x.shape
    if S > group_size and S % group_size == 0:
        n = S // group_size
        out, aux = apply_moe(cfg, p, x.reshape(B * n, group_size, D), capacity_factor,
                             group_size)
        return out.reshape(B, S, D), aux
    E = m.num_experts
    C = capacity(cfg, S, capacity_factor)
    cd = cdt(cfg)
    r = route(cfg, p, x, C)
    keep = r["keep"]
    onehot_c = F.one_hot(torch.where(keep, r["pos"], 0).long(), C).float() * keep[..., None]
    # combine[b,s,e,c] = Σ_k gate · 1[expert = e] · 1[slot = c]
    combine = torch.einsum("bske,bskc->bsec", r["onehot_e"] * r["gate"][..., None],
                           onehot_c)
    out = expert_mix(cfg, p, x, combine)

    if m.d_ff_shared:
        shared = mlp_mod.apply_mlp(cfg, p["shared"], x)
        sg = torch.sigmoid((x.to(cd) @ p["shared_gate"].to(cd)).float())
        out = out + shared * sg.to(cd)

    # Switch aux loss: E · Σ_e f_e · P_e (f = token fraction, P = mean prob)
    token_frac = r["onehot_e"].sum(dim=2).mean(dim=(0, 1))  # (E,)
    prob_mean = r["probs"].mean(dim=(0, 1))  # (E,)
    aux = E * torch.sum(token_frac * prob_mean) * m.router_aux_weight
    return out.to(x.dtype), aux
