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
A data row's span of a sequence split over the data axes
(:func:`apply_moe_span`) keeps it too: the capacity is the whole token
group's, each choice's slot counts the choices of the group's earlier
tokens in the rows before (the carried per-expert counts, reset at a group
boundary), and the aux loss is taken once, on the last span, from the
router sums over the whole sequence.
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


def route(cfg, p: dict, x: torch.Tensor, C: int, counts=None) -> dict:
    """The router's decisions for x (B, S, D) at capacity C: ``probs``
    (B, S, E), ``onehot_e`` (B, S, k, E; the top-k experts), ``gate``
    (B, S, k; renormalised, zeroed where dropped), ``pos`` (each choice's
    slot) and ``keep`` (pos < C).  ``counts`` (B, E): the choices each
    expert already took in this token group (the tokens before ``x``),
    which every slot follows; None for a group's first token."""
    k, E = cfg.moe.top_k, cfg.moe.num_experts
    B, S, _ = x.shape
    logits = x.float() @ p["router"].float()  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)  # (B, S, k)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    onehot_e = F.one_hot(idx, E).float()  # (B, S, k, E)
    flat = onehot_e.reshape(B, S * k, E)
    pos = torch.cumsum(flat, dim=1) - flat  # entries before me
    if counts is not None:
        pos = pos + counts[:, None].to(pos.device)
    pos = (pos * flat).sum(dim=-1).reshape(B, S, k).to(torch.int32)
    keep = pos < C
    return {"probs": probs, "onehot_e": onehot_e, "pos": pos, "keep": keep,
            "gate": gate * keep.to(gate.dtype)}


def combine_weights(r: dict, C: int) -> torch.Tensor:
    """combine (B, S, E, C) from :func:`route`'s decisions: combine[b, s, e,
    c] = Σ_k gate · 1[expert = e] · 1[slot = c], zero where dropped."""
    keep = r["keep"]
    onehot_c = F.one_hot(torch.where(keep, r["pos"], 0).long(), C).float() * keep[..., None]
    return torch.einsum("bske,bskc->bsec", r["onehot_e"] * r["gate"][..., None], onehot_c)


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


def group_length(S: int, group_size: int = 4096) -> int:
    """The length of the token groups :func:`token_groups` cuts a row of S
    tokens into."""
    return group_size if S > group_size and S % group_size == 0 else S


def token_groups(x: torch.Tensor, group_size: int = 4096) -> torch.Tensor:
    """x (B, S, D) with each row longer than ``group_size`` and a multiple
    of it split into rows of ``group_size`` tokens, each routed with its
    own capacity, as in the reference; ``x`` itself otherwise."""
    B, S, D = x.shape
    G = group_length(S, group_size)
    return x if G == S else x.reshape(B * (S // G), G, D)


def plan(cfg, p: dict, x: torch.Tensor, capacity_factor: float = 1.25):
    """(:func:`route`'s decisions, :func:`combine_weights`) for one group
    x (B, S, D), at the capacity of S tokens."""
    C = capacity(cfg, x.shape[1], capacity_factor)
    r = route(cfg, p, x, C)
    return r, combine_weights(r, C)


def shared_gate(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The shared expert's sigmoid gate (B, S, 1) in the compute dtype."""
    cd = cdt(cfg)
    return torch.sigmoid((x.to(cd) @ p["shared_gate"].to(cd)).float()).to(cd)


def aux_loss(cfg, r: dict) -> torch.Tensor:
    """The Switch load-balancing loss of :func:`route`'s decisions: E · Σ_e
    f_e · P_e (f the fraction of choices routed to e, P its mean prob),
    times ``router_aux_weight``."""
    m = cfg.moe
    token_frac = r["onehot_e"].sum(dim=2).mean(dim=(0, 1))  # (E,)
    prob_mean = r["probs"].mean(dim=(0, 1))  # (E,)
    return m.num_experts * torch.sum(token_frac * prob_mean) * m.router_aux_weight


def aux_from_sums(cfg, frac: torch.Tensor, prob: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`aux_loss` from the sums over ``n`` tokens of the choices each
    expert took (``frac``, (E,)) and of its router probability (``prob``)."""
    m = cfg.moe
    return m.num_experts * torch.sum((frac / n) * (prob / n)) * m.router_aux_weight


def plan_span(cfg, p: dict, x: torch.Tensor, span, carry, capacity_factor: float = 1.25,
              group_size: int = 4096):
    """:func:`plan` for a data row's span of a sequence split over the data
    axes: x (B, S_r, D), the positions ``span.start``..``span.stop`` of a
    sequence of ``span.total``.  The span is cut where a token group of the
    whole sequence ends; each piece is routed at the capacity of a whole
    group, its slots after the ``carry["counts"]`` of the group's earlier
    tokens (the rows before; reset at a group's first token).  Returns
    ([(first, last, decisions, combine)] of the pieces, in order, the carry
    for the next row: ``counts`` (B, E), and the sums over the sequence so
    far of each expert's choices (``frac``) and router probability
    (``prob``), f32 (E,))."""
    G = group_length(span.total, group_size)
    C = capacity(cfg, G, capacity_factor)
    carry = carry or {}
    counts, frac, prob = carry.get("counts"), carry.get("frac"), carry.get("prob")
    pieces, a, S = [], 0, x.shape[1]
    while a < S:
        pos = span.start + a
        b = min(S, a + G - pos % G)
        if pos % G == 0:
            counts = None
        r = route(cfg, p, x[:, a:b], C, counts)
        pieces.append((a, b, r, combine_weights(r, C)))
        took = r["onehot_e"].sum(dim=2)  # (B, b - a, E)
        n = took.sum(dim=1)
        counts = n if counts is None else counts.to(n.device) + n
        f, pr = took.sum(dim=(0, 1)), r["probs"].sum(dim=(0, 1))
        frac = f if frac is None else frac.to(f.device) + f
        prob = pr if prob is None else prob.to(pr.device) + pr
        a = b
    return pieces, {"counts": counts, "frac": frac, "prob": prob}


def span_aux(cfg, span, carry: dict, batch: int, device) -> torch.Tensor:
    """The span's share of the aux loss: the whole sequence's
    (:func:`aux_from_sums`) on its last span, an f32 zero before."""
    if span.stop < span.total:
        return torch.zeros((), dtype=torch.float32, device=device)
    return aux_from_sums(cfg, carry["frac"], carry["prob"], batch * span.total)


def apply_moe_span(cfg, p: dict, x: torch.Tensor, span, carry,
                   capacity_factor: float = 1.25, group_size: int = 4096):
    """:func:`apply_moe` on a data row's span (:func:`plan_span`): (out,
    its share of the aux loss (:func:`span_aux`), the carry)."""
    pieces, carry = plan_span(cfg, p, x, span, carry, capacity_factor, group_size)
    out = torch.cat([expert_mix(cfg, p, x[:, a:b], combine) for a, b, _, combine in pieces],
                    dim=1)
    if cfg.moe.d_ff_shared:
        out = out + mlp_mod.apply_mlp(cfg, p["shared"], x) * shared_gate(cfg, p, x)
    return out.to(x.dtype), span_aux(cfg, span, carry, x.shape[0], x.device), carry


def apply_moe(cfg, p: dict, x: torch.Tensor, capacity_factor: float = 1.25,
              group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out, aux loss), over :func:`token_groups`."""
    xg = token_groups(x, group_size)
    r, combine = plan(cfg, p, xg, capacity_factor)
    out = expert_mix(cfg, p, xg, combine)
    if cfg.moe.d_ff_shared:
        out = out + mlp_mod.apply_mlp(cfg, p["shared"], xg) * shared_gate(cfg, p, xg)
    return out.to(x.dtype).reshape(x.shape), aux_loss(cfg, r)
