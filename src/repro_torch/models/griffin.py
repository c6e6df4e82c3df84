"""Griffin / RecurrentGemma recurrent block (arXiv:2402.19427).

The port's counterpart of ``repro/models/griffin.py``.  The block:
x → [gate branch: GeLU(W_gate x)] ⊙ RG-LRU(conv1d(W_rec x)), projected back
to d_model.  The RG-LRU:

    r_t = σ(W_a ξ_t + b_a)                 (recurrence gate)
    i_t = σ(W_x ξ_t + b_x)                 (input gate)
    log a_t = −c · softplus(Λ) ⊙ r_t       (c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ ξ_t)

The reference evaluates the linear recurrence over a prompt with
``jax.lax.associative_scan``; :func:`rg_lru` does it with a log-depth
doubling scan (Hillis–Steele on the ``(a, b)`` pairs, ⌈log₂ S⌉ rounds of a
few whole-tensor ops), so a prefill makes a few launches a layer, not S.
Both sum in f32, in different orders.  The scan is plain PyTorch on every
device: the reference computes it with XLA ops, outside any Pallas kernel.
Decode carries (h, conv tail) per layer: O(1) state in sequence length.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import cdt, dense_init, pdt

_C = 8.0


def init_griffin_params(cfg, gen: torch.Generator, device) -> dict:
    d = cfg.d_model
    rw = cfg.lru_width or d
    W = cfg.conv1d_width
    dt = pdt(cfg)
    # Λ so that a ∈ (0.9, 0.999) at r = 1 (Griffin appendix)
    a = torch.linspace(0.9, 0.999, rw, dtype=torch.float32)
    lam = torch.log(torch.expm1(-torch.log(a) / _C))
    return {
        "w_gate": dense_init(gen, (d, rw), dt, device, fan_in=d),
        "w_rec": dense_init(gen, (d, rw), dt, device, fan_in=d),
        "conv_w": dense_init(gen, (W, rw), dt, device, fan_in=W),
        "conv_b": torch.zeros((rw,), dtype=dt, device=device),
        "w_a": dense_init(gen, (rw, rw), dt, device, fan_in=rw),
        "b_a": torch.zeros((rw,), dtype=dt, device=device),
        "w_x": dense_init(gen, (rw, rw), dt, device, fan_in=rw),
        "b_x": torch.zeros((rw,), dtype=dt, device=device),
        "lam": lam.to(dtype=dt, device=device),
        "w_out": dense_init(gen, (rw, d), dt, device, fan_in=rw),
    }


def init_griffin_state(cfg, batch: int, device) -> dict:
    """``h`` f32 (B, rw); ``conv`` the last W−1 conv inputs, (B, W−1, rw)
    in the compute dtype."""
    rw = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, rw), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, rw), dtype=cdt(cfg),
                            device=device),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width W.  x: (B, S, rw); w: (W, rw).

    Returns (y, new_tail), the tail carrying the last W−1 inputs for
    decode.  Taps sum in the reference's order, tap 0 first, then ``+ b``.
    """
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([tail, x], dim=1)  # (B, S+W-1, rw)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    new_tail = xp[:, S:] if W > 1 else tail
    return y + b, new_tail


def _gates(log_a: torch.Tensor, i_gate: torch.Tensor, xi: torch.Tensor):
    """(a, b) of one step: a = exp(log a), b = √(1 − a²) ⊙ i ⊙ ξ, with
    1 − a² = −expm1(2 log a) for stability near a = 1."""
    return torch.exp(log_a), torch.sqrt(-torch.expm1(2.0 * log_a)) * (i_gate * xi)


def rg_lru(xi: torch.Tensor,  # (B, S, rw) f32
           r_gate: torch.Tensor, i_gate: torch.Tensor,
           log_a_base: torch.Tensor,  # (rw,) = −c·softplus(Λ) ≤ 0
           h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over a prompt: (h (B, S, rw), h at the last position).

    A doubling scan: after the round of stride s, position t holds the
    composition of steps max(0, t − 2s + 1)..t, combined as the
    reference's ``combine``, (a₁, b₁) ∘ (a₂, b₂) = (a₁a₂, a₂b₁ + b₂).
    ``h0`` folds into step 1: h₁ = a₁ h₀ + b₁."""
    a, b = _gates(log_a_base * r_gate, i_gate, xi)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    s = 1
    while s < S:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < S:  # the last round needs no products of a
            a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    return b, b[:, -1]


def rg_lru_step(xi, r_gate, i_gate, log_a_base, h):
    """One decode step.  xi, r, i: (B, rw); h: (B, rw)."""
    a, b = _gates(log_a_base * r_gate, i_gate, xi)
    h_new = a * h + b
    return h_new, h_new


def rec_inputs(cfg, p: dict, x: torch.Tensor, tail: Optional[torch.Tensor],
               cols=slice(None)):
    """The channels of ``p``'s ``w_gate`` / ``w_rec`` / ``conv_w`` columns
    (``conv_b``'s ``cols``): (the GeLU gate branch, ξ in f32 after the
    causal conv from ``tail``, the new conv tail)."""
    cd = cdt(cfg)
    xc = x.to(cd)
    gate = F.gelu(xc @ p["w_gate"].to(cd), approximate="tanh")
    xi = xc @ p["w_rec"].to(cd)
    xi, conv_tail = causal_conv1d(xi, p["conv_w"].to(cd), p["conv_b"][cols].to(cd), tail)
    return gate, xi.float(), conv_tail


def recurrence(cfg, p: dict, gate: torch.Tensor, xf_all: torch.Tensor, xf: torch.Tensor,
               h0: Optional[torch.Tensor], step: bool, cols=slice(None)):
    """The RG-LRU and the output projection of the channels ``cols``, whose
    blocks ``p``'s ``w_a`` / ``w_x`` columns and ``w_out`` rows are: the
    gates read every channel of ξ (``xf_all``) and act on these (``xf``,
    ``gate``, ``h0``); ``step`` takes :func:`rg_lru_step` (one token from a
    state).  Returns (their share of the output (B, S, D), h at the last
    position)."""
    cd = cdt(cfg)
    r_gate = torch.sigmoid(xf_all @ p["w_a"].float() + p["b_a"][cols].float())
    i_gate = torch.sigmoid(xf_all @ p["w_x"].float() + p["b_x"][cols].float())
    log_a_base = -_C * F.softplus(p["lam"][cols].float())
    if step:
        h_step, h_last = rg_lru_step(xf[:, 0], r_gate[:, 0], i_gate[:, 0], log_a_base, h0)
        h = h_step[:, None]
    else:
        h, h_last = rg_lru(xf, r_gate, i_gate, log_a_base, h0)
    return (gate * h.to(cd)) @ p["w_out"].to(cd), h_last


def griffin_block(cfg, p: dict, x: torch.Tensor,  # (B, S, D)
                  state: Optional[dict] = None  # {"h": (B, rw), "conv": (B, W-1, rw)}
                  ) -> Tuple[torch.Tensor, dict]:
    """The recurrent block; returns (out (B, S, D), new state).  The gate
    products and softplus(Λ) are f32 whatever the compute dtype, as in the
    reference; with one token and a state it takes :func:`rg_lru_step`."""
    gate, xf, conv_tail = rec_inputs(cfg, p, x, None if state is None else state["conv"])
    h0 = None if state is None else state["h"]
    out, h_last = recurrence(cfg, p, gate, xf, xf, h0, x.shape[1] == 1 and state is not None)
    return out, {"h": h_last, "conv": conv_tail}
