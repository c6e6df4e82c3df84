"""RWKV6 "Finch" block (arXiv:2404.05892): data-dependent-decay linear
attention (time-mix) + squared-ReLU channel-mix.

The port's counterpart of ``repro/models/rwkv6.py``.  Per head, with state
S in R^{hk x hv}:

    o_t = r_t^T S_{t-1} + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(d + lora_w(x)))

A multi-token time-mix runs K7 through
:func:`repro_torch.kernels.wkv.ops.wkv` (its plain version, the chunked
scan, on the CPU), from the zero state (prefill) or from a carried state (a
chunked prefill); one token runs :func:`wkv_step`, plain PyTorch, as the
reference computes it outside any kernel.  Whether the incoming state is
zero is said by the caller (``state=None``), never tested on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.models.common import cdt, dense_init, pdt

LORA_RANK = 32
DDLERP_RANK = 16


def init_rwkv_params(cfg, gen: torch.Generator, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    dt = pdt(cfg)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    def dense(shape, fan_in):
        return dense_init(gen, shape, dt, device, fan_in=fan_in)

    return {
        # time-mix (token-shift) base mix params + ddlerp LoRA
        "mu_x": full((d,), 0.5),
        "mu": full((5, d), 0.5),  # r,k,v,w,g
        "ddl_w1": dense((d, 5 * DDLERP_RANK), d),
        "ddl_w2": dense((5, DDLERP_RANK, d), DDLERP_RANK),
        # projections
        "wr": dense((d, d), d),
        "wk": dense((d, d), d),
        "wv": dense((d, d), d),
        "wg": dense((d, d), d),
        "wo": dense((d, d), d),
        # decay: base + lora
        "decay_base": full((d,), -4.0),
        "decay_w1": dense((d, LORA_RANK), d),
        "decay_w2": dense((LORA_RANK, d), LORA_RANK),
        "bonus_u": dense((H, hd), hd),
        # per-head groupnorm on wkv output
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
        # channel mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": dense((d, cfg.d_ff), d),
        "cm_wv": dense((cfg.d_ff, d), cfg.d_ff),
        "cm_wr": dense((d, d), d),
    }


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros or carried ``last`` at t=0).  x: (B,S,D)."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p, x, xprev):
    """Finch data-dependent token-shift interpolation → (r,k,v,w,g) inputs."""
    dx = xprev - x  # (B,S,D)
    xxx = x + dx * p["mu_x"].to(x.dtype)
    B, S, D = x.shape
    low = torch.tanh(xxx @ p["ddl_w1"].to(x.dtype))  # (B,S,5R)
    low = low.reshape(B, S, 5, DDLERP_RANK)
    adj = torch.einsum("bszr,zrd->bszd", low, p["ddl_w2"].to(x.dtype))  # (B,S,5,D)
    mixed = x[:, :, None] + dx[:, :, None] * (p["mu"].to(x.dtype) + adj)
    return [mixed[:, :, i] for i in range(5)]  # r,k,v,w,g inputs


def time_mix_inputs(p, x, xprev):
    """What the time-mix reads of replicated leaves alone: the token-shift
    inputs (xr, xk, xv, xg) and the decay LoRA's hidden layer
    (:func:`_decay_hidden`), in the order (xr, xk, xv, hidden, xg)."""
    xr, xk, xv, xw, xg = _ddlerp(p, x, xprev)
    return xr, xk, xv, _decay_hidden(p, xw), xg


def _decay_hidden(p, xw):
    """The decay LoRA's hidden layer, tanh(xw decay_w1)."""
    return torch.tanh(xw @ p["decay_w1"].to(xw.dtype))


def _decay_out(p, hidden, cols=slice(None)):
    """log-decay (<= ~0) from the LoRA's hidden layer: -exp(base + lora) per
    channel, f32, for the channels ``cols`` of ``decay_w2`` and
    ``decay_base``."""
    lora = hidden @ p["decay_w2"][:, cols].to(hidden.dtype)
    return -torch.exp(torch.clamp(p["decay_base"][cols].float() + lora.float(), -8.0, 4.0))


def _decay(p, xw):
    """log-decay (<= ~0): logw = -exp(base + lora(xw)) per channel, f32."""
    return _decay_out(p, _decay_hidden(p, xw))


def wkv_step(r, k, v, logw, u, s):
    """Single decode step.  r,k,v,logw: (B,H,h·); s: (B,H,hk,hv) f32."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    o = torch.einsum("bhk,bhkv->bhv", rf, s) + torch.einsum(
        "bhk,hk,bhk->bh", rf, u.float(), kf)[..., None] * vf
    s_new = s * torch.exp(wf)[..., None] + kf[..., None] * vf[:, :, None]
    return o, s_new


def _time_mix_inner(cfg, p, x, xprev, state, chunk):
    """The time-mix after the token-shift inputs are known.  ``state=None``
    is the zero state; several tokens from a carried state (a chunked
    prefill) run K7 from ``state``."""
    return heads_mix(cfg, p, time_mix_inputs(p, x, xprev), state, chunk)


def heads_mix(cfg, p, mixed, state, chunk, cols=slice(None)):
    """The time-mix from its inputs ``mixed`` (:func:`time_mix_inputs`) over
    the heads of ``p``'s ``bonus_u`` rows, whose
    channels are ``wr`` / ``wk`` / ``wv`` / ``wg``'s columns, ``wo``'s rows
    and the channels ``cols`` of ``decay_w2``, ``decay_base``, ``gn_scale``
    and ``gn_bias`` (every head and channel by default): (their share of
    the output, (B, S, D) in the compute dtype, and their new state, (B,
    H_p, hk, hv) f32).  ``state`` is those heads' incoming state, or None
    for the zero state."""
    xr, xk, xv, hidden, xg = mixed
    B, S, _ = xr.shape
    hd = cfg.rwkv_head_dim
    H = p["bonus_u"].shape[0]
    cd = cdt(cfg)
    r = (xr @ p["wr"].to(xr.dtype)).reshape(B, S, H, hd)
    k = (xk @ p["wk"].to(xk.dtype)).reshape(B, S, H, hd)
    v = (xv @ p["wv"].to(xv.dtype)).reshape(B, S, H, hd)
    g = F.silu(xg @ p["wg"].to(xg.dtype))
    logw = _decay_out(p, hidden, cols).reshape(B, S, H, hd)

    if S == 1:
        s0 = state if state is not None else torch.zeros(
            (B, H, hd, hd), dtype=torch.float32, device=xr.device)
        o, s_new = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["bonus_u"], s0)
        o = o[:, None]
    else:
        o, s_new = wkv_ops.wkv(r, k, v, logw, p["bonus_u"], chunk=chunk, s0=state)

    # per-head groupnorm (as common.layernorm, F.layer_norm for its backward)
    o = o.reshape(B, S, H, hd)
    o = F.layer_norm(o, (hd,), eps=64e-5)
    o = o.reshape(B, S, H * hd) * p["gn_scale"][cols].float() + p["gn_bias"][cols].float()
    out = (o.to(cd) * g.to(cd)) @ p["wo"].to(cd)
    return out, s_new


def time_mix(cfg, p, x, state=None, last_x=None, chunk: int = 64):
    """x: (B,S,D).  state: (B,H,hk,hv), or None for the zero state.
    Returns (out, new_state, new_last_x)."""
    xprev = _shift(x, last_x)
    out, s_new = _time_mix_inner(cfg, p, x, xprev, state, chunk)
    return out, s_new, x[:, -1]


def channel_inputs(p, x, last_x=None):
    """The channel-mix's token-shift inputs (xk, xr)."""
    xprev = _shift(x, last_x)
    xk = x + (xprev - x) * p["cm_mu_k"].to(x.dtype)
    xr = x + (xprev - x) * p["cm_mu_r"].to(x.dtype)
    return xk, xr


def channel_kv(cfg, p, xk):
    """relu(xk cm_wk)² cm_wv in the compute dtype: a ``d_ff`` block's
    partial for that block of ``cm_wk``'s columns and ``cm_wv``'s rows."""
    cd = cdt(cfg)
    k = torch.square(F.relu(xk.to(cd) @ p["cm_wk"].to(cd)))
    return k @ p["cm_wv"].to(cd)


def channel_gate(cfg, p, xr):
    """σ(xr cm_wr), f32: the columns of ``cm_wr``'s block."""
    cd = cdt(cfg)
    return torch.sigmoid((xr.to(cd) @ p["cm_wr"].to(cd)).float())


def channel_mix(cfg, p, x, last_x=None):
    """Squared-ReLU channel mix with token shift."""
    xk, xr = channel_inputs(p, x, last_x)
    kv = channel_kv(cfg, p, xk)
    r = channel_gate(cfg, p, xr)
    return r.to(cdt(cfg)) * kv, x[:, -1]
