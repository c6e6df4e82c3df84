"""K7's plain version: the chunked wkv6 scan from a carried state.

The port's counterpart of ``repro/models/rwkv6.py::wkv_chunked`` (the oracle
of ``repro/kernels/wkv``), with the same meaning of ``s0``, the incoming
state; None is the zero state, the TPU kernel's (``kernel.py:23-25``).  Only
chunk-boundary states are carried; every exponent is a log-decay difference
with t >= s, hence <= 0.

Computed in f32 throughout, as the reference and K7 (``csrc/wkv_fwd.cu``)
are; its sums round in PyTorch's order, K7's in a fixed sequential one.
:func:`wkv_two_pass` models K7's own order on the CPU: its tiles, a ragged
last tile, the intra-tile pass, then the carry in slices of state columns.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv_chunked(
    r: torch.Tensor,  # (B, S, H, hk)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, S, H, hv)
    logw: torch.Tensor,  # (B, S, H, hk) log decay, <= 0
    u: torch.Tensor,  # (H, hk) bonus
    s0: Optional[torch.Tensor] = None,  # (B, H, hk, hv) incoming state; None: zero
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (o: (B, S, H, hv) f32, s_final: (B, H, hk, hv) f32)."""
    B, S, H, hk = r.shape
    hv = v.shape[-1]
    if S % chunk:
        raise ValueError(f"wkv_chunked: chunk {chunk} does not divide S={S}")
    n = S // chunk

    def chunks(x, d):  # (B, S, H, d) -> (n, B, H, C, d), f32
        return x.float().reshape(B, n, chunk, H, d).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = chunks(r, hk), chunks(k, hk), chunks(v, hv), chunks(logw, hk)
    u = u.float()
    ci = torch.arange(chunk, device=r.device)
    mask_lt = (ci[:, None] > ci[None, :]).float()  # t > s strictly
    s = (torch.zeros((B, H, hk, hv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    outs = []
    for rb, kb, vb, wb in zip(rc, kc, vc, wc):  # (B, H, C, ·)
        la = torch.cumsum(wb, dim=2)  # cumulative log decay
        la_prev = la - wb
        # history read: (r_t * exp(la_{t-1})) @ S_in
        o = torch.einsum("bhck,bhkv->bhcv", rb * torch.exp(la_prev), s)
        # intra-chunk: pair[t, s] = sum_i r_t[i] k_s[i] exp(la_{t-1}[i] - la_s[i]), s < t
        expo = la_prev[:, :, :, None] - la[:, :, None]  # (B, H, C_t, C_s, hk)
        pair = torch.einsum("bhck,bhsk,bhcsk->bhcs", rb, kb,
                            torch.exp(torch.clamp(expo, max=0.0)))
        o = o + torch.einsum("bhcs,bhsv->bhcv", pair * mask_lt, vb)
        # bonus diagonal: (r_t . (u * k_t)) v_t
        o = o + torch.einsum("bhck,hk,bhck->bhc", rb, u, kb)[..., None] * vb
        # state: S <- diag(exp(la_C)) S + sum_s diag(exp(la_C - la_s)) k_s v_s^T
        la_end = la[:, :, -1:]
        s = s * torch.exp(la_end.squeeze(2))[..., None] + torch.einsum(
            "bhsk,bhsv->bhkv", kb * torch.exp(la_end - la), vb)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, hv)
    return o, s


def _tile_decay(w: torch.Tensor):
    """(la, la_prev) of one tile: the cumulative log decay along dim 2."""
    la = torch.cumsum(w, dim=2)
    return la, la - w


def wkv_two_pass(
    r: torch.Tensor,  # (B, S, H, hk)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, S, H, hv)
    logw: torch.Tensor,  # (B, S, H, hk) log decay, <= 0
    u: torch.Tensor,  # (H, hk) bonus
    s0: Optional[torch.Tensor] = None,  # (B, H, hk, hv) incoming state; None: zero
    *,
    tile: int = 32,
    hv_tile: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The order K7 (``csrc/wkv_fwd.cu``) computes the scan in, in plain
    PyTorch: S cut into tiles of ``tile`` steps whatever divides S (the last
    one ragged); first every tile's intra-tile output (the pair term times v
    plus the bonus) from r, k, v and logw alone; then, for each slice of
    ``hv_tile`` state columns on its own, the tiles in order: the history
    read added to o and the state updated.  The same function as
    :func:`wkv_chunked`; its sums group differently.  Returns (o, s_final),
    f32."""
    B, S, H, hk = r.shape
    hv = v.shape[-1]
    f = lambda x: x.float().permute(0, 2, 1, 3)  # (B, H, S, d)
    rf, kf, vf, wf = f(r), f(k), f(v), f(logw)
    u = u.float()
    bounds = [(c0, min(c0 + tile, S)) for c0 in range(0, S, tile)]
    # pass 1: each tile's intra-tile output
    o = torch.empty((B, H, S, hv), dtype=torch.float32, device=r.device)
    for c0, c1 in bounds:
        rb, kb, vb = rf[:, :, c0:c1], kf[:, :, c0:c1], vf[:, :, c0:c1]
        la, la_prev = _tile_decay(wf[:, :, c0:c1])
        ci = torch.arange(c1 - c0, device=r.device)
        expo = la_prev[:, :, :, None] - la[:, :, None]  # (B, H, L_t, L_s, hk)
        pair = torch.einsum("bhck,bhsk,bhcsk->bhcs", rb, kb,
                            torch.exp(torch.clamp(expo, max=0.0)))
        pair = pair * (ci[:, None] > ci[None, :]).float()
        bonus = torch.einsum("bhck,hk,bhck->bhc", rb, u, kb)[..., None] * vb
        o[:, :, c0:c1] = torch.einsum("bhcs,bhsv->bhcv", pair, vb) + bonus
    # pass 2: the state carried through the tiles, one slice of columns at a time
    s = (torch.zeros((B, H, hk, hv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float().clone())
    for j0 in range(0, hv, hv_tile):
        j1 = min(j0 + hv_tile, hv)
        st = s[..., j0:j1]
        for c0, c1 in bounds:
            la, la_prev = _tile_decay(wf[:, :, c0:c1])
            la_end = la[:, :, -1:]
            r_dec = rf[:, :, c0:c1] * torch.exp(la_prev)
            k_dec = kf[:, :, c0:c1] * torch.exp(la_end - la)
            o[:, :, c0:c1, j0:j1] += torch.einsum("bhck,bhkv->bhcv", r_dec, st)
            st = st * torch.exp(la_end.squeeze(2))[..., None] + torch.einsum(
                "bhsk,bhsv->bhkv", k_dec, vf[:, :, c0:c1, j0:j1])
        s[..., j0:j1] = st
    return o.permute(0, 2, 1, 3).contiguous(), s
