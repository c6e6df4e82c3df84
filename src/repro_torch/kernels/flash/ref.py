"""K5's plain version: GQA attention, causal / sliding-window / softcap.

The port's counterpart of ``repro/kernels/flash/ref.py::attention_ref``,
computed in f32 and cast back to ``q.dtype``.  It takes any ``S`` and
``T``.  One difference, on purpose: a query row that sees no key writes
zeros, as the TPU kernel does (``kernel.py:72-75``) and K5 does, where the
reference's oracle spreads a uniform softmax over masked keys.  Causal rows
over ``T >= S`` keys always see at least their own position, so the two
agree wherever the serving path calls them.

``q_offset`` places query row i at position ``q_offset + i`` (a data row's
span of a sequence split over the data axes): the rows ``a:b`` of the whole
sequence's attention are ``attention_ref(q[:, a:b], k[:, :b], v[:, :b],
q_offset=a)``.  K5's kernels mask by the same rule (``csrc/flash_mask.cuh``).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38


def attention_ref(
    q: torch.Tensor,  # (B, S, H, h)
    k: torch.Tensor,  # (B, T, K, h)
    v: torch.Tensor,  # (B, T, K, h)
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    B, S, H, h = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = h ** -0.5
    qg = q.reshape(B, S, K, G, h)
    s = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = visible(S, T, causal=causal, window=window, q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1) * mask.any(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, h).to(q.dtype)


def visible(S: int, T: int, *, causal: bool, window: int, q_offset: int = 0,
            device=None) -> torch.Tensor:
    """(S, T) bool: query row i (at position ``q_offset + i``) may see key
    j: causal j <= q_offset + i, with a window j > q_offset + i - window."""
    pos = q_offset + torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= pos
    if window:
        mask &= kj > pos - window
    return mask
