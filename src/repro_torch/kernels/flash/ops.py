"""Flash attention by device: the plain version on the CPU, K5 on the card.

The port's counterpart of ``repro/kernels/flash/ops.py::flash_attention``
and its custom VJP (``ops.py:19-44``):

* a CPU tensor runs :func:`repro_torch.kernels.flash.ref.attention_ref`,
  differentiable as it is;
* a CUDA tensor runs :class:`FlashAttention`, a ``torch.autograd.Function``
  whose forward launches K5 (``csrc/flash_fwd.cu``) or raises, and whose
  backward recomputes ``attention_ref`` on the saved q, k, v and returns
  its VJP, as the reference's ``_bwd`` does (no backward kernel: the
  reference's backward is a plain VJP too);
* any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash import kernel, ref


class FlashAttention(torch.autograd.Function):
    """Attention of q (B, S, H, h), k/v (B, T, K, h); gradients for q, k, v.
    Forward K5 (``attention_ref`` on the CPU), backward the plain VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float, softcap: float,
                q_offset: int = 0):
        ctx.geom = dict(causal=causal, window=window, scale=scale, softcap=softcap,
                        q_offset=q_offset)
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cuda":
            return kernel.flash_attention_fwd(q, k, v, **ctx.geom)
        if q.device.type == "cpu":
            return ref.attention_ref(q, k, v, **ctx.geom)
        raise ValueError(f"flash_attention: no implementation for {q.device}")

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ref.attention_ref(*leaves, **ctx.geom)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q (B, S, H, h), k/v (B, T, K, h) → (B, S, H, h) in ``q.dtype``; query
    row i at position ``q_offset + i``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kernel.check_offset(q_offset, q.shape[1], k.shape[1], causal)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                 softcap=softcap, q_offset=q_offset)
    if q.device.type == "cuda":
        return FlashAttention.apply(q, k, v, bool(causal), int(window), float(scale),
                                    float(softcap), int(q_offset))
    raise ValueError(f"flash_attention: no implementation for {q.device}")
