"""Flash attention by device: the plain version on the CPU, K5 on the card.

The port's counterpart of ``repro/kernels/flash/ops.py::flash_attention``,
forward only (the custom VJP comes with the training slice, as a
``torch.autograd.Function``):

* a CPU tensor runs :func:`repro_torch.kernels.flash.ref.attention_ref`;
* a CUDA tensor launches K5 (``csrc/flash_fwd.cu``) or raises;
* any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, h), k/v (B, T, K, h) → (B, S, H, h) in ``q.dtype``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    geom = dict(causal=causal, window=window, scale=scale, softcap=softcap)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, **geom)
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(q, k, v, **geom)
    raise ValueError(f"flash_attention: no implementation for {q.device}")
