"""Plain PyTorch version of K1, the fused conv+act+pool kernel.

The same function as ``csrc/conv_pool.cu`` in plain tensor operations:
conv (f32 accumulation; bf16 inputs are widened first), bias, activation,
then a max or average pool over the unpadded conv map, the result cast back
to the input dtype.  It is what :func:`repro_torch.kernels.conv_pool.ops.
fused_conv_pool` runs for a CPU tensor, and what ``chip_smoke.py`` holds the
kernel against on the card.  On CUDA, f32 goes through cuDNN: set
``torch.backends.cudnn.allow_tf32 = False`` before comparing.
"""
from __future__ import annotations

import torch

from repro_torch.core import nn


def conv_pool_ref(x, w, b, *, conv_stride=1, padding=0, pool_k=2,
                  pool_stride=2, activation: str = "relu",
                  pool: str = "max") -> torch.Tensor:
    """x: (N, Cin, H, W) or (Cin, H, W); w: (Cout, Cin, kh, kw); b: (Cout,)
    or None.  Returns (N, Cout, PH, PW) (or unbatched) in ``x.dtype``."""
    wide = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    y = nn.conv2d(x.to(wide), w.to(wide), None if b is None else b.to(wide),
                  conv_stride, padding)
    if activation == "relu":
        y = torch.relu(y)
    elif activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    if pool == "avg":
        y = nn.avgpool2d(y, pool_k, pool_stride)
    elif pool == "max":
        y = nn.maxpool2d(y, pool_k, pool_stride)
    else:
        raise ValueError(f"unknown pool {pool!r}")
    return y.to(x.dtype)
