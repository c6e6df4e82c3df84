"""K3: the fused depthwise conv + activation + pool kernel, its plain version
and its NCHW wrapper.

The port's counterpart of ``repro/kernels/conv_pool/depthwise.py``
(``_kernel_dw``, ``fused_depthwise_conv_pool``): one kh×kw filter per
channel (groups = C, weights ``(C, 1, kh, kw)``), bias, activation, then a
max or average pool; ``pool_k = pool_stride = 1`` is the identity, which is
how the un-pooled depthwise+ReLU steps of DS-CNN and MobileNet run through
the kernel.

* a CPU tensor runs :func:`depthwise_conv_pool_ref`, the plain version
  (f32 accumulation; bf16 is widened first, the result cast back);
* a CUDA tensor launches ``csrc/conv_pool_dw.cu`` (f32 or bf16) through the
  family's shared launch plumbing
  (`repro_torch.kernels.conv_pool.kernel.conv_pool_call`), tiled by
  :func:`k3_tiling`, or raises;
* any other device raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import nn
from repro_torch.kernels.conv_pool.kernel import (LaunchCounter, conv_pool_call,
                                                  output_hw)

K3_LAUNCHES = LaunchCounter()
# K3 (and K4, its int8 sibling) computes one output a thread, at most
# K3_MAX_THREADS a CTA, and splits channels (then pooled rows) until a call
# has one CTA per SM of an H100 (132), as long as each CTA keeps a warp of
# outputs.
K3_TARGET_CTAS = 132
K3_MAX_THREADS = 256
K3_MIN_OUTPUTS = 32


def k3_tiling(n, cin, h, w, cout, kh, kw, *, conv_stride, padding, pool_k,
              pool_stride) -> Tuple[int, int]:
    """(pooled rows, channels) per CTA of K3 and of K4, one output a thread.

    Starts from every pooled row and channel in one tile, then halves the
    channels (while more than one) or else the rows, first until a tile
    holds at most ``K3_MAX_THREADS`` outputs, then while the grid is under
    ``K3_TARGET_CTAS`` and a tile holds at least two warps
    (2 ``K3_MIN_OUTPUTS``) of outputs.  Tiles are equal (the last may be
    shorter).  A tile of one row of one channel wider than
    ``K3_MAX_THREADS`` has its threads loop over it."""
    _, _, ph, pw = output_hw(h, w, kh, kw, conv_stride=conv_stride, padding=padding,
                             pool_k=pool_k, pool_stride=pool_stride)
    n = max(n, 1)
    rows, ct = ph, cout

    def ctas():
        return n * -(-ph // rows) * -(-cout // ct)

    while (rows * ct * pw > K3_MAX_THREADS
           or (ctas() < K3_TARGET_CTAS and rows * ct * pw >= 2 * K3_MIN_OUTPUTS)):
        if ct > 1:
            ct = -(-ct // 2)
        elif rows > 1:
            rows = -(-rows // 2)
        else:
            break
    return -(-ph // -(-ph // rows)), -(-cout // -(-cout // ct))


def depthwise_conv_pool_ref(x, w, b, *, conv_stride=1, padding=0, pool_k=1,
                            pool_stride=1, activation: str = "relu",
                            pool: str = "max") -> torch.Tensor:
    """Plain K3: (N, C, H, W) → (N, C, PH, PW) in ``x.dtype``."""
    wide = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    y = nn.depthwise_conv2d(x.to(wide), w.to(wide),
                            None if b is None else b.to(wide),
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


def depthwise_conv_pool(x, w, b, *, conv_stride=1, padding=0, pool_k=1,
                        pool_stride=1, activation: str = "relu",
                        pool: str = "max", out=None) -> torch.Tensor:
    """K3 on the card: f32 or bf16 (N, C, H, W) in, (N, C, PH, PW) out in the
    input dtype, f32 accumulation."""
    if x.dtype == torch.float32:
        fn_name = "conv_pool_dw_f32"
    elif x.dtype == torch.bfloat16:
        fn_name = "conv_pool_dw_bf16"
    else:
        raise TypeError(f"depthwise_conv_pool: f32 or bf16 input, got {x.dtype}")
    return conv_pool_call(
        fn_name, "conv_pool_dw", K3_LAUNCHES, x, w, b, conv_stride=conv_stride,
        padding=padding, pool_k=pool_k, pool_stride=pool_stride,
        activation=activation, pool=pool, out_dtype=x.dtype,
        bias_dtype=x.dtype, out=out, depthwise=True, tiling=k3_tiling,
    )


def fused_depthwise_conv_pool(
    x: torch.Tensor,  # (C, H, W) or (N, C, H, W)
    w: torch.Tensor,  # (C, 1, kh, kw)
    b: Optional[torch.Tensor] = None,
    *,
    conv_stride=1,
    padding=0,
    pool_k=1,
    pool_stride=1,
    activation: str = "relu",
    pool: str = "max",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns (C, PH, PW) or (N, C, PH, PW) in ``x.dtype``; ``out``, when
    given, receives the result (on CUDA the kernel writes it directly)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x.unsqueeze(0)
        if out is not None:
            out = out.unsqueeze(0)
    geom = dict(conv_stride=conv_stride, padding=padding, pool_k=pool_k,
                pool_stride=pool_stride, activation=activation, pool=pool)
    if x.device.type == "cpu":
        y = depthwise_conv_pool_ref(x, w, b, **geom)
        y = y if out is None else out.copy_(y)
    elif x.device.type == "cuda":
        y = depthwise_conv_pool(x, w, b, out=out, **geom)
    else:
        raise ValueError(f"fused_depthwise_conv_pool: no implementation for {x.device}")
    return y.squeeze(0) if squeeze else y
