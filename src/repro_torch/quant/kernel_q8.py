"""K2: the fused int8 conv + activation + pool kernel, its plain version and
its NCHW wrapper.

The port's counterpart of ``repro/quant/kernel_q8.py`` (``_kernel_q8``,
``fused_conv_pool_q8``): int8 storage, int32 accumulation, the int32 bias
in accumulator scale, ReLU in the accumulator domain, a max pool or an
int32 window sum, and one requantization (`repro_torch.core.quantize.
requantize`).  For an average pool the multiplier is first divided, in f32,
by ``pkh·pkw``, as every int8 backend of the reference does.

* a CPU tensor runs :func:`conv_pool_q8_ref`, the plain version, which
  follows the reference's ``_xla_conv_pool_q8`` order (max: requantize,
  then pool; avg: sum, then one requantize);
* a CUDA tensor launches ``csrc/conv_pool_q8.cu`` or raises; the kernel
  takes the max of the accumulators and requantizes once, which is
  bit-identical for a non-negative multiplier (the note in the source says
  why);
* any other device raises.

The plain version computes the convolution in float64: PyTorch has no
integer convolution on CUDA, and float64 is exact here (every partial sum is
an integer far below 2**53; see `repro_torch.core.quantize`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core import nn
from repro_torch.core.graph import _pair
from repro_torch.core.quantize import int_conv2d, requantize
from repro_torch.kernels.conv_pool.kernel import LaunchCounter, conv_pool_call

K2_LAUNCHES = LaunchCounter()


def effective_multiplier(multiplier, pool: str, pool_k) -> np.float32:
    """The f32 multiplier K2 applies to the pooled accumulator: ``m`` for a
    max pool, ``f32(m) / f32(pkh·pkw)`` for an average pool."""
    m = np.float32(multiplier)
    if pool == "avg":
        pkh, pkw = _pair(pool_k)
        m = m / np.float32(pkh * pkw)
    return np.float32(m)


def conv_pool_q8_ref(x, w, b, *, multiplier, conv_stride=1, padding=0,
                     pool_k=2, pool_stride=2, activation: str = "relu",
                     pool: str = "max") -> torch.Tensor:
    """Plain K2: int8 (N, Cin, H, W) → int8 (N, Cout, PH, PW)."""
    acc = int_conv2d(x, w, conv_stride, padding)
    if b is not None:
        acc = acc + b.to(torch.int32)[None, :, None, None]
    if activation == "relu":
        acc = torch.clamp(acc, min=0)
    elif activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    if pool == "avg":
        s = nn.sumpool2d(acc, pool_k, pool_stride)
        return requantize(s, effective_multiplier(multiplier, pool, pool_k))
    if pool != "max":
        raise ValueError(f"unknown pool {pool!r}")
    return nn.maxpool2d(requantize(acc, multiplier), pool_k, pool_stride)


def conv_pool_q8(x, w, b, *, multiplier, conv_stride=1, padding=0, pool_k=2,
                 pool_stride=2, activation: str = "relu", pool: str = "max",
                 out=None) -> torch.Tensor:
    """K2 on the card: int8 (N,Cin,H,W), int8 w, int32 b → int8 output."""
    if x.dtype != torch.int8:
        raise TypeError(f"conv_pool_q8: int8 input, got {x.dtype}")
    m = effective_multiplier(multiplier, pool, pool_k)
    if not np.isfinite(m) or (pool == "max" and m < 0):
        raise ValueError(f"conv_pool_q8: multiplier {multiplier} must be finite, "
                         f"and non-negative for a max pool")
    return conv_pool_call(
        "conv_pool_q8", "conv_pool_q8", K2_LAUNCHES, x, w, b,
        conv_stride=conv_stride, padding=padding, pool_k=pool_k,
        pool_stride=pool_stride, activation=activation, pool=pool,
        out_dtype=torch.int8, bias_dtype=torch.int32, out=out,
        extra_args=(ctypes.c_float(float(m)),),
    )


def fused_conv_pool_q8(
    x: torch.Tensor,  # (Cin, H, W) or (N, Cin, H, W) int8
    w: torch.Tensor,  # (Cout, Cin, kh, kw) int8
    b: Optional[torch.Tensor] = None,  # (Cout,) int32
    *,
    multiplier: float = 1.0,
    conv_stride=1,
    padding=0,
    pool_k=2,
    pool_stride=2,
    activation: str = "relu",
    pool: str = "max",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns int8 (Cout, PH, PW) or (N, Cout, PH, PW); ``out``, when
    given, receives the result (on CUDA the kernel writes it directly)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
        if out is not None:
            out = out[None]
    geom = dict(multiplier=multiplier, conv_stride=conv_stride,
                padding=padding, pool_k=pool_k, pool_stride=pool_stride,
                activation=activation, pool=pool)
    if x.device.type == "cpu":
        y = conv_pool_q8_ref(x, w, b, **geom)
        y = y if out is None else out.copy_(y)
    elif x.device.type == "cuda":
        y = conv_pool_q8(x, w, b, out=out, **geom)
    else:
        raise ValueError(f"fused_conv_pool_q8: no implementation for {x.device}")
    return y[0] if squeeze else y
