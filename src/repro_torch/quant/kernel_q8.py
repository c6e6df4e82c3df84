"""K2 and K4: the fused int8 conv + activation + pool kernels (dense and
depthwise), their plain versions and their NCHW wrappers.

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

K4 (``_kernel_dw_q8``, ``fused_depthwise_conv_pool_q8``) is the depthwise
sibling: groups = C, one f32 requant multiplier per channel (a ``(C,)``
array; for an average pool each is divided, in numpy float32 on the host,
by ``pkh·pkw``), ``csrc/conv_pool_dw_q8.cu`` on CUDA, one output a thread
over K3's tiling (`repro_torch.kernels.conv_pool.depthwise.k3_tiling`).

The plain versions compute the convolution in float64: PyTorch has no
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
from repro_torch.core.quantize import int_conv2d, requantize, requantize_per_channel
from repro_torch.kernels.conv_pool.depthwise import k3_tiling
from repro_torch.kernels.conv_pool.kernel import LaunchCounter, conv_pool_call, k2_tiling

K2_LAUNCHES = LaunchCounter()
K4_LAUNCHES = LaunchCounter()


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
        extra_args=(ctypes.c_float(float(m)),), tiling=k2_tiling,
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
        x = x.unsqueeze(0)
        if out is not None:
            out = out.unsqueeze(0)
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
    return y.squeeze(0) if squeeze else y


# ---------------------------------------------------------------------------
# K4: depthwise (grouped) int8 — the DS-CNN / MobileNet building block
# ---------------------------------------------------------------------------


def _host(m):
    return m.detach().cpu().numpy() if isinstance(m, torch.Tensor) else m


def channel_multipliers(multiplier, channels: int, *, activation: str,
                        pool: str, pool_k) -> np.ndarray:
    """The ``(C,)`` f32 multipliers K4 applies to the pooled accumulators: a
    scalar broadcasts to every channel; for an average pool each is divided,
    in f32, by ``pkh·pkw``.

    Raises unless they are finite, and non-negative wherever K4's order (the
    ReLU and the max taken on the int32 accumulator, then one requant)
    could differ from requantizing first: with a ReLU, or a max window
    larger than one.
    """
    m = np.broadcast_to(np.asarray(_host(multiplier), np.float32).reshape(-1),
                        (channels,)).astype(np.float32)
    windowed = _pair(pool_k) != (1, 1)
    if not np.isfinite(m).all() or (
            (activation == "relu" or (pool == "max" and windowed)) and (m < 0).any()):
        raise ValueError("depthwise int8: multipliers must be finite, and "
                         "non-negative with a ReLU or a max pool")
    if pool == "avg":
        pkh, pkw = _pair(pool_k)
        m = m / np.float32(pkh * pkw)
    return m


def depthwise_conv_pool_q8_ref(x, w, b, *, multiplier, conv_stride=1, padding=0,
                               pool_k=1, pool_stride=1, activation: str = "relu",
                               pool: str = "max") -> torch.Tensor:
    """Plain K4: int8 (N, C, H, W) → int8 (N, C, PH, PW), the reference's
    ``_xla_depthwise_conv_pool_q8`` order (max: requantize per channel, then
    pool; avg: sum, then one requantize)."""
    acc = int_conv2d(x, w, conv_stride, padding, groups=w.shape[0])
    if b is not None:
        acc = acc + b.to(torch.int32)[None, :, None, None]
    if activation == "relu":
        acc = torch.clamp(acc, min=0)
    elif activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    if pool == "avg":
        s = nn.sumpool2d(acc, pool_k, pool_stride)
        pkh, pkw = _pair(pool_k)
        m = np.asarray(_host(multiplier), np.float32) / np.float32(pkh * pkw)
        return requantize_per_channel(s, m)
    if pool != "max":
        raise ValueError(f"unknown pool {pool!r}")
    return nn.maxpool2d(requantize_per_channel(acc, multiplier), pool_k, pool_stride)


def depthwise_conv_pool_q8(x, w, b, *, multiplier, ms=None, conv_stride=1,
                           padding=0, pool_k=1, pool_stride=1,
                           activation: str = "relu", pool: str = "max",
                           out=None) -> torch.Tensor:
    """K4 on the card: int8 (N, C, H, W), int8 w (C, 1, kh, kw), int32 b and
    ``(C,)`` host multipliers → int8 output.

    ``ms``, when given, is a ``(C,)`` f32 tensor on ``x``'s device holding
    the same multipliers (the executors upload it once); the kernel reads it
    for a max pool.  Otherwise, and for an average pool, the wrapper uploads
    the effective multipliers for this call.
    """
    if x.dtype != torch.int8:
        raise TypeError(f"depthwise_conv_pool_q8: int8 input, got {x.dtype}")
    if isinstance(multiplier, torch.Tensor):
        raise TypeError("depthwise_conv_pool_q8: multiplier must be host values "
                        "(numpy); pass the device copy as ms=")
    m = channel_multipliers(multiplier, w.shape[0], activation=activation,
                            pool=pool, pool_k=pool_k)
    if ms is None or pool == "avg":
        ms = torch.as_tensor(m, device=x.device)
    elif (tuple(ms.shape) != m.shape or ms.dtype != torch.float32
          or ms.device != x.device or not ms.is_contiguous()):
        raise ValueError(f"depthwise_conv_pool_q8: ms must be ({m.shape[0]},) "
                         f"float32 contiguous on {x.device}")
    return conv_pool_call(
        "conv_pool_dw_q8", "conv_pool_dw_q8", K4_LAUNCHES, x, w, b,
        conv_stride=conv_stride, padding=padding, pool_k=pool_k,
        pool_stride=pool_stride, activation=activation, pool=pool,
        out_dtype=torch.int8, bias_dtype=torch.int32, out=out, depthwise=True,
        extra_args=(ms,), tiling=k3_tiling,
    )


def fused_depthwise_conv_pool_q8(
    x: torch.Tensor,  # (C, H, W) or (N, C, H, W) int8
    w: torch.Tensor,  # (C, 1, kh, kw) int8
    b: Optional[torch.Tensor] = None,  # (C,) int32
    *,
    multiplier=1.0,  # (C,) per-channel multipliers, or one for all
    ms: Optional[torch.Tensor] = None,
    conv_stride=1,
    padding=0,
    pool_k=1,
    pool_stride=1,
    activation: str = "relu",
    pool: str = "max",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns int8 (C, PH, PW) or (N, C, PH, PW); ``out``, when given,
    receives the result (on CUDA the kernel writes it directly).  ``ms`` is
    an optional device copy of ``multiplier`` (see
    :func:`depthwise_conv_pool_q8`)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x.unsqueeze(0)
        if out is not None:
            out = out.unsqueeze(0)
    geom = dict(multiplier=multiplier, conv_stride=conv_stride,
                padding=padding, pool_k=pool_k, pool_stride=pool_stride,
                activation=activation, pool=pool)
    if x.device.type == "cpu":
        # the same checks as the kernel's wrapper, so both devices refuse
        # what K4 refuses
        channel_multipliers(multiplier, w.shape[0], activation=activation,
                            pool=pool, pool_k=pool_k)
        y = depthwise_conv_pool_q8_ref(x, w, b, **geom)
        y = y if out is None else out.copy_(y)
    elif x.device.type == "cuda":
        y = depthwise_conv_pool_q8(x, w, b, ms=ms, out=out, **geom)
    else:
        raise ValueError(f"fused_depthwise_conv_pool_q8: no implementation for {x.device}")
    return y.squeeze(0) if squeeze else y
