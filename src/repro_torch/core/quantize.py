"""Post-training int8 quantization (paper §5), sequential graphs.

The port's counterpart of ``repro/core/quantize.py``: symmetric per-tensor
quantization, CMSIS-NN flavour —

* weights: int8, scale = max|w| / 127;
* activations: int8, scale calibrated from a calibration batch (max |x|);
* accumulation: int32, requantized to int8 between layers.

The weight and bias arithmetic is the reference's own numpy code, so a
model quantized by either package from the same float activations gets the
same integers.  The calibration maxima come from float conv outputs whose
low bits differ across frameworks, so the tests hold bit-exactness on the
*reference's* quantized model passed across through numpy
(:func:`repro_torch.convert.quantized_from_numpy`), and this module's own
:func:`quantize` to a relative tolerance on its scales.

:func:`simulate_int8_forward` is the eager int8 oracle of the int8
executors and kernel K2.  Integer convolutions and matrix products do not
exist for CUDA tensors in PyTorch, so it computes them in float64, which is
exact here: every partial sum is an integer of magnitude at most
``taps · 128 · 127`` (``5·5·32·128·127 ≈ 1.3e7`` for the §5 net), far
below 2**53, whatever the summation order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import nn
from repro_torch.core.graph import (
    AvgPool2d,
    Conv2d,
    DepthwiseConv2d,
    Flatten,
    FusedConvPool,
    FusedLinear,
    Input,
    Linear,
    MaxPool2d,
    ReLU,
    SequentialGraph,
    _pair,
)


@dataclasses.dataclass
class QuantizedLayer:
    name: str
    w_q: np.ndarray  # int8
    b_q: np.ndarray | None  # int32 (bias in accumulator scale)
    # float (per-tensor) or (C,) float array (per-output-channel: depthwise)
    w_scale: float | np.ndarray
    in_scale: float
    out_scale: float

    @property
    def multiplier(self):
        """The layer's requantization multiplier (accumulator → int8)."""
        return requant_multiplier(self.in_scale, self.w_scale, self.out_scale)

    @property
    def per_channel(self) -> bool:
        return np.ndim(self.w_scale) > 0


@dataclasses.dataclass
class QuantizedModel:
    graph: SequentialGraph
    input_scale: float
    layers: Dict[str, QuantizedLayer]

    def param_bytes(self) -> int:
        total = 0
        for q in self.layers.values():
            total += q.w_q.size  # int8
            if q.b_q is not None:
                total += q.b_q.size * 4
        return total

    def weight_bytes(self) -> int:
        return sum(q.w_q.size for q in self.layers.values())


def _max_abs(t: torch.Tensor) -> float:
    return float(t.detach().abs().max().to("cpu", torch.float32))


def _calibrate_scales(graph: SequentialGraph, params, xs) -> Dict[str, float]:
    """Max-abs output scale for every layer, from a calibration batch."""
    scales: Dict[str, float] = {}
    x = xs
    for layer in graph.layers:
        name = layer.name or layer.kind
        x = nn.apply_layer(layer, params.get(name, {}), x)
        scales[name] = max(_max_abs(x), 1e-8) / 127.0
    return scales


def _is_depthwise(layer) -> bool:
    inner = layer.conv if isinstance(layer, FusedConvPool) else layer
    return isinstance(inner, DepthwiseConv2d)


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu")
    return np.asarray(t, np.float32)


def _quantize_layer(name: str, layer_params, in_scale: float, out_scale: float,
                    per_channel: bool = False) -> QuantizedLayer:
    """The reference's weight/bias scale math, verbatim in numpy."""
    w = _numpy(layer_params["w"])
    if per_channel:
        flat = np.abs(w.reshape(w.shape[0], -1)).max(axis=1)
        w_scale = np.maximum(flat, 1e-8) / 127.0  # (C,)
        w_q = np.clip(
            np.round(w / w_scale.reshape((-1,) + (1,) * (w.ndim - 1))), -127, 127
        ).astype(np.int8)
    else:
        w_scale = max(float(np.max(np.abs(w))), 1e-8) / 127.0
        w_q = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
    b = layer_params.get("b")
    b_q = None
    if b is not None:
        b_q = np.round(_numpy(b) / (in_scale * w_scale)).astype(np.int32)
    return QuantizedLayer(name=name, w_q=w_q, b_q=b_q, w_scale=w_scale,
                          in_scale=in_scale, out_scale=out_scale)


def quantize(graph: SequentialGraph, params, calibration_x: torch.Tensor) -> QuantizedModel:
    """Quantize a (fused) graph's parameters given a calibration batch.

    ``calibration_x``: (N, C, H, W) float batch, on the params' device.
    """
    act_scales = _calibrate_scales(graph, params, calibration_x)
    input_scale = max(_max_abs(calibration_x), 1e-8) / 127.0
    layers: Dict[str, QuantizedLayer] = {}
    in_scale = input_scale
    for layer in graph.layers:
        name = layer.name or layer.kind
        out_scale = act_scales[name]
        if name in params:
            layers[name] = _quantize_layer(
                name, params[name], in_scale, out_scale,
                per_channel=_is_depthwise(layer),
            )
        in_scale = out_scale
    return QuantizedModel(graph=graph, input_scale=input_scale, layers=layers)


# ---------------------------------------------------------------------------
# Requantization — the one definition every int8 path of the port shares
# (the executors, K2's plain version; K2 itself runs the same arithmetic in
# csrc/conv_pool_math.cuh): f32 rescale, round half to even, saturate.
# ---------------------------------------------------------------------------


def requant_multiplier(in_scale: float, w_scale: float, out_scale: float) -> float:
    """Accumulator-scale → output-scale multiplier for one layer."""
    return in_scale * w_scale / out_scale


def requantize(acc_i32: torch.Tensor, multiplier) -> torch.Tensor:
    """int32 accumulator → int8 (f32 rescale, round-half-even, saturate).

    ``multiplier`` is cast to float32 first, as the reference does;
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    m = torch.as_tensor(np.asarray(multiplier, np.float32), device=acc_i32.device)
    v = torch.round(acc_i32.to(torch.float32) * m)
    return v.clamp_(-128, 127).to(torch.int8)


def int8_avgpool(x_i8: torch.Tensor, kernel, stride, padding=0) -> torch.Tensor:
    """Int8 average pooling: int32 window sum, then one requantization with
    the ``1/(kh·kw)`` divisor as an f32 multiplier."""
    kh, kw = _pair(kernel)
    s = nn.sumpool2d(x_i8.to(torch.int32), kernel, stride, padding)
    return requantize(s, np.float32(1.0) / np.float32(kh * kw))


def quantize_input(qm: QuantizedModel, x: torch.Tensor) -> torch.Tensor:
    scale = torch.as_tensor(np.float32(qm.input_scale), device=x.device)
    return torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)


def int_conv2d(x_i8: torch.Tensor, w_i8: torch.Tensor, stride, padding,
               groups: int = 1) -> torch.Tensor:
    """Exact int8 × int8 → int32 convolution, computed in float64 (see the
    module docstring for why that is exact)."""
    acc = F.conv2d(x_i8.to(torch.float64), w_i8.to(torch.float64),
                   stride=_pair(stride), padding=_pair(padding), groups=groups)
    # A library may pick a transform-based algorithm whose float64 result
    # is off an integer by far less than 0.5: round, never truncate.
    return torch.round(acc).to(torch.int32)


def int_linear(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """Exact int8 × int8 → int32 ``x @ w.T``, computed in float64."""
    acc = x_i8.to(torch.float64) @ w_i8.to(torch.float64).T
    return torch.round(acc).to(torch.int32)


def simulate_int8_forward(qm: QuantizedModel, x_q: torch.Tensor) -> torch.Tensor:
    """Run the int8 network (int8 tensors, int32 accumulation) eagerly.

    Returns the final layer's int8 output; the oracle of the int8
    executors.  Same per-layer order as the reference: for a fused max pool,
    requantize every conv value, then take the max.
    """
    x = x_q
    for layer in qm.graph.layers:
        if isinstance(layer, Input):
            continue
        x = _simulate_int8_layer(qm, layer, layer.name or layer.kind, x)
    return x


def _simulate_int8_layer(qm: QuantizedModel, layer, name: str, x) -> torch.Tensor:
    if isinstance(layer, ReLU):
        return torch.clamp(x, min=0)
    if isinstance(layer, Flatten):
        return x.reshape(-1) if x.ndim == 3 else x.reshape(x.shape[0], -1)
    if isinstance(layer, MaxPool2d):
        return nn.maxpool2d(x, layer.kernel_size, layer.stride, layer.padding)
    if isinstance(layer, AvgPool2d):
        return int8_avgpool(x, layer.kernel_size, layer.stride, layer.padding)
    q = qm.layers[name]
    if q.per_channel:
        raise NotImplementedError(
            f"{name}: per-channel (depthwise) int8 layers come with the DAG slice")
    dev = x.device
    if isinstance(layer, (Conv2d, FusedConvPool)):
        conv = layer.conv if isinstance(layer, FusedConvPool) else layer
        if isinstance(conv, DepthwiseConv2d):
            raise NotImplementedError(f"{name}: depthwise int8 conv")
        acc = int_conv2d(x, torch.as_tensor(q.w_q, device=dev), conv.stride,
                         conv.padding)
        if q.b_q is not None:
            bias = torch.as_tensor(q.b_q, device=dev)
            acc = acc + (bias[:, None, None] if acc.ndim == 3
                         else bias[None, :, None, None])
        if isinstance(layer, FusedConvPool):
            if layer.activation == "relu":
                acc = torch.clamp(acc, min=0)
            if layer.pool == "avg":
                pkh, pkw = layer.pool_kernel
                s = nn.sumpool2d(acc, layer.pool_kernel, layer.pool_stride)
                return requantize(
                    s, np.float32(q.multiplier) / np.float32(pkh * pkw))
            y = requantize(acc, q.multiplier)
            return nn.maxpool2d(y, layer.pool_kernel, layer.pool_stride)
        return requantize(acc, q.multiplier)
    if isinstance(layer, (Linear, FusedLinear)):
        acc = int_linear(x, torch.as_tensor(q.w_q, device=dev))
        if q.b_q is not None:
            acc = acc + torch.as_tensor(q.b_q, device=dev)
        if isinstance(layer, FusedLinear) and layer.activation == "relu":
            acc = torch.clamp(acc, min=0)
        return requantize(acc, q.multiplier)
    raise TypeError(f"unsupported layer for int8 simulation: {layer!r}")
