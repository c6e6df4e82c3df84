"""Post-training int8 quantization (paper §5), sequential and DAG graphs.

The port's counterpart of ``repro/core/quantize.py``: symmetric
quantization, CMSIS-NN flavour —

* weights: int8, scale = max|w| / 127 (per output channel for depthwise
  layers);
* activations: int8, scale calibrated from a calibration batch (max |x|);
* accumulation: int32, requantized to int8 between layers.

The weight and bias arithmetic is the reference's own numpy code, so a
model quantized by either package from the same float activations gets the
same integers.  The calibration maxima come from float conv outputs whose
low bits differ across frameworks, so the tests hold bit-exactness on the
*reference's* quantized model passed across through numpy
(:func:`repro_torch.convert.quantized_from_numpy`), and this module's own
:func:`quantize` to a relative tolerance on its scales.

:func:`simulate_int8_forward` and :func:`simulate_int8_dag_forward` are
the eager int8 oracles of the int8 executors and kernels K2 and K4.  Integer convolutions and matrix products do not
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
    Add,
    AvgPool2d,
    Concat,
    Conv2d,
    DAGGraph,
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
class QuantizedJoin:
    """Join-node (Add/Concat) requantization: one int8→int8 multiplier per
    input, rescaling each input's scale onto the join's output scale."""

    name: str
    in_scales: tuple
    out_scale: float

    @property
    def multipliers(self) -> tuple:
        return tuple(s / self.out_scale for s in self.in_scales)


@dataclasses.dataclass
class QuantizedModel:
    graph: SequentialGraph | DAGGraph
    input_scale: float
    layers: Dict[str, QuantizedLayer]
    joins: Dict[str, QuantizedJoin] = dataclasses.field(default_factory=dict)

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


def quantize_dag(graph: DAGGraph, params, calibration_x: torch.Tensor) -> QuantizedModel:
    """Quantize a (fused) DAG's parameters given a calibration batch.

    Per-node symmetric scales from the float activations, one topological
    sweep, as the reference does: scale-preserving nodes (ReLU, Flatten,
    MaxPool) pass their input's scale through; conv/linear nodes get the
    accumulator-scale bias and requant multiplier; joins get one multiplier
    per input (:class:`QuantizedJoin`).
    """
    input_scale = max(_max_abs(calibration_x), 1e-8) / 127.0
    scales: Dict[str, float] = {}
    vals: Dict[str, torch.Tensor] = {}
    layers: Dict[str, QuantizedLayer] = {}
    joins: Dict[str, QuantizedJoin] = {}
    for node in graph.nodes:
        name = node.name
        if isinstance(node.layer, Input):
            vals[name] = calibration_x
            scales[name] = input_scale
            continue
        val = nn.apply_node(node.layer, params.get(name, {}),
                            [vals[src] for src in node.inputs])
        vals[name] = val
        if isinstance(node.layer, (Add, Concat)):
            out_scale = max(_max_abs(val), 1e-8) / 127.0
            joins[name] = QuantizedJoin(
                name=name, in_scales=tuple(scales[src] for src in node.inputs),
                out_scale=out_scale)
            scales[name] = out_scale
            continue
        if name not in params:
            scales[name] = scales[node.inputs[0]]  # scale-preserving node
            continue
        out_scale = max(_max_abs(val), 1e-8) / 127.0
        layers[name] = _quantize_layer(
            name, params[name], scales[node.inputs[0]], out_scale,
            per_channel=_is_depthwise(node.layer))
        scales[name] = out_scale
    return QuantizedModel(graph=graph, input_scale=input_scale, layers=layers,
                          joins=joins)


# ---------------------------------------------------------------------------
# Requantization — the one definition every int8 path of the port shares
# (the executors, the plain versions of K2 and K4; the kernels run the same
# arithmetic in csrc/conv_pool_math.cuh): f32 rescale, round half to even, saturate.
# ---------------------------------------------------------------------------


def requant_multiplier(in_scale: float, w_scale: float, out_scale: float) -> float:
    """Accumulator-scale → output-scale multiplier for one layer."""
    return in_scale * w_scale / out_scale


def _f32(multiplier, device):
    """The multiplier in f32: a tensor on ``device``, or, for one value, a
    Python float holding the f32 value, which an f32 tensor op takes as an
    f32 operand with no copy to the card (a copy from pageable host memory
    would wait for the card's queue to drain)."""
    if isinstance(multiplier, torch.Tensor):
        return multiplier.to(device=device, dtype=torch.float32)
    m = np.asarray(multiplier, np.float32)
    return float(m) if m.ndim == 0 else torch.as_tensor(m, device=device)


def requantize(acc_i32: torch.Tensor, multiplier) -> torch.Tensor:
    """int32 accumulator → int8 (f32 rescale, round-half-even, saturate).

    ``multiplier`` is cast to float32 first, as the reference does;
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    m = _f32(multiplier, acc_i32.device)
    v = torch.round(acc_i32.to(torch.float32) * m)
    return v.clamp_(-128, 127).to(torch.int8)


# The same math as C, for the emitted int8 engines (`repro_torch.core.
# export_c`): nearbyintf rounds half to even under the default FE_TONEAREST
# mode, as torch.round in :func:`requantize` does.
REQUANT_C = """
static int8_t rq(int32_t acc, float m) {
  float v = nearbyintf((float)acc * m);
  if (v > 127.0f) return 127;
  if (v < -128.0f) return -128;
  return (int8_t)v;
}"""


def requantize_per_channel(acc_i32: torch.Tensor, multipliers) -> torch.Tensor:
    """Per-output-channel requantization (depthwise convs): ``acc_i32`` is
    ``(..., C, H, W)``, ``multipliers`` ``(C,)``, broadcast over the spatial
    dims through the same :func:`requantize` math."""
    return requantize(acc_i32, _f32(multipliers, acc_i32.device).reshape(-1, 1, 1))


def requantize_join(xs_i8, multipliers) -> torch.Tensor:
    """Int8 Add: requantize each input onto the output scale, sum in int32,
    saturate to [-128, 127]."""
    acc = None
    for x, m in zip(xs_i8, multipliers):
        r = requantize(x.to(torch.int32), m).to(torch.int32)
        acc = r if acc is None else acc + r
    return acc.clamp_(-128, 127).to(torch.int8)


def requantize_concat(xs_i8, multipliers, axis: int) -> torch.Tensor:
    """Int8 Concat: each input segment requantized onto the join scale."""
    parts = [requantize(x.to(torch.int32), m) for x, m in zip(xs_i8, multipliers)]
    return torch.cat(parts, dim=axis)


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
        x = _simulate_int8_node(qm, layer, layer.name or layer.kind, [x])
    return x


def simulate_int8_dag_forward(qm: QuantizedModel, x_q: torch.Tensor) -> torch.Tensor:
    """Run the int8 DAG (int8 tensors, int32 accumulation) eagerly: the
    oracle of the int8 DAG executors."""
    g = qm.graph
    if not isinstance(g, DAGGraph):
        raise TypeError("simulate_int8_dag_forward expects a DAG-quantized model")
    vals: Dict[str, torch.Tensor] = {}
    for node in g.nodes:
        if isinstance(node.layer, Input):
            vals[node.name] = x_q
            continue
        vals[node.name] = _simulate_int8_node(
            qm, node.layer, node.name, [vals[src] for src in node.inputs])
    return vals[g.output]


def _requant_conv(acc: torch.Tensor, q: QuantizedLayer, m=None) -> torch.Tensor:
    """Requantize with the layer's scalar or per-channel multiplier."""
    m = q.multiplier if m is None else m
    return requantize_per_channel(acc, m) if q.per_channel else requantize(acc, m)


def _simulate_int8_node(qm: QuantizedModel, layer, name: str, xs) -> torch.Tensor:
    """One node of the int8 simulation (int8 tensors, int32 accumulation)."""
    x = xs[0]
    if isinstance(layer, ReLU):
        return torch.clamp(x, min=0)
    if isinstance(layer, Flatten):
        return x.reshape(-1) if x.ndim == 3 else x.reshape(x.shape[0], -1)
    if isinstance(layer, MaxPool2d):
        return nn.maxpool2d(x, layer.kernel_size, layer.stride, layer.padding)
    if isinstance(layer, AvgPool2d):
        return int8_avgpool(x, layer.kernel_size, layer.stride, layer.padding)
    if isinstance(layer, (Add, Concat)):
        j = qm.joins[name]
        if isinstance(layer, Add):
            return requantize_join(xs, j.multipliers)
        return requantize_concat(xs, j.multipliers, axis=layer.axis)
    q = qm.layers[name]
    dev = x.device
    if isinstance(layer, (Conv2d, DepthwiseConv2d, FusedConvPool)):
        conv = layer.conv if isinstance(layer, FusedConvPool) else layer
        groups = conv.channels if isinstance(conv, DepthwiseConv2d) else 1
        acc = int_conv2d(x, torch.as_tensor(q.w_q, device=dev), conv.stride,
                         conv.padding, groups=groups)
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
                m = np.asarray(q.multiplier, np.float32) / np.float32(pkh * pkw)
                return _requant_conv(s, q, m)
            y = _requant_conv(acc, q)
            return nn.maxpool2d(y, layer.pool_kernel, layer.pool_stride)
        return _requant_conv(acc, q)
    if isinstance(layer, (Linear, FusedLinear)):
        acc = int_linear(x, torch.as_tensor(q.w_q, device=dev))
        if q.b_q is not None:
            acc = acc + torch.as_tensor(q.b_q, device=dev)
        if isinstance(layer, FusedLinear) and layer.activation == "relu":
            acc = torch.clamp(acc, min=0)
        return requantize(acc, q.multiplier)
    raise TypeError(f"unsupported layer for int8 simulation: {layer!r}")
