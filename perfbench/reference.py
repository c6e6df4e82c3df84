"""The plain int8 reference of the benchmark's CNN configurations.

Plain PyTorch and NumPy; imports nothing of the port.  From the f32
weights and the f32 calibration batch the benchmark hands to both sides,
:func:`derive` works out the int8 model again, by the paper's §5 scheme
(CMSIS-NN flavour):

* activations: one symmetric scale a tensor, ``max|x| / 127`` over the
  calibration batch.  A layer's scale is taken on its float output before
  its ReLU; a conv with a fused pool (the paper's conv + ReLU + pool) takes
  it after the pool.  ReLU and Flatten keep their input's scale;
* weights: ``max|w| / 127`` a tensor, a channel for a depthwise conv,
  rounded half to even and clipped to +-127; the bias in int32 at the
  accumulator's scale;
* one f32 multiplier a layer (a channel for a depthwise conv),
  ``in_scale * w_scale / out_scale``; for an average pool divided in f32 by
  the window's size.  The accumulator times the multiplier, both f32, is
  rounded half to even and saturated to [-128, 127].

The scale arithmetic keeps the dtypes the scheme states: a per-tensor
weight scale and the multiplier built from it in float64, rounded once to
f32; a per-channel weight scale, its multipliers and the bias division in
f32.  The float calibration pass uses the same PyTorch operations, in the
same order, as the float path the scales are defined on, so both sides find
the same maxima to the bit.

:func:`forward` runs the int8 model exactly: integer products and sums in
float64 (every partial sum is an integer far below 2**53), the f32
requantization as above.  :func:`control_forward` is the same model
derived and run at int4 (``bits=4``), the benchmark's control: its outputs
are mapped back onto the int8 output scale, and it has to fail the
comparison.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.counts import layer_shapes, pair


def weight_shapes(net: dict) -> Dict[str, dict]:
    """name -> {"w": shape, "b": shape, "fan_in": int} for every layer:
    conv (Cout, Cin, kh, kw), depthwise (C, 1, kh, kw), fc (out, in)."""
    out = {}
    for layer, in_shape, _ in layer_shapes(net):
        if layer["op"] == "fc":
            w = (int(layer["out"]), int(layer["in"]))
        else:
            kh, kw = pair(layer["kernel"])
            c = in_shape[0]
            w = ((c, 1) if layer["op"] == "dw" else (int(layer["cout"]), c)) + (kh, kw)
        out[layer["name"]] = {"w": w, "b": (w[0],), "fan_in": math.prod(w[1:])}
    return out


def max_abs(t: torch.Tensor) -> float:
    return float(t.detach().abs().max().to("cpu", torch.float32))


def _window_sum(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Sum over windows with no padding, over ``unfold`` views, in ``x``'s
    dtype."""
    (kh, kw), (sh, sw) = pair(kernel), pair(stride)
    return x.unfold(-2, kh, sh).unfold(-2, kw, sw).sum(dim=(-2, -1), dtype=x.dtype)


def float_layer(layer: dict, p: dict, x: torch.Tensor):
    """(the layer's float output before its ReLU, or after its fused pool;
    the value the next layer reads)."""
    op = layer["op"]
    if op == "fc":
        y = F.linear(x.reshape(x.shape[0], -1), p["w"], p["b"])
        return y, y
    groups = p["w"].shape[0] if op == "dw" else 1
    y = F.conv2d(x, p["w"], p["b"], stride=pair(layer["stride"]),
                 padding=pair(layer["padding"]), groups=groups)
    if "pool" in layer:
        if layer["pool"]["op"] != "avg":
            raise ValueError(f"{layer['name']}: only an average pool is supported")
        kh, kw = pair(layer["pool"]["kernel"])
        y = _window_sum(torch.relu(y), (kh, kw), layer["pool"]["stride"]) / (kh * kw)
        return y, y
    return y, (torch.relu(y) if layer.get("relu") else y)


@dataclasses.dataclass
class QLayer:
    layer: dict
    w_q: torch.Tensor  # int8 values, float64, on the device of the forward pass
    b_q: torch.Tensor  # int32 values, float64
    m: torch.Tensor  # f32 multiplier(s) applied to the accumulator (pool divisor folded in)
    in_scale: float
    out_scale: float


@dataclasses.dataclass
class QNet:
    net: dict
    bits: int
    input_scale: float
    layers: List[QLayer]

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def to(self, device) -> "QNet":
        return dataclasses.replace(self, layers=[dataclasses.replace(
            q, w_q=q.w_q.to(device), b_q=q.b_q.to(device), m=q.m.to(device))
            for q in self.layers])


def input_scale(calib: torch.Tensor) -> float:
    return max(max_abs(calib), 1e-8) / 127.0


def quantize_input(x: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 -> int8: ``x / f32(scale)``, rounded half to even, saturated."""
    s = torch.as_tensor(np.float32(scale), device=x.device)
    return torch.clamp(torch.round(x / s), -128, 127).to(torch.int8)


def derive(net: dict, weights: Dict[str, dict], calib: torch.Tensor,
           bits: int = 8) -> QNet:
    """The quantized model of ``net`` from f32 ``weights`` (name -> {"w",
    "b"}, CPU tensors) and the f32 calibration batch ``calib`` (CPU)."""
    qmax = float(2 ** (bits - 1) - 1)
    in_scale = max(max_abs(calib), 1e-8) / qmax
    first = in_scale
    x = calib
    layers = []
    with torch.no_grad():
        for layer in net["layers"]:
            p = weights[layer["name"]]
            pre, x = float_layer(layer, p, x)
            out_scale = max(max_abs(pre), 1e-8) / qmax
            w = p["w"].detach().cpu().numpy().astype(np.float32)
            b = p["b"].detach().cpu().numpy().astype(np.float32)
            if layer["op"] == "dw":
                flat = np.abs(w.reshape(w.shape[0], -1)).max(axis=1)
                w_scale = (np.maximum(flat, np.float32(1e-8)) / np.float32(qmax)).astype(np.float32)
                w_q = np.clip(np.round(w / w_scale.reshape(-1, 1, 1, 1)), -qmax, qmax)
                acc_scale = np.float32(in_scale) * w_scale
                b_q = np.round(b / acc_scale).astype(np.int32)
                m = (acc_scale / np.float32(out_scale)).astype(np.float32)
            else:
                w_scale = max(float(np.max(np.abs(w))), 1e-8) / qmax
                w_q = np.clip(np.round(w / np.float32(w_scale)), -qmax, qmax)
                b_q = np.round(b / np.float32(in_scale * w_scale)).astype(np.int32)
                m = np.float32(in_scale * w_scale / out_scale)
            if "pool" in layer:
                pkh, pkw = pair(layer["pool"]["kernel"])
                m = np.float32(m) / np.float32(pkh * pkw)
            layers.append(QLayer(
                layer=layer, w_q=torch.as_tensor(w_q.astype(np.float64)),
                b_q=torch.as_tensor(b_q.astype(np.float64)),
                m=torch.as_tensor(np.asarray(m, np.float32)),
                in_scale=in_scale, out_scale=out_scale))
            in_scale = out_scale
    return QNet(net=net, bits=bits, input_scale=first, layers=layers)


def _requant(acc: torch.Tensor, m: torch.Tensor, qmax: int) -> torch.Tensor:
    """Accumulator (exact integers, f64) -> quantized values (f64): f32
    product, rounded half to even, saturated to [-qmax-1, qmax]."""
    if m.ndim == 1 and acc.ndim == 4:
        m = m.view(1, -1, 1, 1)
    v = torch.round(acc.to(torch.float32) * m)
    return v.clamp_(-qmax - 1, qmax).to(torch.float64)


def _forward_values(q: QNet, x: torch.Tensor) -> torch.Tensor:
    """Quantized input values (f64) -> the last layer's quantized values."""
    for ql in q.layers:
        layer = ql.layer
        if layer["op"] == "fc":
            acc = x.reshape(x.shape[0], -1) @ ql.w_q.T + ql.b_q
            x = _requant(acc, ql.m, q.qmax)
            continue
        groups = ql.w_q.shape[0] if layer["op"] == "dw" else 1
        acc = torch.round(F.conv2d(x, ql.w_q, stride=pair(layer["stride"]),
                                   padding=pair(layer["padding"]), groups=groups))
        acc = acc + ql.b_q.view(1, -1, 1, 1)
        if "pool" in layer:
            s = _window_sum(acc.clamp_(min=0), layer["pool"]["kernel"], layer["pool"]["stride"])
            x = _requant(s, ql.m, q.qmax)
        else:
            x = _requant(acc, ql.m, q.qmax)
            if layer.get("relu"):
                x = x.clamp_(min=0)
    return x


def forward(q: QNet, x_q: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """int8 inputs (N, C, H, W) -> the int8 model's int8 outputs, computed
    exactly on ``x_q``'s device in blocks of ``block`` rows."""
    if q.bits != 8:
        raise ValueError("forward runs the int8 model; use control_forward")
    outs = [_forward_values(q, x_q[i:i + block].to(torch.float64))
            for i in range(0, x_q.shape[0], block)]
    return torch.cat(outs).to(torch.int8)


def control_forward(q4: QNet, q8: QNet, x_q: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """The control: the model at int4 (``q4 = derive(..., bits=4)``) on the
    same int8 inputs, its outputs mapped onto the int8 model's output
    scale: int8 inputs are rescaled onto the int4 input scale, rounded and
    saturated to [-8, 7]; the last int4 layer's values are rescaled by
    ``s4 / s8`` in f32, rounded and saturated to int8."""
    to4 = np.float32(q8.input_scale / q4.input_scale)
    to8 = np.float32(q4.layers[-1].out_scale / q8.layers[-1].out_scale)
    outs = []
    for i in range(0, x_q.shape[0], block):
        x = torch.round(x_q[i:i + block].to(torch.float32) * float(to4))
        y4 = _forward_values(q4, x.clamp_(-q4.qmax - 1, q4.qmax).to(torch.float64))
        outs.append(torch.round(y4.to(torch.float32) * float(to8)).clamp_(-128, 127))
    return torch.cat(outs).to(torch.int8)


def he_normal_weights(net: dict, generator: torch.Generator, device,
                      dtype=torch.float32) -> Dict[str, dict]:
    """Random weights for ``net`` in two draws on ``device``: every weight
    He-normal (``N(0, 2 / fan_in)``), every bias normal with
    ``net["weights"]["bias_std"]`` of its layer's weight deviation."""
    shapes = weight_shapes(net)
    bias_std = float(net["weights"]["bias_std"])
    n_w = sum(math.prod(s["w"]) for s in shapes.values())
    n_b = sum(math.prod(s["b"]) for s in shapes.values())
    ws = torch.randn(n_w, generator=generator, device=device, dtype=dtype)
    bs = torch.randn(n_b, generator=generator, device=device, dtype=dtype)
    std = torch.tensor([math.sqrt(2.0 / s["fan_in"]) for s in shapes.values()],
                       device=device, dtype=dtype)
    ws *= torch.repeat_interleave(std, torch.tensor(
        [math.prod(s["w"]) for s in shapes.values()], device=device))
    bs *= torch.repeat_interleave(std * bias_std, torch.tensor(
        [math.prod(s["b"]) for s in shapes.values()], device=device))
    out, iw, ib = {}, 0, 0
    for name, s in shapes.items():
        nw, nb = math.prod(s["w"]), math.prod(s["b"])
        out[name] = {"w": ws[iw:iw + nw].view(s["w"]), "b": bs[ib:ib + nb].view(s["b"])}
        iw, ib = iw + nw, ib + nb
    return out
