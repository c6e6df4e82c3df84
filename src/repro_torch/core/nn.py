"""PyTorch functional oracle for the paper's layer set.

The port's counterpart of ``repro/core/nn.py``: PyTorch-compatible
Conv2d/MaxPool2d/AvgPool2d/Linear in CHW layout, on plain tensors.  The
executors, the fused kernels' plain versions and the tests all rest on
these functions.

Semantics pinned to the reference:

* :func:`maxpool2d` pads with the dtype minimum (``-inf`` float, ``-128``
  int8), the identity of ``max``.
* :func:`avgpool2d` divides every window by the full ``kh·kw``
  (``count_include_pad=True``).
* :func:`init_params` draws Kaiming-uniform weights from a
  ``torch.Generator``; it does not reproduce the reference's JAX draws, so
  tests hand the reference's weights across through
  :mod:`repro_torch.convert` instead.

Float32 convolutions on CUDA go through cuDNN, whose TF32 default breaks
the reference's 1e-5 tolerances: callers that compare set
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

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
from repro_torch.device import resolve

Params = Dict[str, Dict[str, torch.Tensor]]


def conv2d(x: torch.Tensor, w: torch.Tensor, b, stride=1, padding=0) -> torch.Tensor:
    """x: (C,H,W) or (N,C,H,W); w: (O,I,kh,kw); b: (O,) or None."""
    return F.conv2d(x, w, b, stride=_pair(stride), padding=_pair(padding))


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b, stride=1,
                     padding=0) -> torch.Tensor:
    """x: (C,H,W) or (N,C,H,W); w: (C,1,kh,kw) [grouped OIHW]; b: (C,)."""
    return F.conv2d(x, w, b, stride=_pair(stride), padding=_pair(padding),
                    groups=w.shape[0])


def _windows(x: torch.Tensor, kernel, stride, padding, fill) -> torch.Tensor:
    """``(..., C, OH, OW, kh, kw)`` windows over ``x`` padded with ``fill``."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph), value=fill)
    return x.unfold(-2, kh, sh).unfold(-2, kw, sw)


def maxpool2d(x: torch.Tensor, kernel, stride, padding=0) -> torch.Tensor:
    """x: (C,H,W) or (N,C,H,W); padding takes the dtype minimum."""
    fill = (-math.inf if x.dtype.is_floating_point
            else torch.iinfo(x.dtype).min)
    return _windows(x, kernel, stride, padding, fill).amax(dim=(-2, -1))


def sumpool2d(x: torch.Tensor, kernel, stride, padding=0) -> torch.Tensor:
    """Window **sum** over zero padding, in ``x``'s own dtype — the shared
    reduction under :func:`avgpool2d` and the int8 accumulator-domain
    average."""
    return _windows(x, kernel, stride, padding, 0).sum(dim=(-2, -1),
                                                       dtype=x.dtype)


def avgpool2d(x: torch.Tensor, kernel, stride, padding=0) -> torch.Tensor:
    """Average pooling, ``count_include_pad=True`` (float only)."""
    kh, kw = _pair(kernel)
    return sumpool2d(x, kernel, stride, padding) / (kh * kw)


def linear(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """x: (..., in); w: (out, in) [PyTorch layout]; b: (out,) or None."""
    return F.linear(x, w, b)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "none":
        return x
    raise ValueError(f"unknown activation {name!r}")


def _conv_like(conv, p, x: torch.Tensor) -> torch.Tensor:
    if isinstance(conv, DepthwiseConv2d):
        return depthwise_conv2d(x, p["w"], p.get("b"), conv.stride, conv.padding)
    return conv2d(x, p["w"], p.get("b"), conv.stride, conv.padding)


def init_params(graph: SequentialGraph | DAGGraph, generator: torch.Generator,
                *, dtype=torch.float32, device="cuda") -> Params:
    """Kaiming-uniform init (PyTorch's fan-in default) from ``generator``,
    for a sequential or a DAG graph (keyed by layer, i.e. node, name).

    Draws on the CPU, then moves to ``device``, so one seed gives the same
    weights on every device.
    """
    dev = resolve(device)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return ((u * 2 - 1) * bound).to(dtype=dtype, device=dev)

    params: Params = {}
    for layer in graph.layers:
        name = layer.name or layer.kind
        inner = layer
        if isinstance(layer, FusedConvPool):
            inner = layer.conv
        elif isinstance(layer, FusedLinear):
            inner = layer.linear
        if isinstance(inner, Conv2d):
            kh, kw = inner.kernel_size
            bound = 1.0 / math.sqrt(inner.in_channels * kh * kw)
            shape_w = (inner.out_channels, inner.in_channels, kh, kw)
            n_out, has_b = inner.out_channels, inner.bias
        elif isinstance(inner, DepthwiseConv2d):
            kh, kw = inner.kernel_size
            bound = 1.0 / math.sqrt(kh * kw)
            shape_w = (inner.channels, 1, kh, kw)
            n_out, has_b = inner.channels, inner.bias
        elif isinstance(inner, Linear):
            bound = 1.0 / math.sqrt(inner.in_features)
            shape_w = (inner.out_features, inner.in_features)
            n_out, has_b = inner.out_features, inner.bias
        else:
            continue
        params[name] = {"w": uniform(shape_w, bound)}
        if has_b:
            params[name]["b"] = uniform((n_out,), bound)
    return params


def apply_layer(layer, p, x: torch.Tensor) -> torch.Tensor:
    """Apply one layer functionally.  ``p`` is the layer's param dict.

    Plain PyTorch throughout, on any device: the executors route
    ``FusedConvPool`` to the Hopper kernel themselves
    (`repro_torch.core.pingpong.apply_layer`).
    """
    if isinstance(layer, Input):
        return x
    if isinstance(layer, Conv2d):
        return conv2d(x, p["w"], p.get("b"), layer.stride, layer.padding)
    if isinstance(layer, DepthwiseConv2d):
        return depthwise_conv2d(x, p["w"], p.get("b"), layer.stride, layer.padding)
    if isinstance(layer, ReLU):
        return torch.relu(x)
    if isinstance(layer, MaxPool2d):
        return maxpool2d(x, layer.kernel_size, layer.stride, layer.padding)
    if isinstance(layer, AvgPool2d):
        return avgpool2d(x, layer.kernel_size, layer.stride, layer.padding)
    if isinstance(layer, Flatten):
        return x.reshape(x.shape[:-3] + (-1,)) if x.ndim > 3 else x.reshape(-1)
    if isinstance(layer, Linear):
        return linear(x, p["w"], p.get("b"))
    if isinstance(layer, FusedConvPool):
        y = _act(layer.activation, _conv_like(layer.conv, p, x))
        if layer.pool == "avg":
            return avgpool2d(y, layer.pool_kernel, layer.pool_stride)
        return maxpool2d(y, layer.pool_kernel, layer.pool_stride)
    if isinstance(layer, FusedLinear):
        return _act(layer.activation, linear(x, p["w"], p.get("b")))
    raise TypeError(f"unknown layer {layer!r}")


def forward(graph: SequentialGraph, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Functional forward pass (the oracle the arena executors are held to)."""
    for layer in graph.layers:
        name = layer.name or layer.kind
        x = apply_layer(layer, params.get(name, {}), x)
    return x


def apply_node(layer, p, xs) -> torch.Tensor:
    """Apply one layer to its input list (DAG form): joins (:class:`Add`,
    :class:`Concat`) consume every input, other layers take exactly one."""
    if isinstance(layer, Add):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    if isinstance(layer, Concat):
        return torch.cat(list(xs), dim=layer.axis)
    if len(xs) != 1:
        raise ValueError(f"{layer.name or layer.kind}: expected one input, got {len(xs)}")
    return apply_layer(layer, p, xs[0])


def forward_dag(graph: DAGGraph, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Functional DAG forward pass (the float oracle of the DAG executors)."""
    vals: Dict[str, torch.Tensor] = {}
    for node in graph.nodes:
        if isinstance(node.layer, Input):
            vals[node.name] = x
            continue
        vals[node.name] = apply_node(node.layer, params.get(node.name, {}),
                                     [vals[src] for src in node.inputs])
    return vals[graph.output]
