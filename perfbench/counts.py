"""The benchmark's frozen arithmetic: MACs an image, each kernel's least
time (its roofline bound) and the device peaks.

Nothing here imports the port.  A configuration's layers come from its
JSON file (``configs/<name>.json``, see :mod:`perfbench.netdef`).

* MACs count every kernel tap of every output, padding included, as the
  port's ``LayerSpec.macs`` does; pools, ReLUs and requantization count 0.
* A kernel's bound is the larger of its bytes (each input byte read once,
  each output byte written once, weights, int32 bias and, for the
  depthwise kernel, its f32 per-channel multipliers) over the HBM
  bandwidth and its operations (2 a MAC, only the taps the pooled outputs
  need that fall inside the input) over the int8 peak.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the dense int8 tensor rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12

# Kernel name -> the layer form it runs (see ``kernel_layers``).
K2 = "K2"  # fused dense conv + ReLU + pool, int8 (csrc/conv_pool_q8.cu)
K4 = "K4"  # depthwise conv (+ ReLU, + pool), int8 (csrc/conv_pool_dw_q8.cu)
# The part of each kernel's device name a profiler shows.
KERNEL_NAMES = {K2: "conv_pool_q8_kernel", K4: "conv_pool_dw_q8_kernel"}


def pair(v) -> Tuple[int, int]:
    return (int(v[0]), int(v[1])) if isinstance(v, (list, tuple)) else (int(v), int(v))


def conv_out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def layer_shapes(net: dict) -> List[Tuple[dict, Tuple[int, ...], Tuple[int, ...]]]:
    """``(layer, input shape, output shape)`` for each layer of ``net``,
    shapes without the batch; a pooled conv's output is after its pool."""
    shape = tuple(int(d) for d in net["input_shape"])
    out = []
    for layer in net["layers"]:
        op = layer["op"]
        if op in ("conv", "dw"):
            c, h, w = shape
            (kh, kw), (sh, sw), (ph, pw) = (pair(layer["kernel"]), pair(layer["stride"]),
                                            pair(layer["padding"]))
            cout = layer["cout"] if op == "conv" else c
            oh, ow = conv_out(h, kh, sh, ph), conv_out(w, kw, sw, pw)
            if "pool" in layer:
                pool = layer["pool"]
                (pkh, pkw), (psh, psw) = pair(pool["kernel"]), pair(pool["stride"])
                oh, ow = (oh - pkh) // psh + 1, (ow - pkw) // psw + 1
            new = (cout, oh, ow)
        elif op == "fc":
            new = (int(layer["out"]),)
        else:
            raise ValueError(f"unknown op {op!r} in layer {layer.get('name')!r}")
        out.append((layer, shape, new))
        shape = new
    return out


def layer_macs(layer: dict, in_shape) -> int:
    """MACs of one layer for one image, every tap counted (``LayerSpec.macs``)."""
    op = layer["op"]
    if op == "fc":
        return int(layer["in"]) * int(layer["out"])
    c, h, w = in_shape
    (kh, kw), (sh, sw), (ph, pw) = (pair(layer["kernel"]), pair(layer["stride"]),
                                    pair(layer["padding"]))
    oh, ow = conv_out(h, kh, sh, ph), conv_out(w, kw, sw, pw)
    if op == "dw":
        return c * kh * kw * oh * ow
    return int(layer["cout"]) * c * kh * kw * oh * ow


def macs_per_image(net: dict) -> int:
    return sum(layer_macs(layer, shp) for layer, shp, _ in layer_shapes(net))


def _taps(size: int, k: int, cs: int, pad: int, p: int, pk: int, ps: int) -> int:
    """Along one axis: the (conv position, tap) pairs that the p pooled
    positions need and that fall inside the input, not on its padding."""
    used = {q * ps + i for q in range(p) for i in range(pk)}
    return sum(0 <= o * cs - pad + d < size for o in used for d in range(k))


def bound_s(n, cin, h, w, cout, k, cs, pad, pk, ps, depthwise=False) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time of one int8 launch
    over ``n`` images.  A depthwise conv (cout = cin = C) has C·kh·kw
    weights and no sum over input channels."""
    (kh, kw), (csh, csw), (ph_, pw_) = pair(k), pair(cs), pair(pad)
    (pkh, pkw), (psh, psw) = pair(pk), pair(ps)
    oh, ow = (h + 2 * ph_ - kh) // csh + 1, (w + 2 * pw_ - kw) // csw + 1
    ph, pw = (oh - pkh) // psh + 1, (ow - pkw) // psw + 1
    red = 1 if depthwise else cin  # input channels each output sums over
    nbytes = n * cin * h * w + cout * red * kh * kw + n * cout * ph * pw
    nbytes += cout * 4 * (2 if depthwise else 1)
    macs = (n * cout * red * _taps(h, kh, csh, ph_, ph, pkh, psh)
            * _taps(w, kw, csw, pw_, pw, pkw, psw))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / PEAK_INT8_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_layers(net: dict) -> Dict[str, List[Tuple[dict, Tuple[int, ...]]]]:
    """The layers each hand-written kernel runs, with their input shapes:
    K4 every depthwise conv, K2 every dense conv with a fused pool (the
    port's ``FusedConvPool``).  Every other layer runs as plain ops."""
    out: Dict[str, list] = {K2: [], K4: []}
    for layer, shp, _ in layer_shapes(net):
        if layer["op"] == "dw":
            out[K4].append((layer, shp))
        elif layer["op"] == "conv" and "pool" in layer:
            out[K2].append((layer, shp))
    return out


def kernel_bound_s(net: dict, kernel: str, n: int) -> float:
    """Least seconds of one pass of ``kernel`` over every layer it runs,
    one launch a layer over ``n`` images."""
    total = 0.0
    for layer, (c, h, w) in kernel_layers(net)[kernel]:
        pool = layer.get("pool", {"kernel": 1, "stride": 1})
        cout = c if layer["op"] == "dw" else int(layer["cout"])
        total += bound_s(n, c, h, w, cout, layer["kernel"], layer["stride"],
                         layer["padding"], pool["kernel"], pool["stride"],
                         depthwise=layer["op"] == "dw")[0]
    return total
