"""C code generation — the paper's actual deliverable (§1, §4).

    "The final purpose is to develop a tool consuming PyTorch model with
     trained network weights, and it turns into an optimized inference
     engine (forward pass) in C/C++ for low memory (kilobyte level)
     microcontrollers."

The port's counterpart of ``repro/core/export_c.py``: the tool consumes a
PyTorch model — a port graph (`repro_torch.core.graph`) with its params,
torch tensors on any device (moved to host numpy here) or numpy arrays, or
a `repro_torch.core.quantize.QuantizedModel` — and its memory plan, and
emits a self-contained C translation unit:

  * weights as ``static const`` arrays → the compiler places them in
    ``.text``/``.rodata`` (flash), paper §3.3;
  * one static arena sized exactly by the memory plan → ``.bss`` (SRAM);
  * the fused conv+activation+maxpool loop nest is a faithful rendering of
    the paper's Algorithm 1 (running max, no conv output buffer);
  * optional ``main()`` harness (stdin → forward → stdout) that the tests
    and ``chip_smoke.py`` use to hold the C engine against the port.

Float (LeNet-5 path, paper §3/§4) and int8 (CIFAR test-net path, paper §5)
backends, each for a sequential graph and its ping-pong plan
(:func:`generate_c`, :func:`generate_c_int8`) and for a DAG and its
reordered plan (:func:`generate_c_dag`, :func:`generate_c_int8_dag`).  The
text is byte for byte the reference emitter's for the same graph, plan and
weights.
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import schedule as schedule_mod
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
)
from repro_torch.core.planner import MemoryPlan
from repro_torch.core.quantize import REQUANT_C, QuantizedModel


def _ident(name: str) -> str:
    return re.sub(r"[^0-9a-zA-Z_]", "_", name)


def _host_f32(v) -> np.ndarray:
    """A weight as host float32 numpy: torch tensors (any device) are moved
    to the host first."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def _fmt_float(v: float) -> str:
    """A valid C float literal (``%.9g`` alone renders 1.0 as ``1``, and
    ``1f`` is not C)."""
    s = f"{float(v):.9g}"
    if not any(c in s for c in ".einf"):
        s += ".0"
    return s + "f"


def _fmt_array(vals: np.ndarray, ctype: str, name: str) -> str:
    flat = vals.reshape(-1)
    if ctype == "float":
        body = ",".join(f"{float(v):.9g}f" for v in flat)
    else:
        body = ",".join(str(int(v)) for v in flat)
    return f"static const {ctype} {name}[{flat.size}] = {{{body}}};"


class _Emitter:
    def __init__(self) -> None:
        self.decls: List[str] = []
        self.body: List[str] = []

    def decl(self, s: str) -> None:
        self.decls.append(s)

    def emit(self, s: str) -> None:
        self.body.append(s)


def _decl_requant(e: _Emitter, tag: str, q, div: int = 1) -> str:
    """Declare a layer's requant multiplier(s); return the requant template.

    Per-tensor layers get one scalar ``M_tag``; per-channel (depthwise)
    layers get a ``float M_tag[C]`` table indexed by the conv loops'
    output-channel variable ``c``.

    ``div`` > 1 (fused average pooling) pre-divides the constant by the
    pool-window size in f32 — the int32 window *sum* then takes one
    ``rq(sum, m/div)``, applying conv rescale and the pool divisor in a
    single rounding, bit-identical to ``quantize._simulate_int8_node`` and
    ``quant.exec`` (f32/f32 division is correctly rounded everywhere).
    """
    m = np.asarray(q.multiplier, np.float32)
    if div != 1:
        m = m / np.float32(div)
    if m.ndim:
        vals = ",".join(_fmt_float(v) for v in m.reshape(-1))
        e.decl(f"static const float M_{tag}[{m.size}] = {{{vals}}};")
        return "rq({acc}, M_{tag}[c])"
    e.decl(f"static const float M_{tag} = {_fmt_float(m)};")
    return "rq({acc}, M_{tag})"


def _conv_pool_loops(
    e: _Emitter,
    tag: str,
    *,
    ctype: str,
    acc_type: str,
    ic: int,
    ih: int,
    iw: int,
    oc: int,
    k,
    cs,
    pad,
    ph: int,
    pw: int,
    pk,
    ps,
    in_off: int,
    out_off: int,
    has_bias: bool,
    activation: str,
    requant: Optional[str],
    pool: str = "max",
    depthwise: bool = False,
) -> None:
    """Emit the paper's Algorithm 1: fused conv + activation + pool.

    Geometry arguments ``k``/``cs``/``pad``/``pk``/``ps`` are per-axis
    ``(h, w)`` pairs.  ``pool="max"`` keeps the paper's running max;
    ``pool="avg"`` accumulates the window *sum* in the accumulator domain
    and applies the divisor once at writeback — float divides by the window
    size, int8 folds it into the (pre-divided) requant multiplier, matching
    the simulator's canonical fused-avg order.

    ``depthwise=True`` drops the input-channel contraction: output channel
    ``c`` reads only input channel ``c`` with its own kh×kw filter (weights
    flat ``(C, kh, kw)`` — the grouped OIHW layout with the singleton
    squeezed by flattening).
    """
    (kh, kw), (csh, csw), (padh, padw) = k, cs, pad
    (pkh, pkw), (psh, psw) = pk, ps
    zero = "0" if acc_type.startswith("int") else "0.0f"
    neg_inf = "-3.4e38f" if ctype == "float" else "-128"
    if pool == "avg":
        init = zero  # window sum accumulator
    else:
        init = zero if activation == "relu" else neg_inf  # Alg.1 inits max to 0 (ReLU)
    kind = "dwconv" if depthwise else "conv"
    e.emit(
        f"  /* {tag}: fused {kind}{kh}x{kw}/s{csh}x{csw}/p{padh}x{padw}"
        f" + {activation} + {pool}pool{pkh}x{pkw}/s{psh}x{psw} (Alg. 1) */"
    )
    e.emit(f"  {{ const {ctype}* in = arena + {in_off}; {ctype}* out = arena + {out_off};")
    e.emit(f"    for (int c = 0; c < {oc}; ++c)")
    e.emit(f"      for (int y = 0; y < {ph}; ++y)")
    e.emit(f"        for (int x = 0; x < {pw}; ++x) {{")
    e.emit(f"          {acc_type} mx = {init};")
    e.emit(f"          for (int i = 0; i < {pkh}; ++i)")
    e.emit(f"            for (int j = 0; j < {pkw}; ++j) {{")
    e.emit(f"              const int oy = y*{psh} + i, ox = x*{psw} + j;")
    bias = f"B_{tag}[c]" if has_bias else zero
    e.emit(f"              {acc_type} sum = {bias};")
    if depthwise:
        e.emit(f"              for (int t = 0; t < {kh}; ++t)")
        e.emit(f"                for (int u = 0; u < {kw}; ++u) {{")
        e.emit(f"                  const int iy = oy*{csh} - {padh} + t, ix = ox*{csw} - {padw} + u;")
        e.emit(f"                  if (iy >= 0 && iy < {ih} && ix >= 0 && ix < {iw})")
        e.emit(
            f"                    sum += ({acc_type})in[(c*{ih} + iy)*{iw} + ix] * "
            f"({acc_type})W_{tag}[(c*{kh} + t)*{kw} + u];"
        )
        e.emit(f"                }}")
    else:
        e.emit(f"              for (int z = 0; z < {ic}; ++z)")
        e.emit(f"                for (int t = 0; t < {kh}; ++t)")
        e.emit(f"                  for (int u = 0; u < {kw}; ++u) {{")
        e.emit(f"                    const int iy = oy*{csh} - {padh} + t, ix = ox*{csw} - {padw} + u;")
        e.emit(f"                    if (iy >= 0 && iy < {ih} && ix >= 0 && ix < {iw})")
        e.emit(
            f"                      sum += ({acc_type})in[(z*{ih} + iy)*{iw} + ix] * "
            f"({acc_type})W_{tag}[((c*{ic} + z)*{kh} + t)*{kw} + u];"
        )
        e.emit(f"                  }}")
    if activation == "relu":
        e.emit(f"              if (sum < {zero}) sum = {zero};")
    if pool == "avg":
        e.emit(f"              mx += sum;")
    else:
        e.emit(f"              if (sum > mx) mx = sum;")
    e.emit(f"            }}")
    if requant is not None:
        # int8 avg: the requant multiplier was declared pre-divided (div=pk·pk)
        out = requant.format(acc="mx", tag=tag)
    elif pool == "avg":
        out = f"mx / {_fmt_float(pkh * pkw)}"
    else:
        out = "mx"
    e.emit(f"          out[(c*{ph} + y)*{pw} + x] = {out};")
    e.emit(f"        }}")
    e.emit(f"  }}")


def _conv_loops(e, tag, *, ctype, acc_type, ic, ih, iw, oc, oh, ow, k, cs, pad,
                in_off, out_off, has_bias, requant, depthwise=False):
    (kh, kw), (csh, csw), (padh, padw) = k, cs, pad
    zero = "0" if acc_type.startswith("int") else "0.0f"
    kind = "dwconv" if depthwise else "conv"
    e.emit(f"  /* {tag}: {kind}{kh}x{kw}/s{csh}x{csw}/p{padh}x{padw} */")
    e.emit(f"  {{ const {ctype}* in = arena + {in_off}; {ctype}* out = arena + {out_off};")
    e.emit(f"    for (int c = 0; c < {oc}; ++c)")
    e.emit(f"      for (int oy = 0; oy < {oh}; ++oy)")
    e.emit(f"        for (int ox = 0; ox < {ow}; ++ox) {{")
    bias = f"B_{tag}[c]" if has_bias else zero
    e.emit(f"          {acc_type} sum = {bias};")
    if depthwise:
        e.emit(f"          for (int t = 0; t < {kh}; ++t)")
        e.emit(f"            for (int u = 0; u < {kw}; ++u) {{")
        e.emit(f"              const int iy = oy*{csh} - {padh} + t, ix = ox*{csw} - {padw} + u;")
        e.emit(f"              if (iy >= 0 && iy < {ih} && ix >= 0 && ix < {iw})")
        e.emit(
            f"                sum += ({acc_type})in[(c*{ih} + iy)*{iw} + ix] * "
            f"({acc_type})W_{tag}[(c*{kh} + t)*{kw} + u];"
        )
        e.emit(f"            }}")
    else:
        e.emit(f"          for (int z = 0; z < {ic}; ++z)")
        e.emit(f"            for (int t = 0; t < {kh}; ++t)")
        e.emit(f"              for (int u = 0; u < {kw}; ++u) {{")
        e.emit(f"                const int iy = oy*{csh} - {padh} + t, ix = ox*{csw} - {padw} + u;")
        e.emit(f"                if (iy >= 0 && iy < {ih} && ix >= 0 && ix < {iw})")
        e.emit(
            f"                  sum += ({acc_type})in[(z*{ih} + iy)*{iw} + ix] * "
            f"({acc_type})W_{tag}[((c*{ic} + z)*{kh} + t)*{kw} + u];"
        )
        e.emit(f"              }}")
    out = "sum" if requant is None else requant.format(acc="sum", tag=tag)
    e.emit(f"          out[(c*{oh} + oy)*{ow} + ox] = {out};")
    e.emit(f"        }}")
    e.emit(f"  }}")


def _linear_loops(e, tag, *, ctype, acc_type, n_in, n_out, in_off, out_off,
                  has_bias, relu, requant):
    zero = "0" if acc_type.startswith("int") else "0.0f"
    e.emit(f"  /* {tag}: linear {n_in} -> {n_out}{' + relu' if relu else ''} */")
    e.emit(f"  {{ const {ctype}* in = arena + {in_off}; {ctype}* out = arena + {out_off};")
    e.emit(f"    for (int o = 0; o < {n_out}; ++o) {{")
    bias = f"B_{tag}[o]" if has_bias else zero
    e.emit(f"      {acc_type} sum = {bias};")
    e.emit(f"      for (int i = 0; i < {n_in}; ++i) sum += ({acc_type})in[i] * ({acc_type})W_{tag}[o*{n_in} + i];")
    if relu:
        e.emit(f"      if (sum < {zero}) sum = {zero};")
    out = "sum" if requant is None else requant.format(acc="sum", tag=tag)
    e.emit(f"      out[o] = {out};")
    e.emit(f"    }}")
    e.emit(f"  }}")


def _maxpool_loops(e, tag, *, ctype, c, ih, iw, oh, ow, pk, ps, pad, in_off, out_off):
    """Max-pool step (per-axis ``pk``/``ps``/``pad`` pairs).  Padded taps
    outside the input are skipped against a dtype-minimum running max —
    identical to the oracle's dtype-min padding (``nn.maxpool2d``); every
    window intersects the input when ``pad < pk``, which
    :meth:`MaxPool2d.out_shape` guarantees."""
    (pkh, pkw), (psh, psw), (padh, padw) = pk, ps, pad
    neg = "-3.4e38f" if ctype == "float" else "-128"
    e.emit(f"  /* {tag}: maxpool{pkh}x{pkw}/s{psh}x{psw}/p{padh}x{padw} */")
    e.emit(f"  {{ const {ctype}* in = arena + {in_off}; {ctype}* out = arena + {out_off};")
    e.emit(f"    for (int z = 0; z < {c}; ++z)")
    e.emit(f"      for (int y = 0; y < {oh}; ++y)")
    e.emit(f"        for (int x = 0; x < {ow}; ++x) {{")
    e.emit(f"          {ctype} mx = {neg};")
    e.emit(f"          for (int i = 0; i < {pkh}; ++i)")
    e.emit(f"            for (int j = 0; j < {pkw}; ++j) {{")
    if padh or padw:
        e.emit(f"              const int iy = y*{psh} - {padh} + i, ix = x*{psw} - {padw} + j;")
        e.emit(f"              if (iy < 0 || iy >= {ih} || ix < 0 || ix >= {iw}) continue;")
        e.emit(f"              const {ctype} v = in[(z*{ih} + iy)*{iw} + ix];")
    else:
        # unpadded: every tap is in bounds — keep the branch-free hot loop
        e.emit(f"              const {ctype} v = in[(z*{ih} + y*{psh}+i)*{iw} + x*{psw}+j];")
    e.emit(f"              if (v > mx) mx = v;")
    e.emit(f"            }}")
    e.emit(f"          out[(z*{oh} + y)*{ow} + x] = mx;")
    e.emit(f"        }}")
    e.emit(f"  }}")


def _avgpool_loops(e, tag, *, ctype, acc_type, c, ih, iw, oh, ow, pk, ps, pad,
                   in_off, out_off):
    """Average-pool step (per-axis pairs), count-include-pad semantics.

    Zero padding means out-of-bounds taps contribute nothing to the window
    sum while the divisor stays the *full* ``pkh·pkw`` — the PyTorch
    ``AvgPool2d`` default the oracle (``nn.avgpool2d``) pins.  Float divides
    the f32 sum; int8 sums in int32 and requantizes once with
    ``M = f32(1)/f32(pkh·pkw)``, mirroring ``quantize.int8_avgpool``
    bit-for-bit.
    """
    (pkh, pkw), (psh, psw), (padh, padw) = pk, ps, pad
    div = pkh * pkw
    int8 = ctype != "float"
    if int8:
        m = np.float32(1.0) / np.float32(div)
        e.decl(f"static const float M_{tag} = {_fmt_float(m)};")
    zero = "0" if int8 else "0.0f"
    e.emit(f"  /* {tag}: avgpool{pkh}x{pkw}/s{psh}x{psw}/p{padh}x{padw} */")
    e.emit(f"  {{ const {ctype}* in = arena + {in_off}; {ctype}* out = arena + {out_off};")
    e.emit(f"    for (int z = 0; z < {c}; ++z)")
    e.emit(f"      for (int y = 0; y < {oh}; ++y)")
    e.emit(f"        for (int x = 0; x < {ow}; ++x) {{")
    e.emit(f"          {acc_type} s = {zero};")
    e.emit(f"          for (int i = 0; i < {pkh}; ++i)")
    e.emit(f"            for (int j = 0; j < {pkw}; ++j) {{")
    if padh or padw:
        e.emit(f"              const int iy = y*{psh} - {padh} + i, ix = x*{psw} - {padw} + j;")
        e.emit(f"              if (iy < 0 || iy >= {ih} || ix < 0 || ix >= {iw}) continue;")
        e.emit(f"              s += ({acc_type})in[(z*{ih} + iy)*{iw} + ix];")
    else:
        # unpadded: every tap is in bounds — keep the branch-free hot loop
        e.emit(f"              s += ({acc_type})in[(z*{ih} + y*{psh}+i)*{iw} + x*{psw}+j];")
    e.emit(f"            }}")
    out = f"rq(s, M_{tag})" if int8 else f"s / {_fmt_float(div)}"
    e.emit(f"          out[(z*{oh} + y)*{ow} + x] = {out};")
    e.emit(f"        }}")
    e.emit(f"  }}")


def _relu_inplace(e, tag, *, ctype, n, off):
    zero = "0" if ctype != "float" else "0.0f"
    e.emit(f"  /* {tag}: relu in-place */")
    e.emit(f"  {{ {ctype}* b = arena + {off};")
    e.emit(f"    for (int i = 0; i < {n}; ++i) if (b[i] < {zero}) b[i] = {zero};")
    e.emit(f"  }}")


def _copy_loops(e, tag, *, ctype, n, in_off, out_off, relu):
    """Materialized view step (ReLU/Flatten whose producer has other
    consumers): a plain copy, optionally with the activation applied."""
    zero = "0" if ctype != "float" else "0.0f"
    expr = f"in[i] < {zero} ? {zero} : in[i]" if relu else "in[i]"
    e.emit(f"  /* {tag}: {'relu copy' if relu else 'copy'} */")
    e.emit(f"  {{ const {ctype}* in = arena + {in_off}; {ctype}* out = arena + {out_off};")
    e.emit(f"    for (int i = 0; i < {n}; ++i) out[i] = {expr};")
    e.emit(f"  }}")


def _add_loops(e, tag, *, ctype, acc_type, n, in_offs, out_off, join_ms):
    """Elementwise Add join.  Int8 (``join_ms`` set): each input requantized
    onto the join scale, summed in int32, saturated — mirroring
    ``quantize.requantize_join`` bit-for-bit."""
    e.emit(f"  /* {tag}: add ({len(in_offs)} inputs) */")
    ins = "; ".join(
        f"const {ctype}* in{i} = arena + {off}" for i, off in enumerate(in_offs)
    )
    e.emit(f"  {{ {ins}; {ctype}* out = arena + {out_off};")
    e.emit(f"    for (int i = 0; i < {n}; ++i) {{")
    if join_ms is None:
        expr = " + ".join(f"in{i}[i]" for i in range(len(in_offs)))
        e.emit(f"      out[i] = {expr};")
    else:
        expr = " + ".join(
            f"(int32_t)rq(in{i}[i], M_{tag}_{i})" for i in range(len(in_offs))
        )
        e.emit(f"      {acc_type} s = {expr};")
        e.emit(f"      out[i] = (int8_t)(s > 127 ? 127 : (s < -128 ? -128 : s));")
    e.emit(f"    }}")
    e.emit(f"  }}")


def _concat_loops(e, tag, *, ctype, seg_sizes, in_offs, out_off, join_ms):
    """Leading-axis Concat join: one contiguous copy per input segment,
    requantized onto the join scale in the int8 backend."""
    e.emit(f"  /* {tag}: concat ({len(in_offs)} inputs) */")
    e.emit(f"  {{ {ctype}* out = arena + {out_off};")
    base = 0
    for i, (off, n) in enumerate(zip(in_offs, seg_sizes)):
        expr = f"in{i}[i]" if join_ms is None else f"rq(in{i}[i], M_{tag}_{i})"
        e.emit(f"    {{ const {ctype}* in{i} = arena + {off};")
        e.emit(f"      for (int i = 0; i < {n}; ++i) out[{base} + i] = {expr}; }}")
        base += n
    e.emit(f"  }}")


def _emit_op(e: _Emitter, layer, name: str, in_shapes, in_offs, out_off, *,
             ctype: str, acc_type: str, weights: dict, requants: Optional[dict],
             join_ms: Optional[dict]) -> None:
    """Emit one operator that writes a buffer of its own, reading the
    buffers at ``in_offs`` (input shapes ``in_shapes``) and writing the one
    at ``out_off``: every layer kind but the views, which the walkers place
    themselves."""
    tag = _ident(name)
    in_shape = in_shapes[0]
    rq = requants.get(name) if requants is not None else None
    if isinstance(layer, FusedConvPool):
        conv = layer.conv
        ic, ih, iw = in_shape
        oc, _, _ = conv.out_shape(in_shape)
        _, ph, pw = layer.out_shape(in_shape)
        _conv_pool_loops(
            e, tag, ctype=ctype, acc_type=acc_type, ic=ic, ih=ih, iw=iw,
            oc=oc, k=conv.kernel_size, cs=conv.stride, pad=conv.padding,
            ph=ph, pw=pw, pk=layer.pool_kernel, ps=layer.pool_stride,
            in_off=in_offs[0], out_off=out_off,
            has_bias="b" in weights[name], activation=layer.activation,
            requant=rq, pool=layer.pool,
            depthwise=isinstance(conv, DepthwiseConv2d),
        )
    elif isinstance(layer, (Conv2d, DepthwiseConv2d)):
        ic, ih, iw = in_shape
        oc, oh, ow = layer.out_shape(in_shape)
        _conv_loops(
            e, tag, ctype=ctype, acc_type=acc_type, ic=ic, ih=ih, iw=iw,
            oc=oc, oh=oh, ow=ow, k=layer.kernel_size, cs=layer.stride,
            pad=layer.padding, in_off=in_offs[0], out_off=out_off,
            has_bias="b" in weights[name], requant=rq,
            depthwise=isinstance(layer, DepthwiseConv2d),
        )
    elif isinstance(layer, MaxPool2d):
        c, ih, iw = in_shape
        _, oh, ow = layer.out_shape(in_shape)
        _maxpool_loops(
            e, tag, ctype=ctype, c=c, ih=ih, iw=iw, oh=oh, ow=ow,
            pk=layer.kernel_size, ps=layer.stride, pad=layer.padding,
            in_off=in_offs[0], out_off=out_off,
        )
    elif isinstance(layer, AvgPool2d):
        c, ih, iw = in_shape
        _, oh, ow = layer.out_shape(in_shape)
        _avgpool_loops(
            e, tag, ctype=ctype, acc_type=acc_type, c=c, ih=ih, iw=iw,
            oh=oh, ow=ow, pk=layer.kernel_size, ps=layer.stride,
            pad=layer.padding, in_off=in_offs[0], out_off=out_off,
        )
    elif isinstance(layer, (Linear, FusedLinear)):
        lin = layer.linear if isinstance(layer, FusedLinear) else layer
        _linear_loops(
            e, tag, ctype=ctype, acc_type=acc_type, n_in=lin.in_features,
            n_out=lin.out_features, in_off=in_offs[0], out_off=out_off,
            has_bias="b" in weights[name],
            relu=isinstance(layer, FusedLinear) and layer.activation == "relu",
            requant=rq,
        )
    elif isinstance(layer, Add):
        _add_loops(
            e, tag, ctype=ctype, acc_type=acc_type, n=int(np.prod(in_shape)),
            in_offs=in_offs, out_off=out_off,
            join_ms=join_ms.get(name) if join_ms is not None else None,
        )
    elif isinstance(layer, Concat):
        ax = len(in_shape) + layer.axis
        if ax != 0:
            raise ValueError(
                f"{name}: C emitter requires leading-axis concat, got axis "
                f"{layer.axis} over {in_shape}"
            )
        _concat_loops(
            e, tag, ctype=ctype, seg_sizes=[int(np.prod(s)) for s in in_shapes],
            in_offs=in_offs, out_off=out_off,
            join_ms=join_ms.get(name) if join_ms is not None else None,
        )
    else:
        raise TypeError(f"cannot emit C for layer {layer!r}")


def _walk_and_emit(
    graph: SequentialGraph,
    plan: MemoryPlan,
    e: _Emitter,
    *,
    ctype: str,
    acc_type: str,
    weights: dict,
    requants: Optional[dict],
) -> int:
    """Emit the full layer chain.  Returns output element count."""
    shapes = graph.shapes()
    cur_shape: tuple = ()
    buf_idx = 0
    for layer, out_shape in zip(graph.layers, shapes):
        name = layer.name or layer.kind
        if isinstance(layer, Input):
            cur_shape = out_shape
            continue
        src = plan.buffers[buf_idx]
        if isinstance(layer, ReLU):
            n = int(np.prod(cur_shape))
            _relu_inplace(e, _ident(name), ctype=ctype, n=n, off=src.offset_elems)
            cur_shape = out_shape
            continue
        if isinstance(layer, Flatten):
            cur_shape = out_shape
            continue  # contiguous arena: flatten is a no-op
        if isinstance(layer, (Add, Concat)):
            raise TypeError(f"cannot emit C for layer {layer!r}")
        dst = plan.buffers[buf_idx + 1]
        _emit_op(e, layer, name, [cur_shape], [src.offset_elems], dst.offset_elems,
                 ctype=ctype, acc_type=acc_type, weights=weights,
                 requants=requants, join_ms=None)
        buf_idx += 1
        cur_shape = out_shape
    return int(np.prod(shapes[-1]))


def _emit_step(
    e: _Emitter,
    step,
    src_bufs,
    dst_buf,
    *,
    ctype: str,
    acc_type: str,
    weights: dict,
    requants: Optional[dict],
    join_ms: Optional[dict],
) -> None:
    """Emit one materialized DAG step (op + folded views) at plan offsets."""
    layer = step.layer
    tag = _ident(step.name)
    in_offs = [b.offset_elems for b in src_bufs]
    out_off = dst_buf.offset_elems
    if isinstance(layer, (ReLU, Flatten)):
        # materialized view: its producer has other consumers, so the value
        # cannot be updated in place — a real copy (with activation for ReLU)
        _copy_loops(
            e, tag, ctype=ctype, n=int(np.prod(step.in_shapes[0])),
            in_off=in_offs[0], out_off=out_off, relu=isinstance(layer, ReLU),
        )
    else:
        _emit_op(e, layer, step.name, step.in_shapes, in_offs, out_off,
                 ctype=ctype, acc_type=acc_type, weights=weights,
                 requants=requants, join_ms=join_ms)

    # folded views: ReLU applies in place on the step's output buffer (its
    # int8 form operates on the already-requantized value, matching
    # quant.exec.apply_int8_node); Flatten is a no-op on a flat arena.
    for v in step.views:
        if isinstance(v, ReLU):
            _relu_inplace(
                e, f"{tag}_{_ident(v.name or 'relu')}", ctype=ctype,
                n=dst_buf.size_elems, off=out_off,
            )


def _walk_and_emit_dag(
    graph: DAGGraph,
    plan: MemoryPlan,
    e: _Emitter,
    *,
    ctype: str,
    acc_type: str,
    weights: dict,
    requants: Optional[dict],
    join_ms: Optional[dict],
):
    """Emit the schedule in the plan's (reordered) buffer order.

    Returns the graph output's :class:`BufferAssignment`.
    ``plan.buffers[i]`` is the buffer of schedule step *i*; the input load
    and output store are emitted by the caller using ``buffers[0]`` / the
    returned output buffer.
    """
    mat, order = schedule_mod.check_dag_plan(graph, plan)
    steps = {s.name: s for s in mat.steps}
    bufs = {b.name: b for b in plan.buffers}
    in_step = steps[order[0]]
    for v in in_step.views:
        if isinstance(v, ReLU):
            _relu_inplace(
                e, _ident(v.name or "relu"), ctype=ctype,
                n=bufs[order[0]].size_elems, off=bufs[order[0]].offset_elems,
            )
    for name in order[1:]:
        step = steps[name]
        _emit_step(
            e, step, [bufs[s] for s in step.inputs], bufs[name],
            ctype=ctype, acc_type=acc_type, weights=weights,
            requants=requants, join_ms=join_ms,
        )
    return bufs[mat.output]


# Byte for byte the reference emitter's preamble, so an engine emitted by
# either package compares equal.
_PREAMBLE = """\
/* Generated by repro.core.export_c — reproduction of
 * "Efficient Neural Network Deployment for Microcontroller" (Unlu, 2020).
 * Weights are const -> .rodata/.text (flash, paper §3.3).
 * The single static arena below is the planned SRAM footprint (paper §3.2).
 */
#include <stdint.h>
#include <math.h>
"""


def _decl_float_weights(e: _Emitter, graph, params) -> dict:
    """Declare each layer's f32 weights and bias; returns them by layer."""
    weights = {}
    for layer in graph.layers:
        name = layer.name or layer.kind
        if name in params:
            tag = _ident(name)
            w = _host_f32(params[name]["w"])
            e.decl(_fmt_array(w, "float", f"W_{tag}"))
            weights[name] = {"w": w}
            if "b" in params[name] and params[name]["b"] is not None:
                b = _host_f32(params[name]["b"])
                e.decl(_fmt_array(b, "float", f"B_{tag}"))
                weights[name]["b"] = b
    return weights


def _decl_int8_weights(e: _Emitter, qm: QuantizedModel):
    """Declare each layer's int8 weights, int32 bias and requant
    multipliers, and each join's multipliers; returns (weights, requant
    templates, join multipliers) by layer."""
    weights, requants, join_ms = {}, {}, {}
    for layer in qm.graph.layers:
        name = layer.name or layer.kind
        tag = _ident(name)
        if name in qm.layers:
            q = qm.layers[name]
            e.decl(_fmt_array(q.w_q, "int8_t", f"W_{tag}"))
            weights[name] = {"w": q.w_q}
            if q.b_q is not None:
                e.decl(_fmt_array(q.b_q, "int32_t", f"B_{tag}"))
                weights[name]["b"] = q.b_q
            div = 1
            if isinstance(layer, FusedConvPool) and layer.pool == "avg":
                div = layer.pool_kernel[0] * layer.pool_kernel[1]
            requants[name] = _decl_requant(e, tag, q, div)
        elif name in qm.joins:
            ms = qm.joins[name].multipliers
            for i, m in enumerate(ms):
                e.decl(f"static const float M_{tag}_{i} = {_fmt_float(m)};")
            join_ms[name] = ms
    return weights, requants, join_ms


def _engine(e: _Emitter, ctype: str, plan: MemoryPlan, walk, with_main: bool) -> str:
    """The translation unit: declarations, the arena, ``nn_forward`` (input
    copied into the plan's first buffer, ``walk()`` emitting the body and
    returning the output buffer's (offset, elements)), and the optional
    ``main()`` harness."""
    in_buf = plan.buffers[0]
    e.emit(f"static {ctype} arena[{plan.arena_elems}];")
    e.emit("")
    e.emit(f"void nn_forward(const {ctype}* input, {ctype}* output) {{")
    e.emit(f"  for (int i = 0; i < {in_buf.size_elems}; ++i) arena[{in_buf.offset_elems} + i] = input[i];")
    out_off, out_elems = walk()
    e.emit(f"  for (int i = 0; i < {out_elems}; ++i) output[i] = arena[{out_off} + i];")
    e.emit("}")
    src = _PREAMBLE + "\n".join(e.decls) + "\n\n" + "\n".join(e.body) + "\n"
    if with_main:
        src += _main_harness(ctype, in_buf.size_elems, out_elems)
    return src


def generate_c(
    graph: SequentialGraph,
    plan: MemoryPlan,
    params,
    with_main: bool = False,
) -> str:
    """Float32 C engine (the paper's LeNet-5 deployment, §3/§4)."""
    e = _Emitter()
    weights = _decl_float_weights(e, graph, params)

    def walk():
        n = _walk_and_emit(graph, plan, e, ctype="float", acc_type="float",
                           weights=weights, requants=None)
        return plan.buffers[-1].offset_elems, n

    return _engine(e, "float", plan, walk, with_main)


def generate_c_int8(
    qm: QuantizedModel,
    plan: MemoryPlan,
    with_main: bool = False,
) -> str:
    """Int8 C engine (the paper's §5 CMSIS-NN comparison path).

    Requantization uses a float multiplier with round-half-to-even
    (``nearbyintf`` under the default FE_TONEAREST mode), matching
    `repro_torch.core.quantize.simulate_int8_forward` bit-for-bit.
    """
    e = _Emitter()
    weights, requants, _ = _decl_int8_weights(e, qm)
    e.decl(REQUANT_C)

    def walk():
        n = _walk_and_emit(qm.graph, plan, e, ctype="int8_t", acc_type="int32_t",
                           weights=weights, requants=requants)
        return plan.buffers[-1].offset_elems, n

    return _engine(e, "int8_t", plan, walk, with_main)


def generate_c_dag(
    graph: DAGGraph,
    plan: MemoryPlan,
    params,
    with_main: bool = False,
) -> str:
    """Float32 C engine for a (fused) DAG and its reordered arena plan.

    Steps are emitted in the plan's schedule order with interval-allocated
    offsets; join nodes render as elementwise adds / contiguous concat
    copies.  The engine must match ``nn.forward_dag`` on the same graph.
    """
    e = _Emitter()
    weights = _decl_float_weights(e, graph, params)

    def walk():
        out = _walk_and_emit_dag(graph, plan, e, ctype="float", acc_type="float",
                                 weights=weights, requants=None, join_ms=None)
        return out.offset_elems, out.size_elems

    return _engine(e, "float", plan, walk, with_main)


def generate_c_int8_dag(
    qm: QuantizedModel,
    plan: MemoryPlan,
    with_main: bool = False,
) -> str:
    """Int8 C engine for a DAG-quantized model and its reordered plan.

    Join requantization mirrors ``quantize.requantize_join`` /
    ``requantize_concat`` (per-input f32 multiplier, round-half-to-even,
    saturate), so the engine is bit-exact against
    `repro_torch.core.quantize.simulate_int8_dag_forward`.
    """
    if not isinstance(qm.graph, DAGGraph):
        raise TypeError("generate_c_int8_dag expects a DAG-quantized model")
    e = _Emitter()
    weights, requants, join_ms = _decl_int8_weights(e, qm)
    e.decl(REQUANT_C)

    def walk():
        out = _walk_and_emit_dag(qm.graph, plan, e, ctype="int8_t",
                                 acc_type="int32_t", weights=weights,
                                 requants=requants, join_ms=join_ms)
        return out.offset_elems, out.size_elems

    return _engine(e, "int8_t", plan, walk, with_main)


def _main_harness(ctype: str, in_elems: int, out_elems: int) -> str:
    return f"""
#include <stdio.h>
int main(void) {{
  static {ctype} input[{in_elems}];
  static {ctype} output[{out_elems}];
  if (fread(input, sizeof({ctype}), {in_elems}, stdin) != {in_elems}) return 1;
  nn_forward(input, output);
  fwrite(output, sizeof({ctype}), {out_elems}, stdout);
  return 0;
}}
"""
