"""Launch plumbing of the fused conv+act+pool kernels on Hopper.

The port's counterpart of ``repro/kernels/conv_pool/kernel.py``: everything
dtype-independent about a launch — geometry, the checks on device, dtype,
shape and layout, the output (allocated, or an ``out=`` view into an arena
bank), the launch of a grid over pooled rows and output channels sized by
the kernel's own tiling, and the launch counters — shared by the four
conv+pool kernels, so they cannot diverge:

* K1, dense float (``csrc/conv_pool.cu``), tiled by :func:`k1_tiling`;
* K2, dense int8 (``csrc/conv_pool_q8.cu``, `repro_torch.quant.kernel_q8`),
  tiled by :func:`k2_tiling`;
* K3, depthwise float (``csrc/conv_pool_dw.cu``,
  `repro_torch.kernels.conv_pool.depthwise`), tiled by its ``k3_tiling``;
* K4, depthwise int8 (``csrc/conv_pool_dw_q8.cu``,
  `repro_torch.quant.kernel_q8`), tiled by ``k3_tiling`` too: one output a
  thread, as K3.

Layout is NCHW, as in the paper and PyTorch.  Each image of ``x`` and of
the output must be contiguous; the batch stride is free, so the executors
pass views of their ``(N, arena_elems)`` arena and the kernel reads one
bank and writes the other in place.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.graph import _pair
from repro_torch.kernels import build
from repro_torch.kernels.build import LaunchCounter

# K1 and K2 hold the weights of their tile of output channels in shared
# memory; 227 KB is what one CTA may have on Hopper.
MAX_SMEM_BYTES = 232448
# K1 and K2 split their output channels until a call has one CTA per SM of
# an H100 (132), and tile pooled rows past that; each CTA computes at least
# a warp's worth of conv values.
K1_TARGET_CTAS = 132
K1_MIN_CONV_VALUES = 32


# One counter per kernel; each wrapper adds one where it launches, and
# nowhere else.
K1_LAUNCHES = LaunchCounter()


def output_hw(h: int, w: int, kh: int, kw: int, *, conv_stride, padding,
              pool_k, pool_stride) -> Tuple[int, int, int, int]:
    """(OH, OW, PH, PW): the conv and pooled extents of one geometry."""
    (csh, csw), (ph_, pw_) = _pair(conv_stride), _pair(padding)
    (pkh, pkw), (psh, psw) = _pair(pool_k), _pair(pool_stride)
    oh = (h + 2 * ph_ - kh) // csh + 1
    ow = (w + 2 * pw_ - kw) // csw + 1
    return oh, ow, (oh - pkh) // psh + 1, (ow - pkw) // psw + 1


def _span(n: int, k: int, s: int) -> int:
    """Positions that n consecutive windows of k at stride s cover
    (``conv_pool_math.cuh::span``)."""
    return (n - 1) * s + k


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _words16(n: int) -> int:
    return _round_up(n, 4)


def _k1_shares(cin, h, w, kh, kw, *, conv_stride, padding, pool_k, pool_stride,
               rows, ct, cc) -> Tuple[int, int, int]:
    """K1's shared memory in bytes, by part: (f32 weights of ``ct`` output
    channels over every input channel, one chunk of ``cc`` staged input
    channels, the conv tile), each 16-byte aligned."""
    (csh, csw), (pkh, pkw), (psh, psw) = (_pair(conv_stride), _pair(pool_k),
                                          _pair(pool_stride))
    _, _, _, pw = output_hw(h, w, kh, kw, conv_stride=conv_stride, padding=padding,
                            pool_k=pool_k, pool_stride=pool_stride)
    crows, ccols = _span(rows, pkh, psh), _span(pw, pkw, psw)
    hrows, wcols = _span(crows, kh, csh), _span(ccols, kw, csw)
    return (4 * _words16(ct * cin * kh * kw), 4 * _words16(cc * hrows * wcols),
            4 * _words16(ct * crows * ccols))


def k1_smem_bytes(cin, h, w, kh, kw, *, conv_stride, padding, pool_k, pool_stride,
                  rows, ct, cc=None) -> int:
    """K1's shared memory for tiles of ``rows`` pooled rows and ``ct``
    output channels, staging ``cc`` input channels at a time (all ``cin``
    when None): the same sum as ``conv_pool_math.cuh::k1_smem_bytes``."""
    return sum(_k1_shares(cin, h, w, kh, kw, conv_stride=conv_stride,
                          padding=padding, pool_k=pool_k, pool_stride=pool_stride,
                          rows=rows, ct=ct, cc=cin if cc is None else cc))


def k1_tiling(n, cin, h, w, cout, kh, kw, *, conv_stride, padding, pool_k,
              pool_stride) -> Tuple[int, int, int]:
    """(pooled rows, output channels, input channels staged at a time) per
    CTA of K1, one grid a call.

    Pooled rows: one a CTA until ``n`` images' rows reach
    ``K1_TARGET_CTAS``, then as many as keep the grid near it.  Channels:
    split into as many tiles as it takes to reach that count, each tile
    holding at least ``K1_MIN_CONV_VALUES`` conv values, in equal tiles (the
    last may be shorter).  Input channels: all at once.  Then, until it fits
    shared memory, halve the output channels while their weights are half
    of it or more, else the rows; at one row, halve the staged input
    channels while the staged input is half of it or more, else the output
    channels, else the staged input channels.  The CTA restages its input
    chunk by chunk, so a layer of any width fits; raises only when one
    output channel of one pooled row, one input channel at a time, does not.
    Staged input chunks are equal (the last may be shorter)."""
    (pkh, pkw), (psh, psw) = _pair(pool_k), _pair(pool_stride)
    _, _, ph, pw = output_hw(h, w, kh, kw, conv_stride=conv_stride, padding=padding,
                             pool_k=pool_k, pool_stride=pool_stride)
    n = max(n, 1)
    rows = max(1, -(-ph // max(1, K1_TARGET_CTAS // n)))
    tiles = min(cout, -(-K1_TARGET_CTAS // (n * -(-ph // rows))))
    per_channel = _span(rows, pkh, psh) * _span(pw, pkw, psw)
    ct = min(cout, max(-(-cout // tiles), -(-K1_MIN_CONV_VALUES // per_channel)))
    geom = dict(conv_stride=conv_stride, padding=padding, pool_k=pool_k,
                pool_stride=pool_stride)
    shares = lambda rows, ct, cc: _k1_shares(cin, h, w, kh, kw, rows=rows, ct=ct, cc=cc,
                                             **geom)
    rows, ct, cc = _shrink_to_fit("K1", shares, rows, ct, cin, unit=1)
    return rows, -(-cout // -(-cout // ct)), -(-cin // -(-cin // cc))


def _shrink_to_fit(name, shares, rows, ct, cc, *, unit):
    """(rows, ct, cc) shrunk until ``sum(shares(rows, ct, cc))`` fits one
    CTA: halve the output channels while their weights are half of it or
    more, else the rows; at one row, halve the staged input channels (in
    multiples of ``unit``) while the staged input is half of it or more,
    else the output channels, else the staged input channels.  Raises when
    one output channel of one pooled row, ``unit`` input channels at a
    time, does not fit."""
    halve_cc = lambda cc: _round_up(-(-cc // 2), unit)
    while (smem := sum(parts := shares(rows, ct, cc))) > MAX_SMEM_BYTES:
        weights, staged, _ = parts
        if ct > 1 and 2 * weights >= smem:
            ct = -(-ct // 2)
        elif rows > 1:
            rows = -(-rows // 2)
        elif cc > unit and 2 * staged >= smem:
            cc = halve_cc(cc)
        elif ct > 1:
            ct = -(-ct // 2)
        elif cc > unit:
            cc = halve_cc(cc)
        else:
            raise ValueError(f"{name}: one output channel of one pooled row needs "
                             f"{smem} B of shared memory, over {MAX_SMEM_BYTES} B")
    return rows, ct, cc


def _k2_shares(cin, h, w, kh, kw, *, conv_stride, padding, pool_k, pool_stride,
               rows, ct, cc) -> Tuple[int, int, int]:
    """K2's shared memory in bytes, by part, each 16-byte aligned: the int8
    weights of ``ct`` output channels over every input channel (channels
    innermost, padded to whole 32-bit words of 4), one chunk of ``cc``
    staged int8 input channels (a position's channels in ``k2_pos_words``
    words) and the int32 conv tile (``conv_pool_math.cuh::k2_smem_bytes``)."""
    (csh, csw), (pkh, pkw), (psh, psw) = (_pair(conv_stride), _pair(pool_k),
                                          _pair(pool_stride))
    _, _, _, pw = output_hw(h, w, kh, kw, conv_stride=conv_stride, padding=padding,
                            pool_k=pool_k, pool_stride=pool_stride)
    crows, ccols = _span(rows, pkh, psh), _span(pw, pkw, psw)
    hrows, wcols = _span(crows, kh, csh), _span(ccols, kw, csw)
    return (4 * _words16(ct * kh * kw * -(-cin // 4)),
            4 * _words16(hrows * wcols * k2_pos_words(cc)),
            4 * _words16(ct * crows * ccols))


def k2_pos_words(cc: int) -> int:
    """32-bit words one staged input position of K2 takes for ``cc`` int8
    channels: 4 a word, made odd so neighbouring positions fall in distinct
    shared-memory banks (``conv_pool_math.cuh::k2_pos_words``)."""
    return -(-cc // 4) | 1


def k2_smem_bytes(cin, h, w, kh, kw, *, conv_stride, padding, pool_k, pool_stride,
                  rows, ct, cc=None) -> int:
    """K2's shared memory for tiles of ``rows`` pooled rows and ``ct``
    output channels, staging ``cc`` input channels at a time (all ``cin``
    when None): the same sum as ``conv_pool_math.cuh::k2_smem_bytes``."""
    return sum(_k2_shares(cin, h, w, kh, kw, conv_stride=conv_stride,
                          padding=padding, pool_k=pool_k, pool_stride=pool_stride,
                          rows=rows, ct=ct, cc=cin if cc is None else cc))


def k2_tiling(n, cin, h, w, cout, kh, kw, *, conv_stride, padding, pool_k,
              pool_stride) -> Tuple[int, int, int]:
    """(pooled rows, output channels, input channels staged at a time) per
    CTA of K2, one grid a call.

    As :func:`k1_tiling`, with K2's int8 shares (:func:`_k2_shares`), and
    channel tiles small enough that the grid reaches ``K1_TARGET_CTAS`` where
    the channels allow (at least ``K1_MIN_CONV_VALUES`` conv values a tile).
    Staged input chunks are all ``cin`` channels, or a multiple of 4 (whole
    32-bit words of the weights), equal but for the last."""
    (pkh, pkw), (psh, psw) = _pair(pool_k), _pair(pool_stride)
    _, _, ph, pw = output_hw(h, w, kh, kw, conv_stride=conv_stride, padding=padding,
                             pool_k=pool_k, pool_stride=pool_stride)
    n = max(n, 1)
    rows = max(1, -(-ph // max(1, K1_TARGET_CTAS // n)))
    tiles = -(-K1_TARGET_CTAS // (n * -(-ph // rows)))
    per_channel = _span(rows, pkh, psh) * _span(pw, pkw, psw)
    ct = min(cout, max(cout // tiles, 1, -(-K1_MIN_CONV_VALUES // per_channel)))
    geom = dict(conv_stride=conv_stride, padding=padding, pool_k=pool_k,
                pool_stride=pool_stride)
    shares = lambda rows, ct, cc: _k2_shares(cin, h, w, kh, kw, rows=rows, ct=ct, cc=cc,
                                             **geom)
    rows, ct, cc = _shrink_to_fit("K2", shares, rows, ct, cin, unit=min(4, cin))
    chunks = -(-cin // cc)
    return rows, -(-cout // -(-cout // ct)), cin if chunks == 1 else _round_up(-(-cin // chunks), 4)


def _image_contiguous(t: torch.Tensor) -> bool:
    """True iff every image of a (N, C, H, W) tensor is one dense block."""
    _, c, h, w = t.shape
    return t.stride(3) == 1 and t.stride(2) == w and t.stride(1) == h * w


def conv_pool_call(
    fn_name: str,
    lib_name: str,
    counter: LaunchCounter,
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    conv_stride,
    padding,
    pool_k,
    pool_stride,
    activation: str,
    pool: str,
    out_dtype: torch.dtype,
    bias_dtype: torch.dtype,
    out: Optional[torch.Tensor] = None,
    depthwise: bool = False,
    tiling,
    extra_args: tuple = (),
) -> torch.Tensor:
    """Check, allocate and launch one fused conv+act+pool kernel.

    ``x`` is (N, Cin, H, W) on a CUDA device, ``w`` (Cout, Cin, kh, kw) —
    or (C, 1, kh, kw) with Cout = Cin = C when ``depthwise`` — and ``b``
    (Cout,), contiguous on the same device.  ``extra_args`` are passed after
    the strides: ctypes values (K2's requant multiplier) or tensors, passed
    as their device pointers (K4's per-channel multipliers).  ``tiling``
    is the kernel's own tiling: it gives the tile sizes per CTA from the
    geometry, passed to the kernel in order after the activation and pool
    flags — (pooled rows, output channels) from K3's and K4's ``k3_tiling``,
    and K1's :func:`k1_tiling` and K2's :func:`k2_tiling` add the input
    channels staged at a time.
    Raises on anything the kernel does not take; never falls back.
    """
    if x.device.type != "cuda":
        raise ValueError(f"{fn_name}: expected a CUDA tensor, got {x.device}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"{fn_name}: x must be (N,C,H,W) and w (O,I,kh,kw), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    n, cin, h, wd = x.shape
    cout, wcin, kh, kw = w.shape
    if depthwise and (wcin != 1 or cout != cin):
        raise ValueError(f"{fn_name}: a depthwise w is ({cin},1,kh,kw), got "
                         f"{tuple(w.shape)} for {cin} input channels")
    if not depthwise and wcin != cin:
        raise ValueError(f"{fn_name}: w has {wcin} input channels, x has {cin}")
    for name, t in (("w", w), ("b", b)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{fn_name}: {name} must be contiguous on {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"{fn_name}: x and w must share one dtype, got "
                        f"{x.dtype} and {w.dtype}")
    if b is not None and (b.dtype != bias_dtype or tuple(b.shape) != (cout,)):
        raise TypeError(f"{fn_name}: b must be ({cout},) {bias_dtype}, got "
                        f"{tuple(b.shape)} {b.dtype}")
    if not _image_contiguous(x):
        raise ValueError(f"{fn_name}: each image of x must be contiguous")
    if activation not in ("relu", "none") or pool not in ("max", "avg"):
        raise ValueError(f"{fn_name}: unsupported activation/pool "
                         f"{activation!r}/{pool!r}")
    (csh, csw), (padh, padw) = _pair(conv_stride), _pair(padding)
    (pkh, pkw), (psh, psw) = _pair(pool_k), _pair(pool_stride)
    _, _, ph, pw = output_hw(h, wd, kh, kw, conv_stride=conv_stride,
                             padding=padding, pool_k=pool_k,
                             pool_stride=pool_stride)
    if ph < 1 or pw < 1:
        raise ValueError(f"{fn_name}: geometry gives an empty output")
    geom = dict(conv_stride=conv_stride, padding=padding, pool_k=pool_k,
                pool_stride=pool_stride)
    tiles = tiling(n, wcin, h, wd, cout, kh, kw, **geom)
    if out is None:
        out = torch.empty((n, cout, ph, pw), dtype=out_dtype, device=x.device)
    elif (tuple(out.shape) != (n, cout, ph, pw) or out.dtype != out_dtype
          or out.device != x.device or not _image_contiguous(out)):
        raise ValueError(f"{fn_name}: out must be ({n},{cout},{ph},{pw}) "
                         f"{out_dtype} with contiguous images on {x.device}, "
                         f"got {tuple(out.shape)} {out.dtype}")
    if n == 0:
        return out
    # Build/load first: without nvcc or a card this raises before any
    # pointer is taken.
    fn = getattr(build.load(lib_name), fn_name)
    ints = (n, cin, h, wd, cout, kh, kw, csh, csw, padh, padw, pkh, pkw,
            psh, psw, int(activation == "relu"), int(pool == "avg"), *tiles)
    args = [ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
            ctypes.c_void_p(b.data_ptr() if b is not None else 0),
            ctypes.c_void_p(out.data_ptr())]
    args += [ctypes.c_int(v) for v in ints]
    args += [ctypes.c_longlong(x.stride(0)), ctypes.c_longlong(out.stride(0))]
    args += [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a
             for a in extra_args]
    args.append(ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    fn.restype = ctypes.c_int
    fn.argtypes = [type(a) for a in args]
    build.check(fn(*args), fn_name)
    counter.add((fn_name, n, cin, h, wd, cout, kh, kw, csh, csw, padh, padw,
                 pkh, pkw, psh, psw, pool))
    return out


def conv_pool(x, w, b, *, conv_stride=1, padding=0, pool_k=2, pool_stride=2,
              activation: str = "relu", pool: str = "max", out=None):
    """K1 on the card: f32 or bf16 (N,Cin,H,W) in, (N,Cout,PH,PW) out in the
    input dtype, f32 accumulation."""
    if x.dtype == torch.float32:
        fn_name = "conv_pool_f32"
    elif x.dtype == torch.bfloat16:
        fn_name = "conv_pool_bf16"
    else:
        raise TypeError(f"conv_pool: f32 or bf16 input, got {x.dtype}")
    return conv_pool_call(
        fn_name, "conv_pool", K1_LAUNCHES, x, w, b, conv_stride=conv_stride,
        padding=padding, pool_k=pool_k, pool_stride=pool_stride,
        activation=activation, pool=pool, out_dtype=x.dtype,
        bias_dtype=x.dtype, out=out, tiling=k1_tiling,
    )
