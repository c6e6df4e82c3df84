"""K5's launch: checks, output allocation and the ``K5_LAUNCHES`` counter.

The port's counterpart of ``repro/kernels/flash/kernel.py::flash_attention_fwd``
(``pallas_call`` at ``kernel.py:112``), launching ``csrc/flash_fwd.cu``:
bf16 on the tensor cores, f32 on the CUDA cores.  Unlike the TPU entry
point it takes any ``S`` and ``T`` (no divisibility by a block), and reads
``q``, ``k`` and ``v`` in their ``(B, S, n, h)`` layout with any batch, row
and head strides, so views of a projection go in without a transposing
copy; only the head dim must be contiguous.  bf16 inputs whose pointers or
strides are not 16-byte aligned are staged by scalar loads in the same
launch.  ``q_offset`` places query row i at position ``q_offset + i`` over
keys 0..T-1 (a data row's span of a sequence split over the data axes, its
keys those of the rows before it and its own); it is the last field of the
``K5_LAUNCHES`` key.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv_pool.kernel import LaunchCounter

K5_LAUNCHES = LaunchCounter()
HEAD_DIMS = (32, 64, 128, 256)
_FN = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """K5 on the card: q (B, S, H, h), k/v (B, T, K, h), f32 or bf16, one
    dtype, query row i at position ``q_offset + i``; returns a contiguous
    (B, S, H, h) in that dtype.  Raises on anything the kernel does not
    take; never falls back."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: expected CUDA tensors, got {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention_fwd: q, k, v must be (B, S, n, h)")
    B, S, H, h = q.shape
    T, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, K, h) or tuple(v.shape) != (B, T, K, h):
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be ({B}, T, K, {h})")
    if K < 1 or H % K:
        raise ValueError(f"flash_attention_fwd: {H} query heads over {K} KV heads")
    if h not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {h} not in {HEAD_DIMS}")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: f32 or bf16, one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(3) != 1:
            raise ValueError(f"flash_attention_fwd: {name} must be on {q.device} "
                             f"with a contiguous head dim")
    if window < 0:
        raise ValueError(f"flash_attention_fwd: window {window} < 0")
    check_offset(q_offset, S, T, causal)
    if scale is None:
        scale = h ** -0.5
    out = torch.empty((B, S, H, h), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    fn_name = _FN[q.dtype]
    fn = getattr(build.load("flash_fwd"), fn_name)
    ptr = ctypes.c_void_p
    args = [ptr(q.data_ptr()), ptr(k.data_ptr()), ptr(v.data_ptr()), ptr(out.data_ptr())]
    args += [ctypes.c_int(n) for n in (B, S, T, H, K, h)]
    args += [ctypes.c_longlong(t.stride(d)) for t in (q, k, v, out) for d in (0, 1, 2)]
    args += [ctypes.c_float(scale), ctypes.c_int(int(causal)), ctypes.c_int(int(window)),
             ctypes.c_int(int(q_offset)), ctypes.c_float(softcap),
             ptr(torch.cuda.current_stream(q.device).cuda_stream)]
    fn.restype = ctypes.c_int
    fn.argtypes = [type(a) for a in args]
    build.check(fn(*args), fn_name)
    K5_LAUNCHES.add((fn_name, B, S, T, H, K, h, bool(causal), int(window), float(softcap),
                     int(q_offset)))
    return out


def check_offset(q_offset: int, S: int, T: int, causal: bool) -> None:
    """Raises unless ``q_offset >= 0`` and, when causal, the last query row
    (at ``q_offset + S - 1``) has its own key (``q_offset + S <= T``)."""
    if q_offset < 0 or (causal and q_offset + S > T):
        raise ValueError(f"flash attention: q_offset {q_offset} for {S} query rows over {T} "
                         f"keys (causal={causal})")
