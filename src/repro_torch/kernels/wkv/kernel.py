"""K7's launch: checks, output allocation and the ``K7_LAUNCHES`` counter.

The port's counterpart of ``repro/kernels/wkv/kernel.py::wkv_fwd``
(``pallas_call`` at ``kernel.py:95``), launching ``csrc/wkv_fwd.cu``: the
chunked wkv6 forward from the zero state, as the TPU kernel's, or from a
carried state ``s0``.  One call launches two kernels, ``wkv_intra_kernel``
(each tile's intra-tile output, every tile at once) and
``wkv_carry_kernel`` (the state carried through the tiles in order, split
into 16-column slices), and ticks ``K7_LAUNCHES`` once, its key ending in
whether the call carried a state in.  The kernel tiles S by its own tile
(``TILE``) whatever the reference's chunk, since the result does not depend
on it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv_pool.kernel import LaunchCounter

K7_LAUNCHES = LaunchCounter()
MAX_DIM = 64  # largest chunk, hk and hv the kernel takes
TILE = 32  # the kernel's own tile of S: wkv_fwd.cu's kTile, which sizes the scratch
_FN = {torch.float32: "wkv_fwd_f32", torch.bfloat16: "wkv_fwd_bf16"}


def wkv_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
            u: torch.Tensor, s0: Optional[torch.Tensor] = None, *, chunk: int):
    """K7 on the card.  r/k (B, S, H, hk) and v (B, S, H, hv), contiguous,
    one dtype (f32 or bf16); logw (B, S, H, hk) and u (H, hk) contiguous
    f32; ``s0`` the incoming state (B, H, hk, hv) contiguous f32, or None
    for the zero state; ``chunk``, the reference's chunk, divides S (the
    kernel runs its own ``TILE`` of S, the last one ragged).  Returns
    (o (B, S, H, hv), s_final (B, H, hk, hv)), both f32.  Raises on anything
    the kernel does not take; never falls back."""
    if r.device.type != "cuda":
        raise ValueError(f"wkv_fwd: expected CUDA tensors, got {r.device}")
    if r.ndim != 4 or v.ndim != 4:
        raise ValueError("wkv_fwd: r, k, v, logw must be (B, S, H, d)")
    B, S, H, hk = r.shape
    hv = v.shape[-1]
    if (tuple(k.shape) != (B, S, H, hk) or tuple(logw.shape) != (B, S, H, hk)
            or tuple(v.shape) != (B, S, H, hv) or tuple(u.shape) != (H, hk)):
        raise ValueError(f"wkv_fwd: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} logw {tuple(logw.shape)} u {tuple(u.shape)}")
    if not (1 <= hk <= MAX_DIM and 1 <= hv <= MAX_DIM and 1 <= chunk <= MAX_DIM):
        raise ValueError(f"wkv_fwd: hk {hk}, hv {hv} and chunk {chunk} must lie in "
                         f"[1, {MAX_DIM}]")
    if S % chunk:
        raise ValueError(f"wkv_fwd: chunk {chunk} does not divide S={S}")
    if r.dtype not in _FN or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv_fwd: r, k, v f32 or bf16, one dtype; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv_fwd: logw and u must be f32, got {logw.dtype}, {u.dtype}")
    if s0 is not None and (tuple(s0.shape) != (B, H, hk, hv) or s0.dtype != torch.float32):
        raise TypeError(f"wkv_fwd: s0 must be ({B}, {H}, {hk}, {hv}) f32, got "
                        f"{tuple(s0.shape)} {s0.dtype}")
    named = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u), ("s0", s0))
    for name, t in named:
        if t is not None and (t.device != r.device or not t.is_contiguous()):
            raise ValueError(f"wkv_fwd: {name} must be contiguous on {r.device}")
    o = torch.empty((B, S, H, hv), dtype=torch.float32, device=r.device)
    if B == 0 or S == 0:
        s_final = (torch.zeros((B, H, hk, hv), dtype=torch.float32, device=r.device)
                   if s0 is None else s0.clone())
        return o, s_final
    s_final = torch.empty((B, H, hk, hv), dtype=torch.float32, device=r.device)
    # the intra pass's r and k decayed to the tile's edges, and each tile's
    # decay, for the carry: rows of hk rounded up to whole 16-byte pieces
    hk4 = -(-hk // 4) * 4
    rdec, kdec = (torch.empty((B * H, S, hk4), dtype=torch.float32, device=r.device)
                  for _ in range(2))
    dend = torch.empty((B * H, -(-S // TILE), hk4), dtype=torch.float32, device=r.device)
    fn_name = _FN[r.dtype]
    fn = getattr(build.load("wkv_fwd"), fn_name)
    ptr = ctypes.c_void_p
    args = [ptr(t.data_ptr() if t is not None else 0)
            for t in (r, k, v, logw, u, s0, o, s_final, rdec, kdec, dend)]
    args += [ctypes.c_int(n) for n in (B, S, H, hk, hv)]
    args.append(ptr(torch.cuda.current_stream(r.device).cuda_stream))
    fn.restype = ctypes.c_int
    fn.argtypes = [type(a) for a in args]
    build.check(fn(*args), fn_name)
    K7_LAUNCHES.add((fn_name, B, S, H, hk, hv, chunk, s0 is not None))
    return o, s_final
