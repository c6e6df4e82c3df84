"""wkv6 by device: the plain version on the CPU, K7 on the card.

The port's counterpart of ``repro/kernels/wkv/ops.py::wkv``, with the same
chunk rule (``ops.py:27-29``): the chunk is the largest divisor of S not
above the one asked for, so a prime S runs chunks of 1.

* a CPU tensor runs :func:`repro_torch.kernels.wkv.ref.wkv_chunked`,
  differentiable as it is;
* a CUDA tensor runs :class:`WKV`, a ``torch.autograd.Function`` whose
  forward launches K7 (``csrc/wkv_fwd.cu``, which tiles S by its own tile
  whatever the chunk) or raises, and whose backward
  is autograd through ``wkv_chunked`` recomputed from the saved inputs:
  the plain scan the reference differentiates in training
  (``repro/models/rwkv6.py:181``), so gradients reach r, k, v, logw and u,
  and the incoming state ``s0`` when one is given;
* any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.wkv import kernel, ref


def chunk_for(S: int, chunk: int) -> int:
    """The largest divisor of ``S`` not exceeding ``chunk``."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


class WKV(torch.autograd.Function):
    """(o, s_final) of the chunked wkv6 scan from the incoming state ``s0``
    (None: the zero state), chunk a divisor of S.  Forward K7
    (``wkv_chunked`` on the CPU), backward the plain scan's VJP."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk: int, s0=None):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        if r.device.type == "cuda":
            return kernel.wkv_fwd(r, k, v, logw, u, s0, chunk=chunk)
        if r.device.type == "cpu":
            return ref.wkv_chunked(r, k, v, logw, u, s0, chunk=chunk)
        raise ValueError(f"wkv: no implementation for {r.device}")

    @staticmethod
    def backward(ctx, go, gs):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (r, k, v, logw, u)]
            s_in = None
            if s0 is not None:
                s_in = s0.detach().requires_grad_(ctx.needs_input_grad[6])
            o, s = ref.wkv_chunked(*leaves, s_in, chunk=ctx.chunk)
            outs = [(t, g) for t, g in ((o, go), (s, gs)) if g is not None]
            wrt = leaves + ([s_in] if s_in is not None and s_in.requires_grad else [])
            grads = list(torch.autograd.grad([t for t, _ in outs], wrt,
                                             [g for _, g in outs], allow_unused=True))
        ds0 = grads.pop() if len(wrt) > len(leaves) else None
        return (*grads, None, ds0)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 64, s0: Optional[torch.Tensor] = None):
    """Chunked wkv6 forward from the incoming state ``s0`` (B, H, hk, hv)
    f32, or from the zero state when None → (o, s_final), f32."""
    c = chunk_for(r.shape[1], chunk)
    if r.device.type == "cpu":
        return ref.wkv_chunked(r, k, v, logw.float(), u, s0, chunk=c)
    if r.device.type == "cuda":
        return WKV.apply(r, k, v, logw, u, c, s0)
    raise ValueError(f"wkv: no implementation for {r.device}")
