"""wkv6 by device: the plain version on the CPU, K7 on the card.

The port's counterpart of ``repro/kernels/wkv/ops.py::wkv``, with the same
chunk rule (``ops.py:27-29``): the chunk is the largest divisor of S not
above the one asked for, so a prime S runs chunks of 1.

* a CPU tensor runs :func:`repro_torch.kernels.wkv.ref.wkv_chunked`;
* a CUDA tensor launches K7 (``csrc/wkv_fwd.cu``) or raises;
* any other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv import kernel, ref


def chunk_for(S: int, chunk: int) -> int:
    """The largest divisor of ``S`` not exceeding ``chunk``."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
        u: torch.Tensor, *, chunk: int = 64):
    """Chunked wkv6 forward from the zero state → (o, s_final), f32."""
    c = chunk_for(r.shape[1], chunk)
    if r.device.type == "cpu":
        return ref.wkv_chunked(r, k, v, logw.float(), u, chunk=c)
    if r.device.type == "cuda":
        return kernel.wkv_fwd(r, k, v, logw, u, chunk=c)
    raise ValueError(f"wkv: no implementation for {r.device}")
