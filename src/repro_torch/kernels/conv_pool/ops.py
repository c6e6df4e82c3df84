"""NCHW wrapper of K1, the fused conv+act+pool kernel.

The port's counterpart of ``repro/kernels/conv_pool/ops.py::fused_conv_pool``
(same signature, minus the reference's ``impl``/``interpret``/``row_block``
selectors).  Which implementation runs follows from where the caller put the
tensor, and from nothing else:

* a CPU tensor runs the plain version (`repro_torch.kernels.conv_pool.ref`);
* a CUDA tensor launches the Hopper kernel (`repro_torch.kernels.conv_pool.
  kernel`), or raises — a build or launch failure is never hidden behind
  the plain version;
* any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.conv_pool import kernel as _k
from repro_torch.kernels.conv_pool import ref as _ref


def fused_conv_pool(
    x: torch.Tensor,  # (Cin, H, W) or (N, Cin, H, W) — paper/PyTorch layout
    w: torch.Tensor,  # (Cout, Cin, kh, kw)
    b: Optional[torch.Tensor] = None,
    *,
    conv_stride=1,
    padding=0,
    pool_k=2,
    pool_stride=2,
    activation: str = "relu",
    pool: str = "max",
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns (Cout, PH, PW) or (N, Cout, PH, PW) in ``x.dtype``.

    Geometry arguments are per-axis ``(h, w)`` pairs (ints broadcast).
    ``out``, when given, receives the result (the executors pass a view of
    an arena bank); on CUDA the kernel writes it directly.
    """
    squeeze = x.ndim == 3
    if squeeze:
        x = x.unsqueeze(0)
        if out is not None:
            out = out.unsqueeze(0)
    geom = dict(conv_stride=conv_stride, padding=padding, pool_k=pool_k,
                pool_stride=pool_stride, activation=activation, pool=pool)
    if x.device.type == "cpu":
        y = _ref.conv_pool_ref(x, w, b, **geom)
        y = y if out is None else out.copy_(y)
    elif x.device.type == "cuda":
        y = _k.conv_pool(x, w, b, out=out, **geom)
    else:
        raise ValueError(f"fused_conv_pool: no implementation for {x.device}")
    return y.squeeze(0) if squeeze else y
