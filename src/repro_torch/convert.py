"""Carry weights and quantized models into the port through numpy.

The JAX package is the reference the port is held against, and its PRNG
cannot be reproduced in PyTorch, so tests make weights there and pass them
across as numpy arrays.  These functions take only numpy-convertible values
and duck-typed records — the port never imports the reference package.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedJoin, QuantizedLayer, QuantizedModel
from repro_torch.device import resolve


def params_from_numpy(params_np: Mapping[str, Mapping[str, object]],
                      device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {"w": array, "b": array}}`` → the same dict of tensors on
    ``device``, dtype kept (so f32 stays f32)."""
    dev = resolve(device)
    return {
        name: {k: torch.as_tensor(np.array(v), device=dev) for k, v in p.items()}
        for name, p in params_np.items()
    }


def quantized_from_numpy(graph, input_scale: float,
                         layers: Mapping[str, object],
                         joins: Optional[Mapping[str, object]] = None) -> QuantizedModel:
    """Rebuild a port :class:`QuantizedModel` over ``graph`` (a port graph,
    sequential or DAG) from another model's per-layer and per-join records.

    Each record in ``layers`` exposes ``w_q`` (int8), ``b_q`` (int32 or
    None), ``w_scale`` (a float, or a ``(C,)`` array for a per-channel
    layer), ``in_scale`` and ``out_scale`` as attributes; each record in
    ``joins`` exposes ``in_scales`` and ``out_scale``.  The reference's
    ``QuantizedLayer`` and ``QuantizedJoin`` qualify as they are.
    """
    out: Dict[str, QuantizedLayer] = {}
    for name, q in layers.items():
        w_scale = q.w_scale
        out[name] = QuantizedLayer(
            name=name,
            w_q=np.array(q.w_q, np.int8),
            b_q=None if q.b_q is None else np.array(q.b_q, np.int32),
            w_scale=(np.array(w_scale) if np.ndim(w_scale) else float(w_scale)),
            in_scale=float(q.in_scale),
            out_scale=float(q.out_scale),
        )
    return QuantizedModel(
        graph=graph, input_scale=float(input_scale), layers=out,
        joins={name: QuantizedJoin(name=name,
                                   in_scales=tuple(float(v) for v in j.in_scales),
                                   out_scale=float(j.out_scale))
               for name, j in (joins or {}).items()})
