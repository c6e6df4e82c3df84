"""Carry weights and quantized models into the port through numpy.

The JAX package is the reference the port is held against, and its PRNG
cannot be reproduced in PyTorch, so tests make weights there and pass them
across as numpy arrays.  These functions take only numpy-convertible values
and duck-typed records — the port never imports the reference package.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedLayer, QuantizedModel
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
                         layers: Mapping[str, object]) -> QuantizedModel:
    """Rebuild a port :class:`QuantizedModel` over ``graph`` (a port graph)
    from another model's per-layer records.

    Each record in ``layers`` exposes ``w_q`` (int8), ``b_q`` (int32 or
    None), ``w_scale``, ``in_scale`` and ``out_scale`` as attributes — the
    reference's ``QuantizedLayer`` qualifies as it is.
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
    return QuantizedModel(graph=graph, input_scale=float(input_scale), layers=out)
