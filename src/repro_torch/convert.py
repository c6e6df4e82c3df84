"""Carry weights and quantized models into the port through numpy.

The JAX package is the reference the port is held against, and its PRNG
cannot be reproduced in PyTorch, so tests make weights there and pass them
across as numpy arrays.  These functions take only numpy-convertible values
and duck-typed records — the port never imports the reference package.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def lm_params_from_numpy(params_np: Mapping[str, Any], cfg, device="cuda",
                         compute_dtype=None) -> Dict[str, Any]:
    """The reference LM's param pytree (``repro.models.transformer.Model``)
    as numpy → the port's params, so that both compute the same function.

    The reference stacks each position ``i`` of the block pattern over
    pattern groups (``g{i}``: a leading group axis on every leaf) and keeps
    the remainder layers as ``r{i}``; the port keeps one dict per layer in
    ``params["layers"]``, layer ``g * P + i`` being group ``g`` of ``g{i}``.
    An enc-dec config's encoder, stacked over its ``encoder_layers`` as
    ``enc_g0``, becomes ``params["enc_layers"]``; its decoder layers carry
    their ``norm_x`` and ``cross`` leaves as any other.  ``embed``,
    ``unembed`` and ``final_norm`` carry over as they are.

    ``compute_dtype`` (a torch dtype or its name), when given, stores every
    weight the model casts to the compute dtype at use in that dtype once
    (:func:`repro_torch.models.transformer.store_compute_dtype`).  The
    reference casts its f32 params to bf16 at every use; one cast at load
    gives the same values without re-reading the f32 weights each step
    (30 GB for RWKV6-7B).
    """
    from repro_torch.models.transformer import store_compute_dtype

    dev = resolve(device)

    def tensors(tree, index=None):
        if isinstance(tree, Mapping):
            return {k: tensors(v, index) for k, v in tree.items()}
        a = np.asarray(tree)
        return torch.as_tensor(np.array(a if index is None else a[index]), device=dev)

    P = len(cfg.block_pattern)
    n_groups, rem = divmod(cfg.num_layers, P)
    layers = [tensors(params_np[f"g{li % P}"], li // P) for li in range(n_groups * P)]
    layers += [tensors(params_np[f"r{ri}"]) for ri in range(rem)]
    out = {k: tensors(params_np[k]) for k in ("embed", "unembed", "final_norm")
           if k in params_np}
    out["layers"] = layers
    if cfg.is_encdec:
        out["enc_layers"] = [tensors(params_np["enc_g0"], li)
                             for li in range(cfg.encoder_layers)]
    if compute_dtype is not None:
        store_compute_dtype(out, getattr(torch, compute_dtype)
                            if isinstance(compute_dtype, str) else compute_dtype)
    return out


def lm_params_to_numpy(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_numpy`: the port's params (or any
    tree of the same structure, such as AdamW's m or v) restacked into the
    reference's layout as numpy — ``g{i}`` holding position ``i`` of the
    pattern with a leading group axis, ``r{i}`` the remainder layers,
    ``enc_g0`` an enc-dec config's encoder layers."""
    def arrays(tree):
        if isinstance(tree, Mapping):
            return {k: arrays(v) for k, v in tree.items()}
        return tree.detach().cpu().numpy()

    def stack(trees):
        if isinstance(trees[0], Mapping):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    P = len(cfg.block_pattern)
    n_groups, rem = divmod(cfg.num_layers, P)
    layers = [arrays(layer) for layer in params["layers"]]
    out = {k: arrays(v) for k, v in params.items() if k not in ("layers", "enc_layers")}
    if "enc_layers" in params:
        out["enc_g0"] = stack([arrays(layer) for layer in params["enc_layers"]])
    if n_groups:
        out.update({f"g{i}": stack([layers[g * P + i] for g in range(n_groups)])
                    for i in range(P)})
    out.update({f"r{ri}": layers[n_groups * P + ri] for ri in range(rem)})
    return out


def adamw_state_from_numpy(state_np, cfg, device="cuda"):
    """The reference's ``AdamWState`` (``step``, group-stacked ``m`` and
    ``v``; as numpy or any array type) → the port's
    :class:`repro_torch.train.optimizer.AdamWState` on ``device``."""
    from repro_torch.train.optimizer import AdamWState

    dev = resolve(device)
    return AdamWState(step=torch.as_tensor(np.array(state_np.step), dtype=torch.int32,
                                           device=dev),
                      m=lm_params_from_numpy(state_np.m, cfg, device=dev),
                      v=lm_params_from_numpy(state_np.v, cfg, device=dev))
