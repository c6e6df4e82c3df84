"""Abstract inputs for every (arch x shape) cell, as ``meta`` tensors.

The port's counterpart of ``repro/launch/inputs.py``, whose stand-ins are
``jax.ShapeDtypeStruct``s from ``jax.eval_shape``.  A ``meta`` tensor has
a shape and a dtype and no storage, so Llama-3-8B's tree costs nothing and
no value is drawn.  Modality frontends are stubs, as in the reference:
[audio] / [vlm] cells take frame / patch embeddings of the backbone width.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import cdt
from repro_torch.train import optimizer as opt

# enc-dec auxiliary sequence lengths, the reference's: the cell's seq_len
# applies to the dominant sequence; the other side uses these
ENCDEC_DECODER_PREFILL = 1024  # decoder prompt length in prefill cells
ENCDEC_MEMORY_LEN = 4096  # encoder memory length in decode cells

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return {"src_embeds": sds((B, S, cfg.d_model), cdt(cfg)),
                "tokens": sds((B, S), torch.int32),
                "targets": sds((B, S), torch.int32)}
    if cfg.frontend == "vision":
        return {"embeds": sds((B, S, cfg.d_model), cdt(cfg)),
                "targets": sds((B, S), torch.int32)}
    return {"tokens": sds((B, S), torch.int32), "targets": sds((B, S), torch.int32)}


def prefill_batch_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return {"src_embeds": sds((B, S, cfg.d_model), cdt(cfg)),
                "tokens": sds((B, ENCDEC_DECODER_PREFILL), torch.int32)}
    if cfg.frontend == "vision":
        return {"embeds": sds((B, S, cfg.d_model), cdt(cfg))}
    return {"tokens": sds((B, S), torch.int32)}


def abstract_params(model):
    """The model's param tree on ``meta``: no value drawn."""
    return model.init_params(None, device=META)


def abstract_opt_state(aparams) -> opt.AdamWState:
    return opt.init_state(aparams)


def abstract_cache(model, batch: int, max_seq: int):
    return model.init_cache(batch, max_seq, device=META)


def decode_inputs(cfg, shape) -> Tuple[Any, ...]:
    """(tokens, pos[, memory]) stand-ins for one decode step."""
    B = shape.global_batch
    out = [sds((B, 1), torch.int32), sds((B,), torch.int32)]
    if cfg.is_encdec:
        out.append(sds((B, ENCDEC_MEMORY_LEN, cfg.d_model), cdt(cfg)))
    return tuple(out)
