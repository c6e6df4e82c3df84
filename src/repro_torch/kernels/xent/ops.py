"""Fused cross-entropy by device, with the reference's memory-disciplined VJP.

The port's counterpart of ``repro/kernels/xent/ops.py::fused_xent``:

* a CPU tensor runs a plain form (:func:`plain_xent`): the vocab-chunked
  or the sequence-chunked reference, as the caller names it;
* a CUDA tensor runs :class:`FusedXent`, a ``torch.autograd.Function``
  whose forward is K6 (``csrc/xent_fwd.cu``) on the (N, D) tokens and
  whose backward is the reference's ``_bwd`` (``ops.py:28-34``): the VJP of
  ``seq_chunked_xent`` at chunk 256, recomputed one sequence chunk at a
  time, so neither pass holds (N, V).  The softcap's derivative is part of
  that VJP.  There is no backward kernel: the reference's backward is a
  plain VJP too;
* any other device raises.

Beside it, :func:`xent_part` and :class:`XentPart` give one vocab block's
share of the CE, ``(lse, t)``, for the sharded train step's vocab-split
loss (``repro_torch.sharding.tensor_parallel.xent``): K6's partial form
forward on the card, the same sequence-chunked plain VJP backward.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.xent import kernel, ref

BWD_SEQ_CHUNK = 256  # the reference's _bwd: seq_chunked_xent's default chunk


def _chunked_vjp(fn, x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                 softcap: float, grads) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of the sum of ``grads`` times the outputs of ``fn(x, w,
    targets, softcap=)`` (a plain form: ``naive_xent``'s CE or
    ``naive_xent_block``'s (lse, t)), recomputed one sequence chunk of
    ``BWD_SEQ_CHUNK`` at a time, so no pass holds the whole logits."""
    c = ref.seq_chunk_for(x.shape[1], BWD_SEQ_CHUNK)
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w)
    with torch.enable_grad():
        wd = w.detach().requires_grad_(True)
        for i in range(0, x.shape[1], c):
            xc = x[:, i:i + c].detach().requires_grad_(True)
            out = fn(xc, wd, targets[:, i:i + c], softcap=softcap)
            gx, gw = torch.autograd.grad(out if isinstance(out, tuple) else (out,), (xc, wd),
                                         tuple(g[:, i:i + c] for g in grads))
            dx[:, i:i + c] = gx
            dw += gw
    return dx, dw


def _forward(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
             softcap: float) -> torch.Tensor:
    """(B, S) CE (inside the Function's forward, so without a graph): K6 on
    the card, the plain sequence-chunked form on the CPU."""
    if x.device.type == "cuda":
        B, S, D = x.shape
        out = kernel.fused_xent_fwd(x.reshape(B * S, D).contiguous(), w.contiguous(),
                                    targets.reshape(-1).to(torch.int32).contiguous(),
                                    softcap=softcap)
        return out.reshape(B, S)
    if x.device.type == "cpu":
        return ref.seq_chunked_xent(x, w, targets, chunk=BWD_SEQ_CHUNK, softcap=softcap)
    raise ValueError(f"fused_xent: no implementation for {x.device}")


class FusedXent(torch.autograd.Function):
    """Per-token CE (B, S) of f32 x (B, S, D) and w (V, D); gradients for x
    and w.  Forward K6 (its plain version on the CPU), backward the
    sequence-chunked plain VJP."""

    @staticmethod
    def forward(ctx, x, w, targets, softcap: float):
        ctx.softcap = softcap
        ctx.save_for_backward(x, w, targets)
        return _forward(x, w, targets, softcap)

    @staticmethod
    def backward(ctx, g):
        x, w, targets = ctx.saved_tensors
        dx, dw = _chunked_vjp(ref.naive_xent, x, w, targets, ctx.softcap, (g,))
        return dx, dw, None, None


def _part_forward(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                  softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's (lse, t), each (B, S) (inside the Function's forward):
    K6's partial form on the card, the plain block form on the CPU."""
    if x.device.type == "cuda":
        B, S, D = x.shape
        lse, t = kernel.fused_xent_part(x.reshape(B * S, D).contiguous(), w.contiguous(),
                                        targets.reshape(-1).to(torch.int32).contiguous(),
                                        softcap=softcap)
        return lse.reshape(B, S), t.reshape(B, S)
    if x.device.type == "cpu":
        return ref.xent_block_ref(x, w, targets, 0, softcap=softcap, chunk=BWD_SEQ_CHUNK)
    raise ValueError(f"xent_part: no implementation for {x.device}")


class XentPart(torch.autograd.Function):
    """One vocab block of a split unembedding: (lse, t), each (B, S) f32, of
    f32 x (B, S, D) and the block ``w`` (V_block, D), with block-local
    targets (the targets less the block's first id; t is 0 where the block
    does not hold the target); gradients for x and the block.  Forward K6's
    partial form (its plain version on the CPU), backward the plain VJP of
    the block form recomputed one sequence chunk of ``BWD_SEQ_CHUNK`` at a
    time: dlogits = softmax_block · g_lse + onehot_block · g_t, through the
    softcap's derivative.  Neither pass holds (B, S, V_block)."""

    @staticmethod
    def forward(ctx, x, w, targets, softcap: float):
        ctx.softcap = softcap
        ctx.save_for_backward(x, w, targets)
        return _part_forward(x, w, targets, softcap)

    @staticmethod
    def backward(ctx, g_lse, g_t):
        x, w, targets = ctx.saved_tensors
        dx, dw = _chunked_vjp(ref.naive_xent_block, x, w, targets, ctx.softcap, (g_lse, g_t))
        return dx, dw, None, None


def xent_part(x: torch.Tensor,  # (B, S, D)
              w_block: torch.Tensor,  # (V_block, D)
              targets_local: torch.Tensor,  # (B, S) int, the targets less the block's first id
              *, softcap: float = 0.0, form: str = "seq_chunked",
              compute_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One vocab block's (lse, t), each (B, S) f32, for a cross-entropy over
    a vocab split into blocks: CE = logsumexp over the blocks' lse - the sum
    of their t.  ``form`` means per block what it means for the whole table
    (``LocalOps.xent``) on any device: ``"naive"`` materializes the block's
    logits from x and the block in ``compute_dtype``; ``"chunked"`` and
    ``"seq_chunked"`` run :class:`XentPart` (K6's partial form on the card,
    its plain block form on the CPU)."""
    if form not in ("naive", "chunked", "seq_chunked"):
        raise ValueError(f"xent_part: unknown form {form!r}")
    if form == "naive":
        return ref.naive_xent_block(x.to(compute_dtype), w_block.to(compute_dtype),
                                    targets_local, softcap=softcap)
    return XentPart.apply(x.float(), w_block.float(), targets_local, float(softcap))


def plain_xent(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, *,
               softcap: float = 0.0, form: str = "seq_chunked", chunk: int = 8192,
               seq_chunk: int = 256) -> torch.Tensor:
    """The plain form on any device: ``form="chunked"`` streams vocab chunks
    of ``chunk``, ``"seq_chunked"`` sequence chunks of ``seq_chunk``."""
    if form == "chunked":
        return ref.chunked_xent(x, w, targets, chunk=chunk, softcap=softcap)
    if form == "seq_chunked":
        return ref.seq_chunked_xent(x, w, targets, chunk=seq_chunk, softcap=softcap)
    raise ValueError(f"fused_xent: unknown form {form!r}")


def fused_xent(x: torch.Tensor,  # (B, S, D)
               w: torch.Tensor,  # (V, D)
               targets: torch.Tensor,  # (B, S) int
               *, softcap: float = 0.0, form: str = "seq_chunked", chunk: int = 8192,
               seq_chunk: int = 256) -> torch.Tensor:
    """Per-token CE (B, S) f32 without materializing the logits.  On the
    CPU, ``form``/``chunk``/``seq_chunk`` pick the plain form (see
    :func:`plain_xent`); on the card every form is K6."""
    x, w = x.float(), w.float()
    if x.device.type == "cpu":
        return plain_xent(x, w, targets, softcap=softcap, form=form, chunk=chunk,
                          seq_chunk=seq_chunk)
    if x.device.type == "cuda":
        return FusedXent.apply(x, w, targets, float(softcap))
    raise ValueError(f"fused_xent: no implementation for {x.device}")
