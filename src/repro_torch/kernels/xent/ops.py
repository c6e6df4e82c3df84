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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.xent import kernel, ref

BWD_SEQ_CHUNK = 256  # the reference's _bwd: seq_chunked_xent's default chunk


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
        c = ref.seq_chunk_for(x.shape[1], BWD_SEQ_CHUNK)
        dx = torch.empty_like(x)
        dw = torch.zeros_like(w)
        with torch.enable_grad():
            wd = w.detach().requires_grad_(True)
            for i in range(0, x.shape[1], c):
                xc = x[:, i:i + c].detach().requires_grad_(True)
                ce = ref.naive_xent(xc, wd, targets[:, i:i + c], softcap=ctx.softcap)
                gx, gw = torch.autograd.grad(ce, (xc, wd), g[:, i:i + c])
                dx[:, i:i + c] = gx
                dw += gw
        return dx, dw, None, None


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
