"""K6's plain versions: per-token cross-entropy, naive and chunked.

The port's counterparts of ``repro/kernels/xent/ref.py``: per token,
``logsumexp(x·Wᵀ) − (x·Wᵀ)[target]``, optionally with the logits
tanh-softcapped.  The chunked forms hold one logits slab at a time — a
vocab chunk (``chunked_xent``) or a sequence chunk (``seq_chunked_xent``)
— and recompute it per chunk in the backward pass
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``), so
autograd does not keep every chunk's slab alive.  All three compute in f32
on f32 inputs.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _cap(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    return torch.tanh(logits / softcap) * softcap if softcap else logits


def naive_xent(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
               softcap: float = 0.0) -> torch.Tensor:
    """Materializes (B, S, V): the baseline the chunked forms are held to."""
    logits = _cap(torch.einsum("bsd,vd->bsv", x, w).float(), softcap)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - tgt


def _vocab_chunk(m, s, t, x, w_blk, targets, base: int, softcap: float):
    """Fold one vocab chunk into the running (max, sumexp, target logit)."""
    logits = _cap(torch.einsum("bsd,cd->bsc", x, w_blk).float(), softcap)
    new_m = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[..., None]).sum(dim=-1)
    c = w_blk.shape[0]
    loc = targets.long() - base
    hit = torch.gather(logits, -1, loc.clamp(0, c - 1)[..., None])[..., 0]
    t = torch.where((loc >= 0) & (loc < c), hit, t)
    return new_m, s, t


def chunked_xent(x: torch.Tensor,  # (B, S, D) f32
                 w: torch.Tensor,  # (V, D) f32
                 targets: torch.Tensor,  # (B, S) int
                 chunk: int = 8192, softcap: float = 0.0) -> torch.Tensor:
    """Per-token CE streaming over vocab chunks.  Returns (B, S) f32.

    The last chunk is the vocab's tail, shorter, where the reference pads
    ``w`` and masks the padding to ``-inf``: the same values."""
    B, S, _ = x.shape
    V = w.shape[0]
    chunk = min(chunk, V)
    m = torch.full((B, S), -torch.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    t = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for base in range(0, V, chunk):
        m, s, t = checkpoint(_vocab_chunk, m, s, t, x, w[base:base + chunk], targets,
                             base, softcap, use_reentrant=False)
    return m + torch.log(s) - t


def seq_chunk_for(S: int, chunk: int) -> int:
    """The largest divisor of ``S`` not above ``chunk`` (the reference's rule)."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def seq_chunked_xent(x: torch.Tensor,  # (B, S, D) f32
                     w: torch.Tensor,  # (V, D) f32
                     targets: torch.Tensor,  # (B, S) int
                     chunk: int = 256, softcap: float = 0.0) -> torch.Tensor:
    """Per-token CE streaming over sequence chunks of the largest divisor of
    S not above ``chunk``: one (B, chunk, V) logits slab at a time."""
    S = x.shape[1]
    c = seq_chunk_for(S, chunk)
    return torch.cat([checkpoint(naive_xent, x[:, i:i + c], w, targets[:, i:i + c], softcap,
                                 use_reentrant=False)
                      for i in range(0, S, c)], dim=1)
