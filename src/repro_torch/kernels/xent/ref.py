"""K6's plain versions: per-token cross-entropy, naive and chunked.

The port's counterparts of ``repro/kernels/xent/ref.py``: per token,
``logsumexp(x·Wᵀ) − (x·Wᵀ)[target]``, optionally with the logits
tanh-softcapped.  The chunked forms hold one logits slab at a time — a
vocab chunk (``chunked_xent``) or a sequence chunk (``seq_chunked_xent``)
— and recompute it per chunk in the backward pass
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``), so
autograd does not keep every chunk's slab alive.  All three compute in f32
on f32 inputs.  :func:`xent_block_ref` is the plain version of K6's partial
form: one vocab block's (log-sum-exp, target logit), for a vocab split over
model coordinates.

Beside them, :func:`xent_3xtf32` models K6's own arithmetic on the tensor
cores (``csrc/xent_fwd.cu``): each f32 operand split into two TF32 parts,
three TF32 products a slice of 8 along D, summed in f32 a stage of 64 at a
time.  It is a model of
the kernel's rounding, held to the kernel's gate on the CPU before the
kernel runs, not a plain version of the function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
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


def naive_xent_block(x: torch.Tensor, w_block: torch.Tensor,
                     targets_local: torch.Tensor, softcap: float = 0.0):
    """One vocab block's share of the CE, materializing (B, S, V_block):
    (lse, t), each (B, S) f32, the block's log-sum-exp of the (softcapped)
    logits and the target logit, 0 where ``targets_local`` (the targets less
    the block's first id) falls outside the block."""
    logits = _cap(torch.einsum("bsd,vd->bsv", x, w_block).float(), softcap)
    lse = torch.logsumexp(logits, dim=-1)
    loc = targets_local.long()
    inside = (loc >= 0) & (loc < w_block.shape[0])
    hit = torch.gather(logits, -1, loc.clamp(0, w_block.shape[0] - 1)[..., None])[..., 0]
    return lse, torch.where(inside, hit, torch.zeros_like(hit))


def xent_block_ref(x: torch.Tensor,  # (B, S, D) f32
                   w_block: torch.Tensor,  # (V_block, D) f32: rows [v0, v0 + V_block)
                   targets: torch.Tensor,  # (B, S) int, global ids
                   v0: int, softcap: float = 0.0, chunk: int = 256):
    """K6's partial form's plain version: :func:`naive_xent_block` of the
    block that starts at vocab id ``v0``, streamed over sequence chunks as
    :func:`seq_chunked_xent` streams them.  The CE over the blocks of a
    vocab is ``logsumexp(stack(lse)) - sum(t)``."""
    S = x.shape[1]
    c = seq_chunk_for(S, chunk)
    local = targets.long() - v0
    parts = [checkpoint(naive_xent_block, x[:, i:i + c], w_block, local[:, i:i + c], softcap,
                        use_reentrant=False) for i in range(0, S, c)]
    return (torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1))


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the nearest
    value with 10 mantissa bits, ties away from zero (half a unit of the
    13 dropped bits added to the magnitude, then the bits cut).  f32 in,
    f32 out."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(a: torch.Tensor):
    """(hi, lo): hi = tf32(a), lo = tf32(a - hi); a - hi is exact in f32,
    and hi + lo is a to about 2^-22 of |a|."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a.float() - hi)


def _round_toward_zero(t: torch.Tensor) -> torch.Tensor:
    """f64 → the f32 next to it toward zero."""
    y = t.float()
    return torch.where(y.double().abs() > t.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def logits_3xtf32(x: torch.Tensor, w: torch.Tensor, k: int = 8, stage: int = 64,
                  truncate: bool = False) -> torch.Tensor:
    """x (N, D) · w (V, D)ᵀ as K6 sums it.  D runs in stages of ``stage``
    (the last zero-padded); a stage's partial starts from zero and adds, per
    slice of ``k`` in order, x_lo·w_hi, then x_hi·w_lo, then x_hi·w_hi, each
    a k-term product of TF32 parts (x_lo·w_lo, under 2^-22 of a product, is
    dropped); each stage's partial is then added to the f32 total, rounded
    to nearest.  Each slice's sum into the partial rounds to nearest in f32,
    or, with ``truncate``, is taken exactly and cut toward zero, as the
    tensor cores' accumulation behaves on the card (``PERF.md``).  Returns
    (N, V) f32."""
    N, D = x.shape
    pad = -D % stage
    xh, xl = (F.pad(t, (0, pad)) for t in split_tf32(x))
    wh, wl = (F.pad(t, (0, pad)).T.contiguous() for t in split_tf32(w))
    if truncate:
        xh, xl, wh, wl = (t.double() for t in (xh, xl, wh, wl))
    acc = torch.zeros((N, w.shape[0]), dtype=torch.float32)
    for d0 in range(0, D + pad, stage):
        part = torch.zeros_like(acc)
        for d in range(d0, d0 + stage, k):
            sl = slice(d, d + k)
            for a, b in ((xl, wh), (xh, wl), (xh, wh)):
                if truncate:
                    part = _round_toward_zero(part.double() + a[:, sl] @ b[sl])
                else:
                    part = part + a[:, sl] @ b[sl]
        acc = acc + part
    return acc


def xent_3xtf32(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                softcap: float = 0.0, vocab_chunk: int = 4096, **model) -> torch.Tensor:
    """Per-token CE from :func:`logits_3xtf32` logits (``model``: its
    ``stage`` and ``truncate``), softcapped and reduced in f32, computed a
    vocab chunk at a time on the CPU.  x (N, D), w (V, D) f32, targets (N,)
    int.  Returns (N,) f32."""
    x, w = x.float().cpu(), w.float().cpu()
    tgt = targets.long().cpu()
    m = torch.full((x.shape[0],), -torch.inf)
    s = torch.zeros(x.shape[0])
    t = torch.zeros(x.shape[0])
    for base in range(0, w.shape[0], vocab_chunk):
        logits = _cap(logits_3xtf32(x, w[base:base + vocab_chunk], **model), softcap)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[:, None]).sum(dim=-1)
        m = new_m
        loc = tgt - base
        hit = (loc >= 0) & (loc < logits.shape[1])
        t = torch.where(hit, logits.gather(1, loc.clamp(0, logits.shape[1] - 1)[:, None])[:, 0], t)
    return m + torch.log(s) - t
