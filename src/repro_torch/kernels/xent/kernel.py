"""K6's launch: checks, output and scratch allocation, the split count and
the ``K6_LAUNCHES`` counter.

The port's counterpart of ``repro/kernels/xent/kernel.py::fused_xent_fwd``
(``pallas_call`` at ``kernel.py:84``), launching ``csrc/xent_fwd.cu``, and
its partial form on one vocab block (:func:`fused_xent_part`, the sharded
train step's vocab-split loss).  Unlike the TPU entry point it takes any N (no block divisor) and never pads
or copies ``w``: the kernel masks the vocab tail itself.  One call is one
launch: the splits of the vocab are merged inside the kernel by the last
CTA of each token block.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.conv_pool.kernel import LaunchCounter

K6_LAUNCHES = LaunchCounter()
TOKENS_PER_CTA = 128  # csrc/xent_fwd.cu kBN
VOCAB_PER_TILE = 128  # csrc/xent_fwd.cu kBV
CTAS_PER_SM = 1  # the kernel's __launch_bounds__ minimum


def split_count(N: int, V: int, sm_count: int) -> int:
    """Vocab splits per token block: as many as fill the card's resident CTA
    slots (``CTAS_PER_SM`` a SM) in one wave, at least 1, at most one vocab
    tile each."""
    token_blocks = -(-N // TOKENS_PER_CTA)
    tiles = -(-V // VOCAB_PER_TILE)
    return max(1, min(tiles, CTAS_PER_SM * sm_count // token_blocks))


def _check(name: str, x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor) -> None:
    """The arguments both entries take: x (N, D) and w (V, D) contiguous f32
    on one CUDA device, targets (N,) contiguous int32 there."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {x.device}")
    if x.ndim != 2 or w.ndim != 2 or targets.ndim != 1:
        raise ValueError(f"{name}: x must be (N, D), w (V, D), targets (N,)")
    N, D = x.shape
    V = w.shape[0]
    if w.shape[1] != D or targets.shape[0] != N:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"targets {tuple(targets.shape)}")
    if D < 1 or V < 1:
        raise ValueError(f"{name}: D={D} and V={V} must be positive")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{name}: x and w must be f32, got {x.dtype}, {w.dtype}")
    if targets.dtype != torch.int32:
        raise TypeError(f"{name}: targets must be int32, got {targets.dtype}")
    for arg, t in (("x", x), ("w", w), ("targets", targets)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {x.device}")


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
            outs, softcap: float, splits: Optional[int]) -> None:
    """One launch of ``csrc/xent_fwd.cu``'s ``entry`` writing ``outs``
    (each (N,) f32), counted on ``K6_LAUNCHES`` under the entry's name."""
    N, D = x.shape
    V = w.shape[0]
    fn = getattr(build.load("xent_fwd"), entry)
    if splits is None:
        splits = split_count(N, V, torch.cuda.get_device_properties(x.device)
                             .multi_processor_count)
    if not 1 <= splits <= -(-V // VOCAB_PER_TILE):
        raise ValueError(f"{entry}: {splits} splits for {V} vocab rows")
    part = torch.empty((3 * splits * N,), dtype=torch.float32, device=x.device)
    tickets = torch.zeros((-(-N // TOKENS_PER_CTA),), dtype=torch.int32, device=x.device)
    ptr = ctypes.c_void_p
    args = [ptr(t.data_ptr()) for t in (x, w, targets, *outs, part, tickets)]
    args += [ctypes.c_int(n) for n in (N, D, V, splits)]
    args += [ctypes.c_float(softcap), ptr(torch.cuda.current_stream(x.device).cuda_stream)]
    fn.restype = ctypes.c_int
    fn.argtypes = [type(a) for a in args]
    build.check(fn(*args), entry)
    K6_LAUNCHES.add((entry, N, D, V, splits, float(softcap)))


def fused_xent_fwd(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, *,
                   softcap: float = 0.0, splits: Optional[int] = None) -> torch.Tensor:
    """K6 on the card: x (N, D) and w (V, D) contiguous f32, targets (N,)
    contiguous int32 in [0, V).  Returns the per-token CE (N,) f32.
    ``splits`` (default: :func:`split_count`) only changes how the vocab is
    spread over CTAs.  Raises on anything the kernel does not take; never
    falls back."""
    _check("fused_xent_fwd", x, w, targets)
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        _launch("xent_fwd_f32", x, w, targets, (out,), softcap, splits)
    return out


def fused_xent_part(x: torch.Tensor, w_block: torch.Tensor, targets_local: torch.Tensor, *,
                    softcap: float = 0.0,
                    splits: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's partial form on one vocab block of a split unembedding: x (N, D)
    and ``w_block`` (V_block, D) contiguous f32, ``targets_local`` (N,)
    contiguous int32, the targets less the block's first id (any value: one
    outside [0, V_block) is not in the block).  Returns (lse, t), each (N,)
    f32: the block's log-sum-exp of the (softcapped) logits, and the target
    logit, 0 where the block does not hold the target.  The blocks' CE is
    ``logsumexp(lse over blocks) - sum(t over blocks)``.  One launch a call,
    checked as :func:`fused_xent_fwd`; never falls back."""
    _check("fused_xent_part", x, w_block, targets_local)
    lse = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    t = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        _launch("xent_part_f32", x, w_block, targets_local, (lse, t), softcap, splits)
    return lse, t
