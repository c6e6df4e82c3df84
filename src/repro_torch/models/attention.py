"""GQA attention: causal / sliding-window / encoder / cross, prefill +
decode, with a float or an int8 KV cache.

The port's counterpart of ``repro/models/attention.py``.  Every attention
over more than one query row goes through
:func:`repro_torch.kernels.flash.ops.flash_attention`: K5 on the card, its
plain version on the CPU.  That covers the causal kinds, the encoder
(:func:`encoder_kv` and :func:`attend_encoder_span`, a span of the frames
over every frame's K/V) and the decoder's cross-attention over the
encoder's memory (:func:`attend_cross`), the last two with
``causal=False``; the reference
sends only the causal kinds to its flash kernel and computes the other two
with ``_sdpa_ref``, which is the same function.  Decode attention
(:func:`attend_decode`, and :func:`attend_cross` at one query row) runs
outside any kernel in the reference too and stays plain PyTorch here.

The KV cache for windowed layers is a ring buffer of exactly ``window``
slots with absolute-position tracking, as in the reference.  A quantized
cache (``init_kv_cache(quantized=True)``) holds int8 K/V with one f32 scale
per (row, slot, KV head), as the reference's ``kv_dtype="int8"`` does.

Two reference quirks, kept: ``attend_train`` in the reference calls flash
without ``cfg.attn_softcap`` (``attention.py:126``) while its ``ref`` path
applies it; the port passes ``cfg.attn_softcap`` to K5, matching the
reference's default ``ref`` path.  And ``_sdpa_ref`` casts the softmax
weights to ``q.dtype`` before the PV product, where K5 keeps them in f32, so
in bf16 the two are not bit-equal.

Two more, from the reference's cross-attention: its params have no q/k/v
bias even when ``cfg.attn_bias`` is set, and it applies neither RoPE, nor a
softcap, nor a memory mask (``attention.py:38,133-145``), so utterances of
different lengths padded into one batch attend to the padding.

Qwen2-VL's M-RoPE (``cfg.mrope_sections``) runs as the reference runs it:
the (B, S) positions broadcast into three equal (t, h, w) streams, so on
every path it computes RoPE's angles (``_rope``, reference
``attention.py:57-64``).

The q/k/v and output projections are products with no batch dimension.
They are written as matmuls over the flattened weights, which reach
``aten.mm`` (an einsum reaches ``aten.bmm`` with a batch of one), so that
``remat_policy="dots"`` saves them as the reference's
``dots_with_no_batch_dims_saveable`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models.common import apply_mrope, apply_rope, cdt, dense_init, pdt

NEG_INF = -2.3819763e38  # large negative for masked logits (bf16-safe)


def init_attn_params(cfg, gen: torch.Generator, device, cross: bool = False) -> dict:
    """wq/wk/wv/wo, and q/k/v biases under ``cfg.attn_bias`` unless ``cross``."""
    d, H, K, h = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, H, h), pdt(cfg), device, fan_in=d),
        "wk": dense_init(gen, (d, K, h), pdt(cfg), device, fan_in=d),
        "wv": dense_init(gen, (d, K, h), pdt(cfg), device, fan_in=d),
        "wo": dense_init(gen, (H, h, d), pdt(cfg), device, fan_in=H * h),
    }
    if cfg.attn_bias and not cross:
        p["bq"] = torch.zeros((H, h), dtype=pdt(cfg), device=device)
        p["bk"] = torch.zeros((K, h), dtype=pdt(cfg), device=device)
        p["bv"] = torch.zeros((K, h), dtype=pdt(cfg), device=device)
    return p


def _project(cfg, p, x: torch.Tensor, name: str) -> torch.Tensor:
    """One of the q / k / v projections (``name`` "q", "k" or "v"), its
    bias added where the params have one: (B, S, D) @ (D, n, h) → (B, S,
    n, h), one aten.mm."""
    cd = cdt(cfg)
    w = p["w" + name]
    y = (x.to(cd) @ w.to(cd).reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    return y + p["b" + name].to(cd) if "b" + name in p else y


def _project_qkv(cfg, p, xq: torch.Tensor, xkv: torch.Tensor):
    return _project(cfg, p, xq, "q"), _project(cfg, p, xkv, "k"), _project(cfg, p, xkv, "v")


def _rope(cfg, x, positions, kind: str):
    if cfg.mrope_sections:
        pos3 = positions[None].expand(3, *positions.shape)
        return apply_mrope(x, pos3, cfg.rope_theta, cfg.mrope_sections)
    theta = cfg.rope_theta
    if kind == "attn" and cfg.rope_theta_global:
        theta = cfg.rope_theta_global  # gemma3: global layers use 1M theta
    return apply_rope(x, positions, theta)


def _sdpa_ref(q: torch.Tensor,  # (B,S,H,h)
              k: torch.Tensor,  # (B,T,K,h)
              v: torch.Tensor,  # (B,T,K,h)
              mask: Optional[torch.Tensor],  # (B|1,1,S,T) bool; True = attend
              scale: float, softcap: float = 0.0) -> torch.Tensor:
    B, S, H, h = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, h)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, NEG_INF)  # (B,K,G,S,T)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, h)


def _causal_mask(S: int, T: int, device, offset: int = 0) -> torch.Tensor:
    """(1,1,S,T) causal mask; query i attends key j iff j <= i + offset."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    return (kj <= qi + offset)[None, None]


def _window_mask(S: int, T: int, window: int, device, offset: int = 0) -> torch.Tensor:
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    return ((kj <= qi + offset) & (kj > qi + offset - window))[None, None]


def _window(cfg, kind: str) -> int:
    return cfg.window if kind in ("swa", "local") else 0


def _out_proj(cfg, p, out: torch.Tensor) -> torch.Tensor:
    cd = cdt(cfg)
    wo = p["wo"].to(cd)
    return out.to(cd).flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def attend_prefill(cfg, p: dict, x: torch.Tensor, kind: str, positions: torch.Tensor,
                   prefix=None, q_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention over a whole prompt, through K5; returns (y, k, v)
    with k after RoPE, the values a KV cache holds (the reference projects
    them a second time in ``_prefill_cache``; the numbers are the same).
    The causal kinds ``attn``, ``swa`` and ``local`` (the encoder's runs
    through :func:`attend_encoder_span`).

    A data row's span of a sequence split over the data axes starts at
    position ``q_offset`` and reads ``prefix``, the (k, v) of the positions
    before it (the rows before computed them): its queries run K5 with
    ``q_offset`` over the prefix and its own keys, and the k, v returned are
    both, positions 0 up to the span's end."""
    if kind not in ("attn", "swa", "local"):
        raise ValueError(f"unknown attention kind {kind!r}")
    q, k, v = _project_qkv(cfg, p, x, x)
    q = _rope(cfg, q, positions, kind)
    k = _rope(cfg, k, positions, kind)
    if prefix is not None:
        k, v = torch.cat([prefix[0], k], dim=1), torch.cat([prefix[1], v], dim=1)
    out = flash_ops.flash_attention(q, k, v, causal=True, window=_window(cfg, kind),
                                    scale=1.0 / np.sqrt(cfg.head_dim),
                                    softcap=cfg.attn_softcap, q_offset=q_offset)
    return _out_proj(cfg, p, out), k, v


def attend_train(cfg, p: dict, x: torch.Tensor, kind: str,
                 positions: torch.Tensor) -> torch.Tensor:
    """Self-attention over a full sequence (training, prefill), through K5."""
    return attend_prefill(cfg, p, x, kind, positions)[0]


def encoder_kv(cfg, p: dict, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's K (after RoPE at ``positions``) and V of ``x``: on a
    data row's span of the frames, the first half of the layer's attention
    (:func:`attend_encoder_span` reads every row's)."""
    return _rope(cfg, _project(cfg, p, x, "k"), positions, "enc"), _project(cfg, p, x, "v")


def encoder_queries(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The encoder's queries of ``x``, after RoPE at ``positions``."""
    return _rope(cfg, _project(cfg, p, x, "q"), positions, "enc")


def attend_encoder_span(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The encoder's attention of a span of the frames (``x`` at
    ``positions``) over ``k`` / ``v`` of every frame (:func:`encoder_kv` of
    each span, joined in order), through K5 without the mask.  The query
    offset stays 0: an unmasked call reads every key whatever its queries'
    positions."""
    out = flash_ops.flash_attention(encoder_queries(cfg, p, x, positions), k, v, causal=False,
                                    window=0, scale=1.0 / np.sqrt(cfg.head_dim),
                                    softcap=cfg.attn_softcap)
    return _out_proj(cfg, p, out)


def attend_cross(cfg, p: dict, x: torch.Tensor,  # (B, S, D) decoder side
                 memory: torch.Tensor,  # (B, T, D) encoder output
                 ) -> torch.Tensor:
    """The decoder's attention over the encoder's memory: q from ``x``, k/v
    from ``memory``, no RoPE, no mask, no softcap (reference
    ``attention.py:133-145``).  More than one query row goes through K5
    (``causal=False``, S != T); one row, a decode step, through the plain
    ``_sdpa_ref``, as :func:`attend_decode` does."""
    q, k, v = _project_qkv(cfg, p, x, memory)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    if x.shape[1] > 1:
        out = flash_ops.flash_attention(q, k, v, causal=False, window=0, scale=scale)
    else:
        out = _sdpa_ref(q, k, v, None, scale)
    return _out_proj(cfg, p, out)


# ----------------------------------------------------------------------------
# Decode path with KV cache
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Per-layer cache geometry.  Windowed layers get a ring buffer."""

    length: int  # slots (== window for swa/local, == max_seq for global)
    ring: bool


def cache_spec(cfg, kind: str, max_seq: int) -> KVCacheSpec:
    if kind in ("swa", "local") and cfg.window and cfg.window < max_seq:
        return KVCacheSpec(length=cfg.window, ring=True)
    return KVCacheSpec(length=max_seq, ring=False)


def init_kv_cache(cfg, spec: KVCacheSpec, batch: int, dtype, device,
                  quantized: bool = False) -> dict:
    """K/V in ``dtype`` (``quantized``: int8 K/V and f32 ``k_scale`` /
    ``v_scale`` per (row, slot, KV head)) and the absolute position of each
    slot (-1 = empty)."""
    K, h = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, spec.length, K, h)
    cache = {"pos": torch.full((batch, spec.length), -1, dtype=torch.int32, device=device)}
    if quantized:
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _quantize_heads(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, K, h) → (int8 values, f32 scale per (B, S, K)): absmax / 127
    with a floor of 1e-8, rounded half to even, clipped to ±127."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _write_slots(cache: dict, index, k: torch.Tensor, v: torch.Tensor) -> None:
    """``cache[name][index] = value`` for K and V, quantizing them (and
    writing their scales) in an int8 cache."""
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = _quantize_heads(k), _quantize_heads(v)
        cache["k"][index], cache["k_scale"][index] = kq, ks
        cache["v"][index], cache["v_scale"][index] = vq, vs
    else:
        cache["k"][index] = k.to(cache["k"].dtype)
        cache["v"][index] = v.to(cache["v"].dtype)


def fill_kv_cache(cache: dict, spec: KVCacheSpec, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, first: int = 0) -> dict:
    """Write a prompt's K/V (B, S, K, h) into a fresh cache, in place: a ring
    keeps the last ``length`` positions at their slots, a linear cache the
    prompt in its first S slots.  An int8 cache stores them quantized, and
    its slots past the prompt take the scale the reference's quantization of
    its zero padding gives, the floor 1e-8 (``transformer.py:179-182``).
    ``first``: the prompt's first position, past 0 for a data row's span of
    a sequence split over the data axes (the rows before filled the slots
    of the positions before it)."""
    S = k.shape[1]
    if spec.ring and (S >= spec.length or first):
        keep = slice(max(0, S - spec.length), S)
        slots = (positions[0, keep] % spec.length).long()
        _write_slots(cache, (slice(None), slots), k[:, keep], v[:, keep])
        cache["pos"][:, slots] = positions[:, keep].to(torch.int32)
    else:
        _write_slots(cache, (slice(None), slice(first, first + S)), k, v)
        cache["pos"][:, first:first + S] = positions.to(torch.int32)
        if "k_scale" in cache:
            cache["k_scale"][:, first + S:] = 1e-8
            cache["v_scale"][:, first + S:] = 1e-8
    return cache


def attend_decode(cfg, p: dict, x: torch.Tensor,  # (B,1,D) current token
                  cache: dict, kind: str,
                  pos: torch.Tensor,  # (B,) int32, per-row absolute positions
                  spec: KVCacheSpec) -> Tuple[torch.Tensor, dict]:
    """One decode step: write this token's K/V into the ring/linear cache
    (in place: the cache is not copied each step) and attend over it.  An
    int8 cache takes the token quantized and is read dequantized in the
    compute dtype (reference ``attention.py:213-221``).  Positions are per
    batch row (serving lanes decode at different depths).  Returns (y,
    cache)."""
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, x)
    positions = pos[:, None].to(torch.int32)  # (B,1)
    q = _rope(cfg, q, positions, kind)
    k = _rope(cfg, k, positions, kind)

    slot = (pos % spec.length if spec.ring else pos).long()  # (B,)
    rows = torch.arange(B, device=x.device)
    _write_slots(cache, (rows, slot), k[:, 0], v[:, 0])
    cpos = cache["pos"]
    cpos[rows, slot] = pos.to(torch.int32)
    ck, cv = cache["k"], cache["v"]
    if "k_scale" in cache:
        ck = ck.to(k.dtype) * cache["k_scale"][..., None].to(k.dtype)
        cv = cv.to(v.dtype) * cache["v_scale"][..., None].to(v.dtype)

    # Valid slots: filled, causal, and (for windows) within the window.
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if kind in ("swa", "local") and cfg.window:
        valid &= cpos > pos[:, None] - cfg.window
    mask = valid[:, None, None, :]  # (B,1,1,T)

    out = _sdpa_ref(q, ck, cv, mask, 1.0 / np.sqrt(cfg.head_dim), cfg.attn_softcap)
    return _out_proj(cfg, p, out), cache
