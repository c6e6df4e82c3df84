"""Tensor-parallel sub-blocks on a ("data", "model") mesh.

The port's counterpart of what GSPMD does for the reference's sharded
steps (``repro/train/step.py:80-110``, ``repro/serve/step.py:165-220``):
each layer's sub-block runs on every model coordinate of a data row from
that coordinate's own blocks (:meth:`repro_torch.sharding.placement.
Placed.shard`, no copy), each under ``device.current`` of its device, and
the partial outputs come back to the row's device (the device of its
first model coordinate).  The model's own layer walks (``Model.train_loss``
and ``Model.prefill`` / ``decode_step`` / ``encode``) call them through
:class:`RowOps`, one data row at a time.  In training every operation is
differentiable with respect to the blocks it reads (:func:`row_tensors`),
so autograd hands each block its gradient on its own device; under remat
the non-reentrant ``checkpoint`` recomputes each coordinate's work inside
its own ``device.current``.  The splits are ``ShardingPolicy.param_spec``'s:

* **attention** (``attn``, ``swa``, ``local``, ``enc``, a decoder's
  ``cross``): ``wq`` / ``bq`` split on heads give each coordinate its q
  heads, ``wk`` / ``wv`` / ``bk`` / ``bv`` its KV heads (or all of them
  where ``"model"`` does not divide the KV heads: then each coordinate
  projects every KV head and takes the ones its q heads read, sliced or
  repeated so that the group is uniform), ``wo`` split on its head input.
  A coordinate applies RoPE / M-RoPE to its heads and runs K5 over them
  (prefill, the encoder, cross-attention over a memory) or the plain
  ``_sdpa_ref`` (decode), and its ``wo`` block gives a partial output;
* **the dense MLP and the MoE FFN**: ``wi`` / ``wg`` split on ``d_ff``,
  ``wo`` on its ``d_ff`` input (each expert's, and the shared expert's).
  The router and ``shared_gate`` are replicated and run once on the row's
  device, so every coordinate takes the same capacity, slots and drops,
  and the aux loss is computed there once (``moe.aux_loss``);
  ``combine`` and the shared expert's sigmoid gate are linear in the
  expert outputs, so the output is the sum of the partials;
* **the embedding and the unembedding** split on vocab: a token's row comes
  from the one coordinate whose range holds it, the others add zeros (the
  sum is bit-equal), and the logits are the concatenation of each
  coordinate's vocab slice.  The training loss (:func:`xent`) runs on each
  coordinate's vocab block (K6's partial form on the card, its plain block
  form on the CPU), which gives each token's log-sum-exp over the block and
  its target logit where the block holds the target; the blocks' pairs
  are combined on the row's device by log-sum-exp in coordinate order, as
  GSPMD's max / sum all-reduces combine the reference's vocab shards
  (``repro/kernels/xent/ref.py:72-91``), and the backward hands each block
  its gradient on its own device;
* **RWKV's time-mix** (:func:`time_mix`) split on heads: the token-shift
  inputs and the decay LoRA's hidden layer once on the row's device (they
  read replicated leaves alone), then each coordinate's heads from its
  blocks of ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``bonus_u`` and its channels
  of the replicated ``decay_w2`` / ``decay_base`` / ``gn_scale`` /
  ``gn_bias``: K7 over its heads (``wkv_step`` for one token), the group
  norm, its ``wo`` rows' partial;
* **RWKV's channel-mix** (:func:`channel_mix`): ``cm_wk`` / ``cm_wv``
  split on ``d_ff`` give partials, summed; ``cm_wr`` is split on its
  output columns, so the gate ``r`` is each coordinate's slice,
  concatenated, not summed;
* **the RG-LRU** (:func:`rglru`) split on its width: each coordinate's gate
  branch and causal conv from its blocks of ``w_gate`` / ``w_rec`` /
  ``conv_w``; ``w_a`` / ``w_x`` are split on their output columns and read
  every input channel, so ξ (an activation, not a leaf) is gathered to
  every coordinate in coordinate order; then each coordinate's gates, scan
  and ``w_out`` rows' partial.  The recurrent state (RWKV's ``s``, the
  RG-LRU's ``h`` and ``conv``) is read from and written to each
  coordinate's own block (:func:`own_block`, :class:`Blocks`); ``tm_x`` /
  ``cm_x`` are replicated and written to every holder.  Heads or a width
  that ``"model"`` does not divide run whole on the row's device: the
  policy then replicates their leaves and state, save RWKV's ``d_model``
  columns where ``"model"`` divides them and not the heads (those leaves
  are gathered at read);
* **norms and every other 1-D leaf** are replicated and read on the row's
  device.

**The KV cache on its shards** (``ShardingPolicy.cache_specs``,
:func:`cache_layout`): split on heads, each coordinate writes and reads
only its own block; split on length (over ``"model"``, or ``("data",
"model")`` at batch 1), the prefill writes each slot range into the block
that owns it, a decode step writes its slot into its owner's block only
(:func:`repro_torch.sharding.placement.write_slots`), and each block
gives the partial softmax ``(o, m, l)`` of every q head over its slots
(:func:`partial_softmax`), combined by log-sum-exp in slot order
(:func:`combine_partials`, the flash-decoding combine GSPMD inserts for
the reference; plain PyTorch, as the reference has no kernel for it).  A
cache split on neither is read whole from each coordinate's own copy.

**Sums.**  A coordinate's partial output is in the compute dtype (at bf16
its matmul has rounded it once); the partials are summed in f32 in
coordinate order on the row's device and cast to the compute dtype once,
so at one model coordinate the sum is the unsharded path's bits.  A
sub-block whose output projection is not split on its input (its heads or
``d_ff`` do not divide ``"model"``) is computed once, on the row's device,
and taken once.

**Sequence parallelism.**  A batch the specs split on the sequence (batch
1: ``P(None, dp)``) gives each data row a contiguous span of S / dp
positions (:func:`rows_over_sequence`, ``Row.span``), the rows in order,
each still split along ``"model"``: a coordinate joins the K/V of its KV
heads that the rows before computed (on their devices at its model index,
moved to its own) to its span's and runs K5 with the span's first position
as the query offset; RWKV and the RG-LRU start from the state the row
before left (:class:`Blocks` in training, the cache in serving), and the
MoE router from the carried slot counts
(:func:`repro_torch.models.moe.plan_span`).  An enc-dec config's frames
split the same way (the specs put ``src_embeds`` on ``P(None, dp, None)``),
each data row its own span of ``T / dp`` frames (:func:`encode_over_rows`):
the encoder sees every frame, so :meth:`repro_torch.models.transformer.Model.
encode_spans` goes layer by layer across the rows, first every row's K/V of
its span on each model coordinate (:func:`encoder_kv`), then every row's
queries over all rows' K/V joined on each coordinate's device
(:func:`attention_encode_rows`: K5 without the mask, one launch a layer a
coordinate a row), and the decoder's cross sub-blocks read the memory's
spans joined once on each device (:func:`memory_by_device`), as GSPMD
gathers the reference's.  A
sequence or a number of frames the data axes do not divide raises, as the
reference's jit does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import current
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.models import attention, griffin, mlp, moe, rwkv6
from repro_torch.models.common import cdt
from repro_torch.models.transformer import LocalOps, Span
from repro_torch.sharding import placement as pl

MODEL = "model"


# -- data rows ------------------------------------------------------------------


def data_rows(mesh, dp_axes: Sequence[str]) -> List[list]:
    """Each data coordinate's mesh coordinates (row-major, so in model
    order), data coordinates in the order the data axes number them."""
    dp = tuple(mesh.axis_names.index(a) for a in dp_axes if a in mesh.axis_names)
    sizes = [mesh.sizes[i] for i in dp]
    rows: Dict[int, list] = {}
    for c in mesh.coords():
        rows.setdefault(int(np.ravel_multi_index([c[i] for i in dp], sizes))
                        if dp else 0, []).append(tuple(c))
    return [rows[j] for j in sorted(rows)]


def splits_rows(batch_specs: Optional[dict], dp_axes: Sequence[str]) -> bool:
    """Whether ``batch_specs`` split the batch's rows over the data axes
    (else the batch runs whole on the first data row); raises if they
    disagree on the first axis."""
    from repro_torch.sharding.policy import is_spec

    specs = {k: v for k, v in (batch_specs or {}).items() if is_spec(v)}
    firsts = {tuple(pl.axes_of(s[0])) if len(s) else () for s in specs.values()}
    if len(firsts) > 1:
        raise ValueError(f"batch specs {specs} disagree on the batch axis")
    return bool(specs) and firsts == {tuple(dp_axes)}


def splits_sequence(batch_specs: Optional[dict], dp_axes: Sequence[str]) -> bool:
    """Whether ``batch_specs`` split the sequence (dim 1) over the data axes,
    the reference's sequence parallelism at ``global_batch <=
    seq_parallel_threshold``; raises if they disagree on that axis."""
    from repro_torch.sharding.policy import is_spec

    specs = {k: v for k, v in (batch_specs or {}).items() if is_spec(v)}
    seconds = {tuple(pl.axes_of(s[1])) if len(s) > 1 else () for s in specs.values()}
    if len(seconds) > 1:
        raise ValueError(f"batch specs {specs} disagree on the sequence axis")
    return bool(specs) and bool(dp_axes) and seconds == {tuple(dp_axes)}


@dataclasses.dataclass(frozen=True)
class Row:
    """One data row at work: its mesh coordinates in model order, their
    devices, the batch rows ``[rows[0], rows[1])`` it computes and, when the
    sequence is split over the data rows, its span of positions."""

    coords: Tuple[tuple, ...]
    devices: Tuple[torch.device, ...]
    rows: Tuple[int, int]
    span: Optional[Span] = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def rows_at_work(mesh, coords_by_row: List[list], batch: int, split: bool) -> List[Row]:
    """The rows that compute a batch of ``batch``: every data row, each on
    its contiguous equal slice, when ``split``; else the first, on all."""
    n = len(coords_by_row) if split else 1
    if batch % n:
        raise ValueError(f"a batch of {batch} does not split over {n} data rows")
    per = batch // n
    return [Row(tuple(cs), tuple(mesh.device(c) for c in cs), (j * per, (j + 1) * per))
            for j, cs in enumerate(coords_by_row[:n])]


def rows_over_sequence(mesh, coords_by_row: List[list], batch: int, seq: int) -> List[Row]:
    """The rows that compute a batch whose sequence the specs split: data
    row j the positions ``[j S / dp, (j + 1) S / dp)`` of every batch row.
    Raises when the data rows do not divide the sequence, as the
    reference's jit does."""
    n = len(coords_by_row)
    if seq % n:
        raise ValueError(f"a sequence of {seq} does not split over {n} data rows")
    per = seq // n
    return [Row(tuple(cs), tuple(mesh.device(c) for c in cs), (0, batch),
                Span(j * per, (j + 1) * per, seq))
            for j, cs in enumerate(coords_by_row)]


def span_of(x: torch.Tensor, row: Row) -> torch.Tensor:
    """The row's span of positions of a whole batch leaf (B, S, ...) on the
    row's device."""
    return x[:, row.span.start:row.span.stop].to(row.device)


def encode_over_rows(model, params, frames: torch.Tensor, mesh, coords_by_row: List[list],
                     remat: bool = False) -> List[torch.Tensor]:
    """The encoder of ``frames`` (B, T, D) split over the data rows, each
    its span of ``T / dp`` frames, layer by layer
    (:meth:`repro_torch.models.transformer.Model.encode_spans` with each
    row's :class:`RowOps`): the memory as the rows' spans, each on its
    row's device.  Raises when the data rows do not divide ``T``, as the
    reference's jit does."""
    rows = rows_over_sequence(mesh, coords_by_row, frames.shape[0], frames.shape[1])
    return model.encode_spans(params, [span_of(frames, r) for r in rows],
                              [r.span for r in rows], [RowOps(model.cfg, r) for r in rows],
                              remat=remat)


# -- reading blocks ---------------------------------------------------------------


def split_dim(x, axis: str = MODEL) -> Optional[int]:
    """The dimension of a placed leaf split over ``axis``, or None."""
    if not isinstance(x, pl.Placed):
        return None
    for i, e in enumerate(x.sharding.entries(x.ndim)):
        if axis in pl.axes_of(e):
            return i
    return None


def whole(x, row: Row) -> torch.Tensor:
    """``x`` whole on the row's device: the row's first coordinate's block
    when it is whole (no copy), else gathered from the blocks (the row's
    copies first).  A plain tensor is moved there."""
    if not isinstance(x, pl.Placed):
        return x.to(row.device)
    t = x.shard(row.coords[0])
    if t is not None and t.shape == x.shape:
        return t
    return pl.gather(x, row.device, row.coords)


def row_tensors(x: pl.Placed, row: Row) -> List[Tuple[Tuple[int, ...], torch.Tensor]]:
    """[(block, stored tensor)] of every tensor of ``x`` that the row's
    operations read, each once: each of its coordinates' own blocks
    (:meth:`Placed.shard`) and the copies a read whole takes
    (:func:`whole`, through ``pl.sources``).  The sharded train step asks
    for the gradient of each."""
    out, seen = [], set()
    held = [(x.sharding.block(c, x.ndim), x.shard(c)) for c in row.coords]
    for b, t in held + list(pl.sources(x, row.device, row.coords).items()):
        if b is not None and id(t) not in seen:
            seen.add(id(t))
            out.append((b, t))
    return out


def reader(tree, row: Row) -> pl.Reader:
    """A view of a dict of placed leaves that reads each whole on the row's
    device (:func:`whole`)."""
    return pl.Reader(tree, lambda v: whole(v, row) if isinstance(v, pl.Placed) else v)


def _local(p: dict, c) -> dict:
    """Coordinate ``c``'s blocks of a sub-block's leaves."""
    return {k: v.shard(c) for k, v in p.items() if isinstance(v, pl.Placed)}


def _workers(row: Row, split: bool):
    """(coordinate, device) of each coordinate that computes a sub-block:
    every one of the row when its output projection is split, else the
    first alone."""
    n = len(row.coords) if split else 1
    return list(zip(row.coords[:n], row.devices[:n]))


def sum_partials(parts: Sequence[torch.Tensor], device, dtype) -> torch.Tensor:
    """Σ parts in f32, in order, on ``device``, cast to ``dtype`` once."""
    acc = None
    for t in parts:
        t = t.to(device).float()
        acc = t if acc is None else acc + t
    return acc.to(dtype)


# -- embedding / unembedding ------------------------------------------------------


def lookup(table, tokens: torch.Tensor, row: Row) -> torch.Tensor:
    """``table[tokens]`` (tokens on the row's device) with the table split
    on vocab: each coordinate looks up the tokens in its range and zeros
    elsewhere; the partials sum to the rows bit for bit."""
    if split_dim(table) is None:
        return whole(table, row)[tokens.long()]
    parts = []
    for c, dev in zip(row.coords, row.devices):
        t = table.shard(c)
        v0, v1 = table.region_at(c)[0]
        with current(dev):
            tok = tokens.to(dev).long()
            inside = (tok >= v0) & (tok < v1)
            got = t[torch.clamp(tok - v0, 0, v1 - v0 - 1)]
            parts.append(torch.where(inside[..., None], got, torch.zeros_like(got)))
    return sum_partials(parts, row.device, table.dtype)


def unembed(cfg, table, x_last: torch.Tensor, row: Row) -> torch.Tensor:
    """``x_last @ table.T`` in the compute dtype, f32 (B, V) on the row's
    device: each coordinate's vocab slice from its own block, concatenated
    in order."""
    cd = cdt(cfg)
    if split_dim(table) is None:
        return (x_last.to(cd) @ whole(table, row).to(cd).T).float()
    parts = []
    for c, dev in zip(row.coords, row.devices):
        with current(dev):
            parts.append((x_last.to(dev).to(cd) @ table.shard(c).to(cd).T).float())
    return torch.cat([t.to(row.device) for t in parts], dim=-1)


def xent(cfg, table, x: torch.Tensor, targets: torch.Tensor, row: Row, *, softcap: float,
         form: str, chunk: int, seq_chunk: int) -> torch.Tensor:
    """Per-token CE (B, S) f32 on the row's device of ``x`` (B, S, D, on the
    row's device) against the unembedding ``table`` with the table split on
    vocab: on each coordinate, under its device, ``xent_ops.xent_part`` of
    its block with the targets less the block's first id (``form`` per
    block, see there); then on the row's device lse = logsumexp of the
    blocks' lse in coordinate order and CE = lse - Σ t (only the block that
    holds a target gives it a nonzero t).  A table not split on ``"model"``,
    or whole at the row's first coordinate (a model axis of 1), runs the
    whole-table loss (:meth:`LocalOps.xent`) from that coordinate's copy: the
    unsharded step's bits."""
    kw = dict(softcap=softcap, form=form, chunk=chunk, seq_chunk=seq_chunk)
    if split_dim(table) is None or table.shard(row.coords[0]).shape == table.shape:
        return LocalOps(cfg).xent(whole(table, row), x, targets, **kw)
    lses, ts = [], []
    for c, dev in zip(row.coords, row.devices):
        v0 = table.region_at(c)[0][0]
        with current(dev):
            lse, t = xent_ops.xent_part(x.to(dev), table.shard(c), targets.to(dev) - v0,
                                        softcap=softcap, form=form, compute_dtype=cdt(cfg))
        lses.append(lse.to(row.device))
        ts.append(t.to(row.device))
    tgt = ts[0]
    for t in ts[1:]:
        tgt = tgt + t
    return torch.logsumexp(torch.stack(lses), dim=0) - tgt


# -- attention ----------------------------------------------------------------------


def kv_pick(q_heads: Tuple[int, int], group: int):
    """The KV heads that q heads ``[h0, h1)`` read under GQA ``group``, as
    an index into all KV heads that gives one uniform group: a slice when
    the range covers whole groups or lies in one, else each q head's KV
    head repeated (group 1)."""
    h0, h1 = q_heads
    n = h1 - h0
    if n % group == 0:
        return slice(h0 // group, h1 // group)
    if group % n == 0:
        return slice(h0 // group, h0 // group + 1)
    return torch.arange(h0, h1) // group


def _take(x: torch.Tensor, pick, dim: int = 2) -> torch.Tensor:
    if isinstance(pick, slice):
        return x[(slice(None),) * dim + (pick,)]
    return x.index_select(dim, pick.to(x.device))


def _heads(p: dict, c, key: str) -> Tuple[int, int]:
    """The head range of coordinate ``c``'s block of ``wq`` / ``wk``."""
    return p[key].region_at(c)[1]


def memory_by_device(spans: List[torch.Tensor], rows: List[Row]) -> dict:
    """The encoder's memory from the data rows' spans
    (:func:`encode_over_rows`), joined in row order once on each device of
    ``rows``, where their cross sub-blocks read it: {device: (B, T, D)}."""
    devices = dict.fromkeys(d for r in rows for d in r.devices)
    return {d: torch.cat([m.to(d) for m in spans], dim=1) for d in devices}


def _memory_on(memory, dev) -> torch.Tensor:
    """The encoder's memory on ``dev``: a whole tensor moved there, or its
    copy joined there (:func:`memory_by_device`)."""
    return memory[dev] if isinstance(memory, dict) else memory.to(dev)


def attention_prefill(cfg, p: dict, x: torch.Tensor, kind: str, positions: torch.Tensor,
                      row: Row, memory: Optional[torch.Tensor] = None, prefix=None,
                      q_offset: int = 0):
    """``attention.attend_prefill`` (or ``attend_cross`` with ``memory``,
    whole or joined on each device by :func:`memory_by_device`)
    split on heads: each coordinate projects its q and KV heads, applies
    RoPE (not to a memory), runs K5 on them and its ``wo`` block; one
    query row over a memory (a decode step's cross-attention) runs
    ``_sdpa_ref``.  On a data row's span from position ``q_offset``, each
    coordinate first joins ``prefix[i]``, the (k, v) its model index held
    up to the span (the row before's, on its device), to its own, and runs
    K5 with ``q_offset`` over them.  Returns (the summed output on the row's
    device, [(KV head range, k, v)] of the span's positions covering every
    KV head once, for the cache, [(k, v)] of each coordinate up to the
    span's end, for the row after)."""
    group = cfg.num_heads // cfg.num_kv_heads
    q_split = split_dim(p["wq"]) is not None
    kv_split = split_dim(p["wk"]) is not None
    scale = 1.0 / np.sqrt(cfg.head_dim)
    parts, kv, joined = [], [], []
    for i, (c, dev) in enumerate(_workers(row, q_split)):
        lp = _local(p, c)
        with current(dev):
            xq = x.to(dev)
            q, k, v = attention._project_qkv(cfg, lp, xq, xq if memory is None
                                             else _memory_on(memory, dev))
            if memory is None:
                pos = positions.to(dev)
                q = attention._rope(cfg, q, pos, kind)
                k = attention._rope(cfg, k, pos, kind)
            if prefix is not None:
                k = torch.cat([prefix[i][0].to(dev), k], dim=1)
                v = torch.cat([prefix[i][1].to(dev), v], dim=1)
            kq, vq = k, v
            if q_split and not kv_split:
                pick = kv_pick(_heads(p, c, "wq"), group)
                kq, vq = _take(k, pick), _take(v, pick)
            if memory is None:
                out = flash_ops.flash_attention(q, kq, vq, causal=True,
                                                window=attention._window(cfg, kind),
                                                scale=scale, softcap=cfg.attn_softcap,
                                                q_offset=q_offset)
            elif x.shape[1] > 1:
                out = flash_ops.flash_attention(q, kq, vq, causal=False, window=0, scale=scale)
            else:
                out = attention._sdpa_ref(q, kq, vq, None, scale)
            parts.append(attention._out_proj(cfg, lp, out))
        joined.append((k, v))
        if kv_split or i == 0:
            kv.append((_heads(p, c, "wk"), k[:, q_offset:], v[:, q_offset:]))
    return sum_partials(parts, row.device, cdt(cfg)), kv, joined


def encoder_kv(cfg, p: dict, h: torch.Tensor, positions: torch.Tensor, row: Row) -> list:
    """A data row's span of the frames, an encoder layer's first half on
    each model coordinate that computes its attention: k (after RoPE at the
    span's absolute ``positions``) and v of the coordinate's KV heads
    (every KV head where ``"model"`` does not divide them).  Returns [(k,
    v)] in model order, each on its coordinate's device."""
    out = []
    for c, dev in _workers(row, split_dim(p["wq"]) is not None):
        with current(dev):
            out.append(attention.encoder_kv(cfg, _local(p, c), h.to(dev), positions.to(dev)))
    return out


def attention_encode_rows(cfg, p: dict, h: torch.Tensor, positions: torch.Tensor, row: Row,
                          kvs: list) -> torch.Tensor:
    """The encoder's attention of a data row's span on each model
    coordinate: its q heads of ``h`` (RoPE at the span's absolute
    ``positions``) over every row's k and v of its KV heads (``kvs``: each
    row's :func:`encoder_kv`, in row order, moved to the coordinate's device
    and joined), K5 without the mask over all ``T`` frames, and its ``wo``
    block's partial; summed on the row's device.  One K5 launch a
    coordinate, and no combine: every coordinate's queries see every key.
    The query offset is 0, as an unmasked call reads every key whatever its
    queries' positions."""
    group = cfg.num_heads // cfg.num_kv_heads
    q_split = split_dim(p["wq"]) is not None
    kv_split = split_dim(p["wk"]) is not None
    scale = 1.0 / np.sqrt(cfg.head_dim)
    parts = []
    for i, (c, dev) in enumerate(_workers(row, q_split)):
        lp = _local(p, c)
        with current(dev):
            q = attention.encoder_queries(cfg, lp, h.to(dev), positions.to(dev))
            k = torch.cat([kv[i][0].to(dev) for kv in kvs], dim=1)
            v = torch.cat([kv[i][1].to(dev) for kv in kvs], dim=1)
            if q_split and not kv_split:
                pick = kv_pick(_heads(p, c, "wq"), group)
                k, v = _take(k, pick), _take(v, pick)
            out = flash_ops.flash_attention(q, k, v, causal=False, window=0, scale=scale,
                                            softcap=cfg.attn_softcap, q_offset=0)
            parts.append(attention._out_proj(cfg, lp, out))
    return sum_partials(parts, row.device, cdt(cfg))


def cache_layout(k: pl.Placed) -> str:
    """How a KV cache leaf ``(B, L, K, h)`` is split: ``"heads"`` (K on
    "model"), ``"length"`` (L split) or ``"whole"`` (neither)."""
    entries = k.sharding.entries(k.ndim)
    if MODEL in pl.axes_of(entries[2]):
        return "heads"
    return "length" if entries[1] is not None else "whole"


def _quantized(k: torch.Tensor, v: torch.Tensor, state: dict):
    """[(leaf, value)] of K and V for the cache: int8 values and their
    scales in an int8 cache, else in the cache's dtype."""
    if "k_scale" in state:
        (kq, ks), (vq, vs) = attention._quantize_heads(k), attention._quantize_heads(v)
        return [("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)]
    return [("k", k.to(state["k"].dtype)), ("v", v.to(state["v"].dtype))]


def fill_cache(state: dict, spec: attention.KVCacheSpec, kv, row: Row, start: int = 0) -> None:
    """``attention.fill_kv_cache`` into a placed layer cache: the K/V of the
    positions ``[start, start + S)`` (``kv``: each KV head range's), each
    into the slots' blocks (every holder), the positions likewise.  A ring
    keeps the last ``length`` positions at their slots (``pos % length``: a
    rotation of them, written as at most two runs of slots); a data row's
    span after the first starts at its ``start``."""
    L = spec.length
    stop = start + kv[0][1].shape[1]
    first = max(start, stop - L) if spec.ring else start  # the positions kept
    runs = [(first, stop)]  # runs of positions whose slots are contiguous
    if spec.ring and first % L + (stop - first) > L:
        wrap = first + L - first % L
        runs = [(first, wrap), (wrap, stop)]
    rows = row.rows
    for a, b in runs:
        slot0 = a % L if spec.ring else a
        for heads, k, v in kv:
            for name, val in _quantized(k[:, a - start:b - start], v[:, a - start:b - start],
                                        state):
                pl.write(state[name], (rows, (slot0, slot0 + b - a), heads), val)
        pos = torch.arange(a, b, dtype=torch.int32, device=row.device)
        pl.write(state["pos"], (rows, (slot0, slot0 + b - a)),
                 pos[None].expand(rows[1] - rows[0], b - a))


def _valid(cfg, kind: str, cpos: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The decode mask of ``attention.attend_decode``: filled, causal and
    (windows) inside the window."""
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if kind in ("swa", "local") and cfg.window:
        valid &= cpos > pos[:, None] - cfg.window
    return valid


def _dequant(state: dict, blocks: dict, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block's K and V in ``dtype`` (an int8 cache dequantized)."""
    k, v = blocks["k"], blocks["v"]
    if "k_scale" in state:
        k = k.to(dtype) * blocks["k_scale"][..., None].to(dtype)
        v = v.to(dtype) * blocks["v_scale"][..., None].to(dtype)
    return k, v


def partial_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                    scale: float, softcap: float = 0.0):
    """One length block's share of decode attention: q (B, 1, H, h) over
    the block's k/v (B, T, K, h) where ``valid`` (B, T): ``(o, m, l)`` with
    ``o`` (B, 1, H, h) = Σ exp(s - m) v, ``m`` (B, 1, H) the largest valid
    score and ``l`` the sum of exp(s - m), all f32.  A block with no valid
    slot gives ``l = 0`` and ``m = -inf``."""
    B, S, H, h = q.shape
    K = k.shape[2]
    G = H // K
    s = torch.einsum("bskgh,btkh->bkgst", q.reshape(B, S, K, G, h), k).float() * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid[:, None, None, None, :], s, -torch.inf)
    m = s.amax(dim=-1)  # (B, K, G, S)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float()).reshape(B, S, H, h)

    def by_head(t):  # (B, K, G, S) -> (B, S, H)
        return t.permute(0, 3, 1, 2).reshape(B, S, H)

    return o, by_head(m), by_head(p.sum(dim=-1))


def combine_partials(parts) -> torch.Tensor:
    """The flash-decoding combine: [(o, m, l)] of the length blocks, in
    slot order, → Σ exp(m_b - m) o_b / Σ exp(m_b - m) l_b, m the largest
    m_b; a block with ``m = -inf`` weighs 0."""
    m = parts[0][1]
    for _, mb, _ in parts[1:]:
        m = torch.maximum(m, mb)
    m = torch.where(torch.isfinite(m), m, 0.0)
    o = l = None
    for ob, mb, lb in parts:
        w = torch.exp(mb - m)  # exp(-inf) = 0 for an empty block
        o = ob * w[..., None] if o is None else o + ob * w[..., None]
        l = lb * w if l is None else l + lb * w
    return o / l[..., None]


def attention_decode(cfg, p: dict, x: torch.Tensor, state: dict, kind: str,
                     pos: torch.Tensor, spec: attention.KVCacheSpec, row: Row) -> torch.Tensor:
    """``attention.attend_decode`` on a placed layer cache: each coordinate
    projects its heads of the new token and writes its KV heads' slot
    (only into the blocks that hold it); then a heads-split cache is read
    block by block, a length-split one through :func:`partial_softmax` on
    each block and :func:`combine_partials`, and a whole one from each
    coordinate's own copy.  Returns the summed output on the row's
    device."""
    group = cfg.num_heads // cfg.num_kv_heads
    q_split = split_dim(p["wq"]) is not None
    kv_split = split_dim(p["wk"]) is not None
    scale = 1.0 / np.sqrt(cfg.head_dim)
    cd = cdt(cfg)
    positions = pos[:, None]
    slot = (pos % spec.length if spec.ring else pos).long()
    rows = row.rows
    work = []  # (coordinate, device, local params, q)
    for i, (c, dev) in enumerate(_workers(row, q_split)):
        lp = _local(p, c)
        with current(dev):
            xq = x.to(dev)
            q, k, v = attention._project_qkv(cfg, lp, xq, xq)
            q = attention._rope(cfg, q, positions.to(dev), kind)
            k = attention._rope(cfg, k, positions.to(dev), kind)
            if kv_split or i == 0:
                heads = _heads(p, c, "wk")
                for name, val in _quantized(k[:, 0], v[:, 0], state):
                    pl.write_slots(state[name], rows, slot, val, (heads,))
        work.append((c, dev, lp, q))
    pl.write_slots(state["pos"], rows, slot, pos.to(torch.int32))

    layout = cache_layout(state["k"])
    parts = []
    if layout == "length":
        q_all = torch.cat([q.to(row.device) for *_, q in work], dim=2)
        o = length_attend(cfg, state, q_all, pos, kind, row, scale).to(q_all.dtype)
        for c, dev, lp, q in work:
            h0, h1 = _heads(p, c, "wq")
            with current(dev):
                parts.append(attention._out_proj(cfg, lp, o[:, :, h0:h1].to(dev)))
        return sum_partials(parts, row.device, cd)
    L = state["k"].shape[1]
    for c, dev, lp, q in work:
        with current(dev):
            blocks = {name: leaf.shard(c) for name, leaf in state.items() if name != "pos"}
            if state["k"].region_at(c)[0] != rows:
                raise ValueError(f"cache block at {c} holds rows {state['k'].region_at(c)[0]}, "
                                 f"the row computes {rows}")
            ck, cv = _dequant(state, blocks, q.dtype)
            if q_split and not kv_split:
                pick = kv_pick(_heads(p, c, "wq"), group)
                ck, cv = _take(ck, pick), _take(cv, pick)
            cpos = pl.read_region(state["pos"], (rows, (0, L)), dev)
            mask = _valid(cfg, kind, cpos, pos.to(dev))[:, None, None, :]
            out = attention._sdpa_ref(q, ck, cv, mask, scale, cfg.attn_softcap)
            parts.append(attention._out_proj(cfg, lp, out))
    return sum_partials(parts, row.device, cd)


def length_attend(cfg, state: dict, q: torch.Tensor, pos: torch.Tensor, kind: str,
                  row: Row, scale: float) -> torch.Tensor:
    """Decode attention of every q head (``q`` (B, 1, H, h) on the row's
    device) over a cache split on length: the partial softmax of each
    block that holds the row's rows, on that block's device (a copy on the
    row's coordinates first), combined on the row's device in slot order.
    Returns f32 (B, 1, H, h)."""
    k = state["k"]
    rows = row.rows
    srcs = {name: pl.sources(leaf, row.device, row.coords)
            for name, leaf in state.items() if name != "pos"}
    partials = []
    for b in sorted(srcs["k"]):
        region = k.sharding.region(b, k.shape)
        if pl.intersect(region[:1], (rows,)) is None:
            continue
        if region[0] != rows:
            raise ValueError(f"cache block {b} holds rows {region[0]}, the row computes {rows}")
        blocks = {name: s[b[:state[name].ndim]] for name, s in srcs.items()}
        dev = blocks["k"].device
        with current(dev):
            ck, cv = _dequant(state, blocks, q.dtype)
            cpos = pl.read_region(state["pos"], (rows, region[1]), dev)
            valid = _valid(cfg, kind, cpos, pos.to(dev))
            part = partial_softmax(q.to(dev), ck, cv, valid, scale, cfg.attn_softcap)
        partials.append(tuple(t.to(row.device) for t in part))
    return combine_partials(partials)


# -- FFN -------------------------------------------------------------------------------


def dense_mlp(cfg, p: dict, x: torch.Tensor, row: Row) -> torch.Tensor:
    """``mlp.apply_mlp`` split on ``d_ff``: each coordinate's ``wi`` /
    ``wg`` columns and ``wo`` rows give a partial output."""
    parts = []
    for c, dev in _workers(row, split_dim(p["wi"]) is not None):
        with current(dev):
            parts.append(mlp.apply_mlp(cfg, _local(p, c), x.to(dev)))
    return sum_partials(parts, row.device, cdt(cfg))


def moe_ffn(cfg, p: dict, x: torch.Tensor, row: Row, span: Optional[Span] = None,
            carry: Optional[dict] = None):
    """``moe.apply_moe`` with the experts' and the shared expert's ``d_ff``
    split: routing, capacity, drops, the shared gate and the aux loss
    (``moe.aux_loss``) once on the row's device, then each coordinate's
    expert and shared-expert partials.  Returns (out, aux).  On a data
    row's ``span``, routed by ``moe.plan_span`` from ``carry`` (the rows
    before's counts and sums, moved to the row's device): (out, its share
    of the aux loss, the carry)."""
    router = {"router": whole(p["router"], row)}
    if span is None:
        xg = moe.token_groups(x)
        r, combine = moe.plan(cfg, router, xg)
        pieces = [(0, xg.shape[1], r, combine)]
    else:
        xg = x
        pieces, carry = moe.plan_span(cfg, router, x, span, carry)
    experts = {k: p[k] for k in ("wi", "wg", "wo") if k in p}
    parts = []
    for c, dev in _workers(row, split_dim(p["wi"]) is not None):
        with current(dev):
            mixed = [moe.expert_mix(cfg, _local(experts, c), xg[:, a:b].to(dev),
                                    combine.to(dev)) for a, b, _, combine in pieces]
            parts.append(mixed[0] if len(mixed) == 1 else torch.cat(mixed, dim=1))
    if cfg.moe.d_ff_shared:  # the gate after the MLPs, as apply_moe orders them:
        # the backward then sums x's gradient in the same order
        shared = []
        for c, dev in _workers(row, split_dim(p["shared"]["wi"]) is not None):
            with current(dev):
                shared.append(mlp.apply_mlp(cfg, _local(p["shared"], c), xg.to(dev)))
        sg = moe.shared_gate(cfg, {"shared_gate": whole(p["shared_gate"], row)}, xg)
        parts += [h * sg.to(h.device) for h in shared]
    out = sum_partials(parts, row.device, cdt(cfg)).to(x.dtype).reshape(x.shape)
    if span is None:
        return out, moe.aux_loss(cfg, pieces[0][2])
    return out, moe.span_aux(cfg, span, carry, x.shape[0], row.device), carry


def ffn(cfg, p: dict, x: torch.Tensor, row: Row) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN after attention: (out, aux) of the MoE layer, or the dense
    MLP's and an f32 zero."""
    if "router" in p:
        return moe_ffn(cfg, p, x, row)
    return dense_mlp(cfg, p, x, row), torch.zeros((), dtype=torch.float32, device=row.device)


# -- recurrent blocks -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Blocks:
    """A new state leaf as the model coordinates computed it: [(its region
    of the whole leaf, the block)], for :func:`write_state`."""

    parts: Tuple[Tuple[pl.Region, torch.Tensor], ...]


def own_block(x: pl.Placed, c, row: Row) -> Tuple[pl.Region, torch.Tensor]:
    """Coordinate ``c``'s block of a state leaf for the row's rows: (its
    region of the whole leaf, a view of the stored block, no copy)."""
    outer = x.region_at(c)
    region = (row.rows,) + outer[1:]
    if not pl.contains(outer, region):
        raise ValueError(f"state block at {c} holds {outer}, the row computes rows {row.rows}")
    return region, x.shard(c)[pl.slices_within(region, outer)]


def state_block(x, i: int, c, row: Row, dev) -> Tuple[Optional[pl.Region], torch.Tensor]:
    """Coordinate ``c`` (the row's ``i``-th)'s block of an incoming
    recurrent state: its own block of a placed leaf (:func:`own_block`), or
    the block the row before's ``i``-th coordinate computed (a
    :class:`Blocks` carry, the next span of a split sequence), moved to
    ``dev``."""
    if isinstance(x, Blocks):
        region, t = x.parts[i]
        return region, t.to(dev)
    return own_block(x, c, row)


def _on_row(x, row: Row):
    """A carried whole state (a tensor, a dict of them, or None) on the
    row's device."""
    if isinstance(x, dict):
        return {k: _on_row(v, row) for k, v in x.items()}
    return None if x is None else x.to(row.device)


def time_mix(cfg, p: dict, x: torch.Tensor, state, last_x, row: Row, chunk: int):
    """``rwkv6.time_mix`` split on heads: the token-shift inputs and the
    decay LoRA's hidden layer once on the row's device (they read
    replicated leaves alone), then on each model coordinate its heads'
    ``r``, ``k``, ``v``, ``g`` and decay from its blocks of ``wr`` / ``wk``
    / ``wv`` / ``wg`` and its channels of ``decay_w2`` / ``decay_base``,
    K7 over its heads (``wkv_step`` for one token) from its block of
    ``state`` (None: zero), the group norm on its channels and its
    ``wo`` rows' partial, summed by :func:`sum_partials`.  Returns (out, the
    new state as :class:`Blocks`, the new ``last_x``).  Heads that do not
    divide ``"model"`` run whole on the row's device (``state`` whole).
    ``state`` may also be the :class:`Blocks` the row before computed, and
    ``last_x`` its ``last_x`` (a split sequence's next span)."""
    last_x = _on_row(last_x, row)
    if split_dim(p["bonus_u"]) is None:
        return rwkv6.time_mix(cfg, reader(p, row), x, _on_row(state, row), last_x,
                              chunk=chunk)
    mixed = rwkv6.time_mix_inputs(reader(p, row), x, rwkv6._shift(x, last_x))
    hd = cfg.rwkv_head_dim
    parts, blocks = [], []
    for i, (c, dev) in enumerate(zip(row.coords, row.devices)):
        lp = _local(p, c)
        h0, h1 = p["bonus_u"].region_at(c)[0]
        with current(dev):
            region, s0 = (None, None) if state is None else state_block(state, i, c, row, dev)
            out, s_new = rwkv6.heads_mix(cfg, lp, [t.to(dev) for t in mixed], s0, chunk,
                                         slice(h0 * hd, h1 * hd))
        parts.append(out)
        if region is None:
            region = (row.rows, (h0, h1), (0, hd), (0, hd))
        blocks.append((region, s_new))
    return sum_partials(parts, row.device, cdt(cfg)), Blocks(tuple(blocks)), x[:, -1]


def channel_mix(cfg, p: dict, x: torch.Tensor, last_x, row: Row):
    """``rwkv6.channel_mix`` with ``cm_wk`` split on ``d_ff`` columns and
    ``cm_wv`` on its rows (partials summed in f32 in coordinate order), and
    ``cm_wr`` on its output columns: each coordinate's slice of the gate
    ``r``, concatenated, not summed.  Returns (cat(r) * Σ kv, the new
    ``last_x``); at one model coordinate the unsharded bits."""
    xk, xr = rwkv6.channel_inputs(reader(p, row), x, _on_row(last_x, row))
    kv = []
    for c, dev in _workers(row, split_dim(p["cm_wk"]) is not None):
        with current(dev):
            kv.append(rwkv6.channel_kv(cfg, _local(p, c), xk.to(dev)))
    kv = sum_partials(kv, row.device, cdt(cfg))
    r = []
    for c, dev in _workers(row, split_dim(p["cm_wr"]) is not None):
        with current(dev):
            r.append(rwkv6.channel_gate(cfg, _local(p, c), xr.to(dev)))
    r = torch.cat([t.to(row.device) for t in r], dim=-1)
    return r.to(cdt(cfg)) * kv, x[:, -1]


def rglru(cfg, p: dict, x: torch.Tensor, state, row: Row):
    """``griffin.griffin_block`` split on the RG-LRU width: each model
    coordinate's gate branch and conv from its blocks of ``w_gate`` /
    ``w_rec`` / ``conv_w`` and its channels of ``conv_b`` over its block of
    the conv tail; ξ, every coordinate's channels in coordinate order, on
    every device (``w_a`` / ``w_x`` are split on their output columns and
    read every input channel: the activation is gathered, not a leaf);
    then its gates, the scan (or ``rg_lru_step``) from its block of ``h``
    and its ``w_out`` rows' partial, summed by :func:`sum_partials`.
    Returns (out, the new state {"h", "conv"} as :class:`Blocks`; their
    regions None from ``state`` None, the zero state of training).
    ``state`` may also hold the :class:`Blocks` the row before computed (a
    split sequence's next span).  A width that does not divide ``"model"``
    runs whole on the row's device (``state`` whole)."""
    if split_dim(p["w_rec"]) is None:
        return griffin.griffin_block(cfg, reader(p, row), x, _on_row(state, row))
    work = []  # (device, local params, channels, gate, ξ, new conv tail, h0, regions)
    for i, (c, dev) in enumerate(zip(row.coords, row.devices)):
        lp = _local(p, c)
        cols = slice(*p["w_rec"].region_at(c)[-1])
        tail = h0 = None
        regions = (None, None)
        with current(dev):
            if state is not None:
                (rh, h0), (rc, tail) = (state_block(state["h"], i, c, row, dev),
                                        state_block(state["conv"], i, c, row, dev))
                regions = (rh, rc)
            gate, xf, tail = griffin.rec_inputs(cfg, lp, x.to(dev), tail, cols)
        work.append((dev, lp, cols, gate, xf, tail, h0, regions))
    xf_on = {}
    for dev, *_ in work:
        if dev not in xf_on:  # one coordinate reads its own ξ, as the unsharded block
            xf_on[dev] = (work[0][4] if len(work) == 1
                          else torch.cat([w[4].to(dev) for w in work], dim=-1))
    parts, h_blocks, conv_blocks = [], [], []
    step = x.shape[1] == 1 and state is not None
    for dev, lp, cols, gate, xf, tail, h0, regions in work:
        with current(dev):
            out, h_last = griffin.recurrence(cfg, lp, gate, xf_on[dev], xf, h0, step, cols)
        parts.append(out)
        h_blocks.append((regions[0], h_last))
        conv_blocks.append((regions[1], tail))
    new = {"h": Blocks(tuple(h_blocks)), "conv": Blocks(tuple(conv_blocks))}
    return sum_partials(parts, row.device, cdt(cfg)), new


def read_state(state: dict, row: Row) -> dict:
    """A recurrent layer's state for the row: a leaf split on ``"model"``
    as it is (each coordinate reads its own block), any other the row's
    rows whole on its device."""
    return {k: v if split_dim(v) is not None else
            pl.read_region(v, (row.rows,) + tuple((0, d) for d in v.shape[1:]), row.device)
            for k, v in state.items()}


def write_state(state: dict, new: dict, row: Row) -> None:
    """A recurrent layer's new state into its placement (every holder): a
    :class:`Blocks` value block by block, any other the row's rows."""
    for k, v in new.items():
        x = state[k]
        for region, t in (v.parts if isinstance(v, Blocks) else [((row.rows,), v)]):
            pl.write(x, region, t.to(x.dtype))


# -- the walk's operations on one data row ---------------------------------------------


class RowOps:
    """The sub-block operations of :class:`repro_torch.models.transformer.
    LocalOps` on one data row of a mesh, so that ``Model.train_loss``,
    ``prefill``, ``decode_step`` and ``encode`` walk a placed model:
    attention, FFNs and the recurrent blocks (RWKV's time-mix and
    channel-mix, the RG-LRU) split over the row's model coordinates, the
    embedding looked up, the logits and the training loss computed on its
    vocab blocks, the KV cache and the recurrent state on their shards,
    norms read whole on the row's device.  Every operation is differentiable with respect to
    the blocks it reads (:func:`row_tensors`)."""

    def __init__(self, cfg, row: Row):
        self.cfg, self.row = cfg, row

    def read(self, p: dict) -> pl.Reader:
        return reader(p, self.row)

    def lookup(self, table, tokens):
        return lookup(table, tokens, self.row)

    def unembed(self, table, x_last):
        return unembed(self.cfg, table, x_last, self.row)

    def xent(self, table, x, targets, **kw):
        return xent(self.cfg, table, x, targets, self.row, **kw)

    def attend(self, p, h, kind, positions):
        return attention_prefill(self.cfg, p, h, kind, positions, self.row)[0]

    def attend_span(self, p, h, kind, positions, start, kv):
        a, _, joined = attention_prefill(self.cfg, p, h, kind, positions, self.row,
                                         prefix=kv, q_offset=start)
        return a, joined

    def attend_prefill(self, p, h, kind, positions, state, spec, start=0, kv=None):
        a, cache_kv, joined = attention_prefill(self.cfg, p, h, kind, positions, self.row,
                                                prefix=kv, q_offset=start)
        fill_cache(state, spec, cache_kv, self.row, start)
        return a, state, joined

    def attend_decode(self, p, h, kind, pos, state, spec):
        return attention_decode(self.cfg, p, h, state, kind, pos, spec, self.row), state

    def cross(self, p, h, memory):
        return attention_prefill(self.cfg, p, h, "attn", None, self.row, memory=memory)[0]

    def encode_kv(self, p, h, positions):
        return encoder_kv(self.cfg, p, h, positions, self.row)

    def encode_attend(self, p, h, positions, kvs):
        return attention_encode_rows(self.cfg, p, h, positions, self.row, kvs)

    def ffn(self, p, x):
        return ffn(self.cfg, p, x, self.row)

    def ffn_span(self, p, x, span, carry):
        if "router" in p:
            return moe_ffn(self.cfg, p, x, self.row, span, carry)
        return self.ffn(p, x) + (None,)

    def mlp(self, p, x):
        return dense_mlp(self.cfg, p, x, self.row)

    def rglru(self, p, h, state):
        return rglru(self.cfg, p, h, state, self.row)

    def time_mix(self, p, h, state, last_x, chunk: int = 64):
        return time_mix(self.cfg, p, h, state, last_x, self.row, chunk)

    def channel_mix(self, p, x, last_x):
        return channel_mix(self.cfg, p, x, last_x, self.row)

    def read_state(self, state: dict) -> dict:
        return read_state(state, self.row)

    def write_state(self, state: dict, new: dict) -> dict:
        write_state(state, new, self.row)
        return state
