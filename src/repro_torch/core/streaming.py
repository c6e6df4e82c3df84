"""Streaming executor: ring-buffer arena + incremental per-frame step.

The port's counterpart of ``repro/core/streaming.py``.  Keyword spotting is
deployed on continuous audio: one new MFCC frame arrives at a time and the
(49, 10) window slides by one row.  Consecutive windows share 48 of 49 input
rows, and every conv/pool layer's activations overlap accordingly, so each
backbone layer keeps a **ring buffer along the time (H) axis** holding
exactly its *steady* rows (those whose receptive field never touches the
window's zero padding) and a frame computes only the new rows plus the thin
window-edge patches; the head (pool + FC on the assembled final map) is
recomputed whole.

Ring extents.  For backbone layer ℓ with kernel ``k``, stride ``s`` and
padding ``p`` along H, the rows *affected* by the sliding top edge grow as
``a_ℓ = ceil((a_{ℓ-1} + p) / s)`` and by the bottom edge as
``b_ℓ = H_ℓ - 1 - floor((H_{ℓ-1} - b_{ℓ-1} + p - k) / s)`` (``a_0 = b_0 =
0``).  The ring holds the other ``n_ℓ = H_ℓ - a_ℓ - b_ℓ`` rows.  With
``S_ℓ`` the cumulative stride through layer ℓ and ``E`` the product over the
backbone, an emission happens every ``E`` input frames and layer ℓ gains
``r_ℓ = E / S_ℓ`` steady rows an emission.  For ``ds_cnn()`` the stride-2
stem gives ``E = 2`` and rings of 23/21/21/19/19/17/17/15/15 rows.

Every row computation reuses the DAG executors' step unchanged, through
:func:`repro_torch.core.pingpong.run_step` with its ReLU fold: the float
step :func:`~repro_torch.core.pingpong.apply_node` or the int8 step
``repro_torch.quant.exec.apply_int8_node``.  The assembled input block is
padded explicitly (zeros for convolutions and average pools, ``-inf`` for
f32 max pools, -128 for int8 ones, the identities the full-window semantics
use) and the layer runs with ``padding=0``.  So each depthwise row block of a
CUDA state launches kernel K3 (f32) or K4 (int8), or raises; pointwise and
stem convolutions run on cuDNN (f32) or ``quantize.int_conv2d`` (int8), as
in the executors.  Int8 outputs are bit-exact against the sliding
full-window oracle; f32 agrees to rounding.

What the reference's ``jit`` / ``lax.cond`` / ``lax.scan`` did is plain
Python here: the phase counter lives on the host, so a frame that does not
emit does no device work but the shift of the input ring, and no
synchronisation.  Every emission builds new ring tensors (no ring is shifted
in place), so states never share storage.

The ring arena is priced by :func:`repro_torch.core.schedule.assemble_plan`:
rings live across the whole emission schedule (bank ``"ring"``), the new
rows, edge patches, assembled head input and head buffers are per-emission
temporaries (bank ``"stream"``), and ``planner.verify_plan`` /
``obs.report.arena_timeline`` apply unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import nn, pingpong, schedule
from repro_torch.core.graph import (
    AvgPool2d,
    Conv2d,
    DepthwiseConv2d,
    MaxPool2d,
    ReLU,
    as_sequential,
)
from repro_torch.core.planner import MemoryPlan, materialized_steps
from repro_torch.device import resolve

# Layer kinds that can live in the streamed backbone: local along H with a
# static (kernel, stride, padding) geometry.  Everything else — Linear,
# Flatten, fused forms, joins — starts the full-recompute head.  AvgPool2d
# streams like the others: its padding identity is 0 (count-include-pad
# zeros) and its divisor is a constant.
_STREAMABLE = (Conv2d, DepthwiseConv2d, MaxPool2d, AvgPool2d)


def _geometry(layer) -> Tuple[int, int, int]:
    """(kernel, stride, padding) along **H** for a streamable layer; the W
    axis is handled whole inside each row computation."""
    return (layer.kernel_size[0], layer.stride[0], layer.padding[0])


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Ring geometry for one backbone layer (all row counts along H)."""

    name: str
    kind: str
    kernel: int
    stride: int
    padding: int
    channels: int  # C of the layer's output map
    width: int  # W of the layer's output map
    height: int  # full-window output height H_ℓ
    top: int  # a_ℓ: top rows affected by the sliding window edge
    bottom: int  # b_ℓ: bottom rows affected by the sliding window edge
    rows: int  # n_ℓ = H_ℓ - a_ℓ - b_ℓ: steady rows held in the ring
    new_rows: int  # r_ℓ = E / S_ℓ: rows entering the ring per emission
    cum_stride: int  # S_ℓ: cumulative stride through this layer

    @property
    def ring_elems(self) -> int:
        return self.channels * self.rows * self.width


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The streaming counterpart of a :class:`MemoryPlan`: ``rings`` covers
    the streamed backbone in execution order, ``head`` names the steps
    recomputed full-window per emission, ``plan`` (strategy
    ``"streaming-ring"``) prices rings + per-emission temporaries."""

    in_shape: Tuple[int, int, int]
    emit_stride: int  # E: input frames per output emission
    rings: Tuple[RingSpec, ...]
    head: Tuple[str, ...]
    plan: MemoryPlan

    @property
    def ring_elems(self) -> int:
        """Persistent ring state (input ring + per-layer rings), in elems."""
        c, h, w = self.in_shape
        return c * h * w + sum(r.ring_elems for r in self.rings)


def _ceil_div(x: int, y: int) -> int:
    return -(-x // y)


def plan_streaming(graph, *, io_dtype_bytes: int = 4,
                   pack_budget: int = 200000) -> StreamPlan:
    """Plan the ring-buffer arena for streaming a chain along H.

    The backbone is the longest prefix of materialized steps that are
    streamable: conv/depthwise/pool layers with only ReLU views attached,
    ``padding < kernel_size``, and ring extents that stay positive and large
    enough to supply the next emission (``n_ℓ ≥ r_ℓ``).  Everything after
    it is the head, recomputed full-window per emission.
    """
    seq = as_sequential(graph, caller="plan_streaming")
    pre_views, steps = materialized_steps(seq)
    in_shape = tuple(seq.layers[0].shape)
    if len(in_shape) != 3:
        raise ValueError(f"plan_streaming: expected a (C, H, W) input, got {in_shape}")

    candidates: List[RingSpec] = []
    if not pre_views:  # view layers on the raw input force full recompute
        a_prev, b_prev, h_prev = 0, 0, in_shape[1]
        cum = 1
        for layer, views, _in_sh, out_sh in steps:
            if not isinstance(layer, _STREAMABLE):
                break
            if any(not isinstance(v, ReLU) for v in views):
                break
            k, s, p = _geometry(layer)
            if p >= k:
                break
            h_out = out_sh[1]
            a = min(_ceil_div(a_prev + p, s), h_out)
            j0 = (h_prev - b_prev + p - k) // s + 1
            b = min(max(h_out - j0, 0), h_out)
            rows = h_out - a - b
            if rows < 1:
                break
            cum *= s
            candidates.append(RingSpec(
                name=layer.name or layer.kind, kind=layer.kind, kernel=k,
                stride=s, padding=p, channels=out_sh[0], width=out_sh[2],
                height=h_out, top=a, bottom=b, rows=rows,
                new_rows=0,  # filled once E is known
                cum_stride=cum))
            a_prev, b_prev, h_prev = a, b, h_out

    # Deeper strided layers raise E, which raises every earlier layer's
    # per-emission row count r = E / S: trim from the end until all fit.
    while candidates:
        emit = candidates[-1].cum_stride
        if all(emit // r.cum_stride <= r.rows for r in candidates):
            break
        candidates.pop()
    emit = candidates[-1].cum_stride if candidates else 1
    rings = tuple(dataclasses.replace(r, new_rows=emit // r.cum_stride)
                  for r in candidates)
    head = tuple((layer.name or layer.kind) for layer, _, _, _ in steps[len(rings):])

    # Emission timeline: t = i processes backbone layer i (new rows + edge
    # patches), t = B assembles the head input, t = B+1+h runs head step h.
    # Rings persist across the whole schedule.
    n_b = len(rings)
    t_end = n_b + 1 + len(head)
    c_in, h_in, w_in = in_shape
    entries: List[Tuple[str, str, int, str, int, int]] = [
        ("input_ring", "Input", c_in * h_in * w_in, "ring", 0, t_end)]
    for r in rings:
        entries.append((f"ring:{r.name}", r.kind, r.ring_elems, "ring", 0, t_end))
    for i, r in enumerate(rings):
        row = r.channels * r.width
        entries.append((f"new:{r.name}", r.kind, r.new_rows * row, "stream", i, i + 1))
        if r.top:
            entries.append((f"top:{r.name}", r.kind, r.top * row, "stream", i, i + 1))
        if r.bottom:
            entries.append((f"bot:{r.name}", r.kind, r.bottom * row, "stream", i, i + 1))
    if rings:
        last = rings[-1]
        entries.append(("assembled", last.kind, last.channels * last.height * last.width,
                        "stream", n_b, n_b + 1))
    for h, (layer, _views, _in_sh, out_sh) in enumerate(steps[len(rings):]):
        entries.append((f"head:{layer.name or layer.kind}", layer.kind,
                        math.prod(int(d) for d in out_sh), "stream",
                        n_b + 1 + h, min(n_b + 2 + h, t_end)))
    plan = schedule.assemble_plan(
        entries, strategy="streaming-ring", param_elems=seq.param_count(),
        io_dtype_bytes=io_dtype_bytes, pack_budget=pack_budget)
    return StreamPlan(in_shape=in_shape, emit_stride=emit, rings=rings, head=head,
                      plan=plan)


def _slice_rows(parts, geom: Tuple[int, int, int], lo: int,
                hi: int) -> Tuple[torch.Tensor, int, int]:
    """Rows [lo, hi] of the previous layer's *current-window* output.

    ``parts = (top, ring, bot)`` are the previous layer's fresh top patch
    (rows [0, a)), updated ring (rows [a, a+n)) and bottom patch (rows
    [a+n, H)); ``geom = (a, n, b)``.  Rows outside [0, H) come back as
    explicit pad counts for the caller to fill with the layer's padding
    identity.
    """
    a, n, b = geom
    h_prev = a + n + b
    pad_top = max(0, -lo)
    pad_bot = max(0, hi - (h_prev - 1))
    lo_c, hi_c = max(lo, 0), min(hi, h_prev - 1)
    pieces = []
    for part, start, height in ((parts[0], 0, a), (parts[1], a, n), (parts[2], a + n, b)):
        if part is None or height == 0:
            continue
        s0 = max(lo_c - start, 0)
        s1 = min(hi_c - start, height - 1)
        if s0 <= s1:
            pieces.append(part.narrow(1, s0, s1 + 1 - s0))
    block = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
    return block, pad_top, pad_bot


class _Step(NamedTuple):
    """What :func:`pingpong.run_step` reads of a schedule step."""

    layer: object
    views: tuple


class StreamingExecutor:
    """The per-frame incremental executor for a streamable chain.

    Numerics-parametric like the DAG executors: ``apply_node_fn`` is
    ``pingpong.apply_node`` (float) or ``quant.exec.apply_int8_node``
    (int8); the streaming machinery only rearranges *which rows* each layer
    sees.  State and frames live on ``device``.

    * :meth:`init_state` — zero-history warm start: the state a stream would
      have after infinitely many all-zero frames (a full-window pass over a
      zero window, steady rows sliced into the rings).
    * :meth:`step` — ``(params, state, frame) -> (state, out, emitted)``,
      ``emitted`` a Python bool; the state is a new dict.
    * :meth:`run` — :meth:`step` over a frame sequence.
    * :meth:`aot_step` — the serving prewarm: builds the kernels and runs
      one emission on a throwaway state, then returns :meth:`step`.
    """

    def __init__(self, graph, splan: StreamPlan, *,
                 apply_node_fn: Callable = pingpong.apply_node,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        seq = as_sequential(graph, caller="StreamingExecutor")
        pre_views, steps = materialized_steps(seq)
        self.splan = splan
        self.dtype = dtype
        self.device = resolve(device)
        self._apply = apply_node_fn
        self._pre_views = pre_views
        # (ring, full-window step, the same step at padding=0) per layer
        self._backbone = [
            (spec, _Step(layer, tuple(views)),
             _Step(dataclasses.replace(layer, padding=0), tuple(views)))
            for spec, (layer, views, _, _) in zip(splan.rings, steps)]
        self._head = [_Step(layer, tuple(views))
                      for layer, views, _, _ in steps[len(splan.rings):]]
        self._E = splan.emit_stride

    # -- row-level layer application ---------------------------------------
    def _pad_fill(self, layer) -> float:
        if isinstance(layer, MaxPool2d):
            return -math.inf if self.dtype.is_floating_point else torch.iinfo(self.dtype).min
        return 0

    def _run(self, step: _Step, params, x: torch.Tensor) -> torch.Tensor:
        name = step.layer.name or step.layer.kind
        return pingpong.run_step(self._apply, step, params.get(name, {}), [x])

    def _rows(self, full: _Step, padded: _Step, params, block, pad_top: int,
              pad_bot: int) -> torch.Tensor:
        """``full``'s layer (+ its views) on a block padded explicitly on H
        by the window-edge counts and on W by the layer's own W padding,
        with the layer's padding identity, run as ``padded`` (padding 0)."""
        pad_w = full.layer.padding[1]
        if pad_top or pad_bot or pad_w:
            block = F.pad(block, (pad_w, pad_w, pad_top, pad_bot),
                          value=self._pad_fill(full.layer))
        return self._run(padded, params, block.contiguous())

    def _head_out(self, params, x: torch.Tensor) -> torch.Tensor:
        for step in self._head:
            x = self._run(step, params, x)
        return x

    # -- the emission ------------------------------------------------------
    def _emit(self, params, frames: torch.Tensor, rings: Dict[str, torch.Tensor]):
        """New rings + head output for the window held in ``frames``."""
        parts = (None, frames, None)
        geom = (0, self.splan.in_shape[1], 0)
        new_rings = {}
        for spec, full, padded in self._backbone:
            k, s, pad = spec.kernel, spec.stride, spec.padding
            # 1. new steady rows: output rows [H-b-r, H-b); their receptive
            #    field lies inside the previous layer's steady span.
            j0 = spec.height - spec.bottom - spec.new_rows
            j1 = spec.height - spec.bottom - 1
            block, pt, pb = _slice_rows(parts, geom, j0 * s - pad, j1 * s - pad + k - 1)
            new = self._rows(full, padded, params, block, pt, pb)
            old = rings[spec.name]
            ring = torch.cat([old.narrow(1, spec.new_rows, spec.rows - spec.new_rows), new],
                             dim=1)
            # 2./3. window-edge patches, recomputed outright per emission.
            top = bot = None
            if spec.top:
                block, pt, pb = _slice_rows(parts, geom, -pad,
                                            (spec.top - 1) * s - pad + k - 1)
                top = self._rows(full, padded, params, block, pt, pb)
            if spec.bottom:
                jb = spec.height - spec.bottom
                block, pt, pb = _slice_rows(parts, geom, jb * s - pad,
                                            (spec.height - 1) * s - pad + k - 1)
                bot = self._rows(full, padded, params, block, pt, pb)
            new_rings[spec.name] = ring
            parts = (top, ring, bot)
            geom = (spec.top, spec.rows, spec.bottom)
        pieces = [x for x in parts if x is not None and x.shape[1]]
        x = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
        if not self._backbone:
            for v in self._pre_views:
                x = nn.apply_layer(v, {}, x)
        return new_rings, self._head_out(params, x)

    # -- state / step / run -------------------------------------------------
    def init_state(self, params) -> dict:
        """Zero-history state: a full-window pass over an all-zero window."""
        frames = torch.zeros(self.splan.in_shape, dtype=self.dtype, device=self.device)
        x = frames
        for v in self._pre_views:
            x = nn.apply_layer(v, {}, x)
        rings = {}
        for spec, full, _ in self._backbone:
            x = self._run(full, params, x)
            rings[spec.name] = x.narrow(1, spec.top, spec.rows).clone()  # ring-sized
        return {"frames": frames, "rings": rings, "phase": 0,
                "out": self._head_out(params, x)}

    def step(self, params, state: dict, frame: torch.Tensor):
        """One (C, W) frame: ``(new state, held output, emitted)``."""
        dev = self.device
        if frame.device.type != dev.type or dev.index not in (None, frame.device.index):
            frame = frame.to(dev)
        old = state["frames"]
        frames = torch.cat([old.narrow(1, 1, old.shape[1] - 1),
                            frame.to(self.dtype).unsqueeze(1)], dim=1)
        phase = (state["phase"] + 1) % self._E
        emitted = phase == 0
        if emitted:
            rings, out = self._emit(params, frames, state["rings"])
        else:
            rings, out = state["rings"], state["out"]
        return {"frames": frames, "rings": rings, "phase": phase, "out": out}, out, emitted

    def run(self, params, state: dict, frames_seq):
        """:meth:`step` over ``frames_seq`` of shape (T, C, W).

        Returns ``(state, outs, emitted)``: ``outs[t]`` is the held output
        after frame t (the last emission's on non-emitting frames),
        ``emitted`` a numpy bool array.
        """
        frames_seq = torch.as_tensor(frames_seq, device=self.device)
        outs, emitted = [], []
        for t in range(frames_seq.shape[0]):
            state, out, e = self.step(params, state, frames_seq[t])
            outs.append(out)
            emitted.append(e)
        return state, torch.stack(outs), np.asarray(emitted, bool)

    def aot_step(self, params):
        """The serving prewarm: one emission on a throwaway state builds the
        kernels and warms every row shape; returns :meth:`step`.  (No CUDA
        graph is captured: ROADMAP.md perf item 11.)"""
        c, _, w = self.splan.in_shape
        state = self.init_state(params)
        zero = torch.zeros((c, w), dtype=self.dtype, device=self.device)
        for _ in range(self._E):
            state, _, _ = self.step(params, state, zero)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.step


def make_streaming_executor(graph, splan: Optional[StreamPlan] = None, *,
                            apply_node_fn: Callable = pingpong.apply_node,
                            dtype: torch.dtype = torch.float32,
                            io_dtype_bytes: Optional[int] = None,
                            device="cuda") -> StreamingExecutor:
    """The float streaming executor for a chain graph on ``device``.

    ``splan`` defaults to :func:`plan_streaming` with byte accounting
    matching ``dtype`` (``io_dtype_bytes`` overrides).  Int8 goes through
    ``repro_torch.quant.exec.make_int8_streaming_executor``.
    """
    if splan is None:
        if io_dtype_bytes is None:
            io_dtype_bytes = dtype.itemsize
        splan = plan_streaming(graph, io_dtype_bytes=io_dtype_bytes)
    return StreamingExecutor(graph, splan, apply_node_fn=apply_node_fn, dtype=dtype,
                             device=device)


class PosteriorSmoother:
    """Posterior smoothing over streaming emissions (Zhang et al. §5).

    A KWS deployment acts on the last ``window`` emissions, not one:

    * ``"mean"`` — the argmax of the running mean of the emission vectors;
    * ``"vote"`` — majority vote over the per-emission argmax labels, ties
      to the smallest label.

    Host-side and stateful: one smoother per stream, fed each emission as
    it comes out of :meth:`StreamingExecutor.run` or ``StreamServer``.
    """

    def __init__(self, window: int = 3, mode: str = "mean"):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if mode not in ("mean", "vote"):
            raise ValueError(f"mode must be 'mean' or 'vote', got {mode!r}")
        self.window = int(window)
        self.mode = mode
        self._buf: List[np.ndarray] = []

    def reset(self) -> None:
        """Forget all history (stream restart)."""
        self._buf.clear()

    @property
    def posterior(self) -> Optional[np.ndarray]:
        """The running mean of the held emissions (``None`` before the
        first update), whatever the decision mode."""
        if not self._buf:
            return None
        return np.mean(np.stack(self._buf), axis=0)

    def update(self, emission) -> int:
        """Fold in one emission (1-D class vector); return the smoothed label."""
        e = np.asarray(emission, np.float32).reshape(-1)
        if self._buf and e.shape != self._buf[-1].shape:
            raise ValueError(f"emission shape {e.shape} != previous {self._buf[-1].shape}")
        self._buf.append(e)
        if len(self._buf) > self.window:
            self._buf.pop(0)
        if self.mode == "mean":
            return int(np.argmax(self.posterior))
        labels = [int(np.argmax(v)) for v in self._buf]
        return int(np.bincount(labels).argmax())


def sliding_window_reference(graph, params, frames: np.ndarray, *,
                             forward_fn: Optional[Callable] = None,
                             device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """The sliding full-window oracle of the streaming executor.

    For frame t the window is the last H rows of ``zeros ++ frames[:t+1]``
    (zero prehistory, the :meth:`StreamingExecutor.init_state` semantics),
    and an output is emitted when ``(t + 1) % E == 0``.  Returns ``(outs,
    emitted)`` shaped like :meth:`StreamingExecutor.run`'s, non-emitting
    entries holding the previous emission (the zero window's output before
    the first).

    The windows run as one batch on ``device``: ``forward_fn(params,
    windows)`` gets an (N, C, H, W) tensor, the zero window first, then one
    window per emitting frame.  It defaults to ``nn.forward`` on the chain;
    pass ``lambda _, w: quantize.simulate_int8_dag_forward(qm, w)`` for the
    int8 oracle.
    """
    seq = as_sequential(graph, caller="sliding_window_reference")
    if forward_fn is None:
        forward_fn = lambda p, w: nn.forward(seq, p, w)  # noqa: E731
    c, h, w = tuple(seq.layers[0].shape)
    e = plan_streaming(graph).emit_stride
    frames = np.asarray(frames)
    t_n = frames.shape[0]
    timeline = np.concatenate([np.zeros((h, c, w), frames.dtype), frames])  # (h+T, C, W)
    emitting = [t for t in range(t_n) if (t + 1) % e == 0]
    windows = np.stack([timeline[t + 1: t + 1 + h] for t in [-1] + emitting])  # (N, H, C, W)
    windows = np.ascontiguousarray(windows.transpose(0, 2, 1, 3))
    ys = forward_fn(params, torch.as_tensor(windows, device=resolve(device)))
    ys = ys.cpu().numpy()
    outs, k = [], 0
    for t in range(t_n):
        if (t + 1) % e == 0:
            k += 1
        outs.append(ys[k])
    return np.stack(outs), np.asarray([(t + 1) % e == 0 for t in range(t_n)])
