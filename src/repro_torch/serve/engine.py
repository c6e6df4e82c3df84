"""Batched LM serving engine: prefill + decode lanes over a planned KV arena.

The port's counterpart of ``repro/serve/engine.py``.  The engine keeps a
fixed number of decode *lanes* (the batch dimension of the decode step).
Requests are admitted into free lanes in order, prefilled one at a time
(their prompt processed into a single-lane cache, whose lane is then copied
into the engine's cache), then all lanes step together; finished lanes are
recycled — continuous batching in its simplest correct form, in the
reference's order, with its ``prefill`` and ``decode`` tracer spans.

Every prefill runs the model's kernels (K5 for attention layers, K7 for
RWKV layers) on the card.  The decode step is plain PyTorch, as the
reference's is outside any Pallas kernel, with greedy sampling in-step
(:func:`repro_torch.serve.step.make_decode_step`); the host reads the next
tokens once per step and the first token once per admission, as the
reference does.

The KV/state arena for the lanes is allocated once at construction and
updated in place; :meth:`Engine.plan_report` gives its bytes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.step import BucketedExecutorCache, make_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_out: int = 0
    wall_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0


def _leaves(tree):
    if isinstance(tree, dict):
        tree = tree.values()
    for t in tree:
        if isinstance(t, (dict, list, tuple)):
            yield from _leaves(t)
        else:
            yield t


def cache_bytes(cache) -> int:
    """Bytes of every tensor in a cache (any nesting of lists and dicts)."""
    return sum(t.numel() * t.element_size() for t in _leaves(cache))


def _insert_lane(cache: List[dict], cache1: List[dict], lane: int) -> None:
    """Copy lane 0 of a fresh single-lane prefill cache into lane ``lane``
    of the engine cache, in place (every leaf has the lane on axis 0)."""
    for layer, layer1 in zip(cache, cache1):
        for key, dst in layer.items():
            dst[lane].copy_(layer1[key][0])


class Engine:
    def __init__(self, model, params, *, lanes: int, max_seq: int, device="cuda",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.device = resolve(device)
        self.model = model
        self.params = params
        self.lanes = lanes
        self.max_seq = max_seq
        self.cache = model.init_cache(lanes, max_seq, device=self.device)
        self.lane_req: List[Optional[Request]] = [None] * lanes
        self.lane_pos = np.zeros(lanes, np.int32)  # next position per lane
        self.stats = EngineStats()
        self.tracer = tracer or NULL_TRACER
        self.metrics = metrics or MetricsRegistry("llm_engine")
        # The decode step lives in the shared bucketed cache (one bucket:
        # the lane count), as in the reference.
        self._decode_cache = BucketedExecutorCache(
            lambda b: make_decode_step(model, max_seq), buckets=(lanes,),
            metrics=self.metrics)
        self._decode = self._decode_cache.get(lanes)

    # -- admission -------------------------------------------------------------
    def _admit(self, req: Request, lane: int) -> None:
        """Prefill one request into one lane (single-lane prefill)."""
        # The last decode step writes position P + max_new - 2, and a lane
        # left idle keeps writing at P + max_new - 1: both must be slots.
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_seq:
            raise ValueError(f"request {req.rid}: {len(req.prompt)} prompt tokens and "
                             f"{req.max_new_tokens} new need {need} cache slots, more "
                             f"than max_seq={self.max_seq}")
        with self.tracer.span("prefill", rid=req.rid, lane=lane,
                              prompt_len=len(req.prompt)):
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int32)[None],
                                     device=self.device)
            cache1, logits = self.model.prefill(self.params, {"tokens": prompt},
                                                self.max_seq)
            _insert_lane(self.cache, cache1, lane)
            first = int(torch.argmax(logits[0]))
        req.out_tokens.append(first)
        self.lane_req[lane] = req
        self.lane_pos[lane] = len(req.prompt)
        self.stats.prefills += 1
        self.stats.tokens_out += 1
        self.metrics.inc("engine.prefills")

    # -- main loop ---------------------------------------------------------------
    def run(self, requests: List[Request], eos: Optional[int] = None) -> EngineStats:
        pending = list(requests)
        t0 = time.perf_counter()
        while pending or any(r is not None for r in self.lane_req):
            # fill free lanes
            for lane in range(self.lanes):
                if self.lane_req[lane] is None and pending:
                    self._admit(pending.pop(0), lane)
            # batched decode step for all active lanes
            active = [i for i, r in enumerate(self.lane_req) if r is not None]
            if not active:
                break
            tr = self.tracer
            if tr.enabled:
                tr.counter("active_lanes", active=len(active))
            toks = np.zeros((self.lanes, 1), np.int32)
            for i in active:
                toks[i, 0] = self.lane_req[i].out_tokens[-1]
            with tr.span("decode", step=self.stats.decode_steps, active=len(active)):
                nxt, _, self.cache = self._decode(
                    self.params, self.cache, torch.as_tensor(toks, device=self.device),
                    torch.as_tensor(self.lane_pos, device=self.device))
                nxt = nxt[:, 0].cpu().numpy()
            self.stats.decode_steps += 1
            self.metrics.inc("engine.decode_steps")
            self.metrics.set_gauge("engine.active_lanes", len(active))
            for i in active:
                req = self.lane_req[i]
                tok = int(nxt[i])
                req.out_tokens.append(tok)
                self.stats.tokens_out += 1
                self.lane_pos[i] += 1
                if (eos is not None and tok == eos) or len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
                    self.lane_req[i] = None
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats

    # -- paper-planner integration -------------------------------------------------
    def plan_report(self) -> Dict[str, int]:
        """Static arena accounting for this engine configuration."""
        kv = cache_bytes(self.cache)
        d = self.model.cfg.d_model
        act = 2 * self.lanes * 1 * d * 4  # ping-pong pair of decode activations
        return {"kv_state_bytes": kv, "pingpong_activation_bytes": act,
                "total_bytes": kv + act}
