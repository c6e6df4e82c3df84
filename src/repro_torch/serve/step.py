"""Serving steps: the bucketed executor cache shared by the engines, and
the LM prefill and decode steps.

The port's counterpart of ``repro/serve/step.py``: ``bucket_for`` and
``BucketedExecutorCache`` (``step.py:68-140``), ``enable_persistent_cache``
(``step.py:34-60``), ``make_prefill_step`` and ``make_decode_step``.
PyTorch runs eagerly, and the sharded ``jit_prefill_step`` /
``jit_decode_step`` have no counterpart: a KV cache placed by
``ShardingPolicy.cache_specs`` (ported, and read by
``repro_torch.launch.dryrun``) pays only with attention computed on its
shards, which waits for tensor-parallel compute (ROADMAP.md item 6f).

Requests pad up to the nearest bucket, so an executor only ever sees the
batch sizes on the ladder; in the port, preparing a bucket means running its
executor once, which allocates the bucket's arena and builds the kernels.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from repro_torch.kernels import build


def enable_persistent_cache(cache_dir) -> str:
    """Keep the compiled kernels in ``cache_dir``, across processes.

    The port has no XLA compile: its compiled artifacts are the
    ``nvcc``-built kernel libraries (`repro_torch.kernels.build`).  From
    now on they are built into and loaded from ``cache_dir``, so a fresh
    process (a replica spawning) that finds them there loads them without
    running ``nvcc``.  Process-global, as the reference's cache; calling
    again with the same directory does nothing, with a different one
    repoints it.  Returns ``cache_dir``."""
    build.use_build_dir(cache_dir)
    return str(cache_dir)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n from an ascending ladder (requests pad up)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    for b in buckets:
        if b >= n:
            return int(b)
    raise ValueError(f"batch {n} exceeds the largest bucket {buckets[-1]}")


class BucketedExecutorCache:
    """Batch-bucket ladder → prepared executable, built once per bucket.

    ``lower_fn(bucket)`` produces the callable for one batch size.  One
    entry per bucket, no rebuilds; ``misses`` counts how many preparations
    actually ran.  Pass ``metrics`` (a
    :class:`repro_torch.obs.metrics.MetricsRegistry`) to record
    ``executor_cache.hits`` / ``.lowerings`` counters and an
    ``executor_cache.lower_s`` histogram.
    """

    def __init__(
        self,
        lower_fn: Callable[[int], Any],
        buckets: Sequence[int],
        *,
        prewarm: bool = True,
        metrics=None,
    ):
        if not buckets:
            raise ValueError("need at least one bucket")
        self.buckets: Tuple[int, ...] = tuple(sorted({int(b) for b in buckets}))
        self._lower = lower_fn
        self._compiled: Dict[int, Any] = {}
        self._metrics = metrics
        if prewarm:
            for b in self.buckets:
                self.get(b)

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    def get(self, bucket: int) -> Any:
        """The prepared executable for one exact bucket size."""
        if bucket not in self.buckets:
            raise KeyError(f"{bucket} is not on the ladder {self.buckets}")
        hit = self._compiled.get(bucket)
        if hit is None:
            t0 = time.monotonic()
            hit = self._compiled[bucket] = self._lower(bucket)
            if self._metrics is not None:
                self._metrics.inc("executor_cache.lowerings")
                self._metrics.observe(
                    "executor_cache.lower_s", time.monotonic() - t0)
        elif self._metrics is not None:
            self._metrics.inc("executor_cache.hits")
        return hit

    def for_batch(self, n: int) -> Tuple[int, Any]:
        """(bucket, executable) serving a batch of n requests (pads up)."""
        b = self.bucket_for(n)
        return b, self.get(b)

    @property
    def misses(self) -> int:
        """How many buckets have been prepared."""
        return len(self._compiled)


def make_decode_step(model, max_seq: int):
    """``(params, cache, tokens, pos, memory=None) -> (next_tok (B, 1)
    int32, logits, cache)``: one decode step with greedy sampling in-step;
    an enc-dec config takes its encoder output as ``memory``."""
    def decode_step(params, cache, tokens, pos, memory=None):
        logits, cache = model.decode_step(params, cache, tokens, pos, max_seq, memory=memory)
        next_tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return next_tok, logits, cache

    return decode_step


def make_prefill_step(model, max_seq: int):
    """``(params, batch) -> (cache, logits)``: one prompt pass."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_seq)

    return prefill_step
