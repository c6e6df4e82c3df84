"""Serving steps: the bucketed executor cache shared by the engines, and
the LM prefill and decode steps, unsharded and on a mesh.

The port's counterpart of ``repro/serve/step.py``: ``bucket_for`` and
``BucketedExecutorCache`` (``step.py:68-140``), ``enable_persistent_cache``
(``step.py:34-60``), ``make_prefill_step``, ``make_decode_step``, and the
sharded ``jit_prefill_step`` / ``jit_decode_step`` (``step.py:165-220``).
The last two keep the reference's arguments and its in and out
placements: params by ``ShardingPolicy.param_specs``, the KV cache by
``cache_specs``, the batch by the caller's batch specs, ``next_tok`` and
``pos`` split over the data axes when the batch divides them, a decode
step's ``memory`` likewise, and the logits whole on the mesh's first
device.  PyTorch runs them eagerly (:class:`ShardedPrefillStep`,
:class:`ShardedDecodeStep`): each data row in turn walks the model's own
``prefill`` / ``decode_step`` with each layer's attention, FFN and
recurrent block split over the row's model coordinates and the KV cache
and recurrent state read on their shards
(:class:`repro_torch.sharding.tensor_parallel.RowOps`).  A prompt whose
sequence the batch specs split over the data axes (batch 1) is prefilled
span by span, each data row its own (``Model.prefill_span``).

Requests pad up to the nearest bucket, so an executor only ever sees the
batch sizes on the ladder; in the port, preparing a bucket means running its
executor once, which allocates the bucket's arena and builds the kernels.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.device import current
from repro_torch.kernels import build
from repro_torch.sharding import placement as pl
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.placement import Spec
from repro_torch.tree import tree_map


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


# ---------------------------------------------------------------------------
# The sharded steps
# ---------------------------------------------------------------------------

# a fresh placed cache: positions -1 (empty), the int8 scales at the floor
# the unsharded prefill leaves in every slot it does not write, else zeros
_CACHE_INIT = {"pos": -1, "k_scale": 1e-8, "v_scale": 1e-8}


def _rows_of(x, row: tp.Row) -> torch.Tensor:
    """The row's rows of ``x`` (a whole tensor, or a :class:`Placed` split
    over the data axes or not) on the row's device; the row's own block
    when it holds exactly them (no copy)."""
    region = (row.rows,) + tuple((0, d) for d in x.shape[1:])
    if isinstance(x, pl.Placed):
        if x.region_at(row.coords[0]) == region:
            return x.shard(row.coords[0])
        return pl.read_region(x, region, row.device)
    return x[row.rows[0]:row.rows[1]].to(row.device)


class _ShardedServeStep:
    """What the sharded prefill and decode steps share: the placements and
    the data rows.  Each row walks the model through ``Model.prefill`` /
    ``decode_step`` with :class:`repro_torch.sharding.tensor_parallel.RowOps`."""

    def __init__(self, model, policy, abstract_params, abstract_cache, batch: int,
                 max_seq: int):
        self.model, self.batch, self.max_seq = model, batch, max_seq
        self.mesh = policy.mesh
        self.param_shardings = policy.shardings(policy.param_specs(abstract_params))
        self.cache_shardings = policy.shardings(policy.cache_specs(abstract_cache, batch))
        self.abstract_cache = abstract_cache
        self.coords_by_row = tp.data_rows(self.mesh, policy.dp)
        self.home = self.mesh.device(self.coords_by_row[0][0])
        batch_ax = policy.dp if batch % policy.dp_size == 0 else None
        self.batch_split = batch_ax is not None
        self.tok_sharding = policy.named(Spec((batch_ax, None)))
        self.pos_sharding = policy.named(Spec((batch_ax,)))
        self.memory_sharding = policy.named(Spec((batch_ax, None, None)))

    def _params(self, params):
        return tree_map(pl.as_placed, params, self.param_shardings)

    def _rows(self, split: bool) -> List[tp.Row]:
        return tp.rows_at_work(self.mesh, self.coords_by_row, self.batch, split)


class ShardedPrefillStep(_ShardedServeStep):
    """``step(params, batch) -> (cache, logits)`` on a mesh, the port's
    ``jit_prefill_step``.

    * **In:** params placed by the policy's param specs (a whole tensor is
      placed on the way in; a leaf placed by other specs raises), the batch
      (``tokens`` (B, S), or ``embeds`` (B, S, D); ``src_embeds`` for an
      enc-dec config, encoded first) as whole tensors.
    * **Each data row** computes its contiguous rows when the batch specs
      split the batch over the data axes.  When they split the sequence
      (batch 1, the reference's sequence parallelism), data row j computes
      the prompt's positions ``[j S / dp, (j + 1) S / dp)``, the rows in
      order, still split along ``"model"``: its attention reads the K/V the
      rows before computed (K5 with its first position as the query
      offset), its recurrent layers start from the state the row before
      wrote into the cache, its MoE router from their slot counts; each row
      writes its slots of the cache (split on length across ``("data",
      "model")``, or on heads), and the logits are the last row's.  A
      prompt the data rows do not divide raises, as the reference's jit
      does.  An enc-dec config's ``src_embeds`` (B, T, D) split likewise:
      data row j encodes the frames ``[j T / dp, (j + 1) T / dp)``, layer by
      layer over every row's K/V
      (:func:`repro_torch.sharding.tensor_parallel.encode_over_rows`), and
      each row's cross sub-blocks read the rows' memory spans joined once
      on each device; a number of frames the data rows do not divide raises
      too.  Any other batch runs whole on the first data row.
    * **Out:** the cache placed by ``cache_specs``, fresh each call (its
      blocks made on their devices), and the last-token logits (B, V) f32
      whole on the mesh's first device.
    """

    def __init__(self, model, policy, abstract_params, abstract_cache, batch_specs: dict,
                 batch: int, max_seq: int):
        super().__init__(model, policy, abstract_params, abstract_cache, batch, max_seq)
        self.split_rows = tp.splits_rows(batch_specs, policy.dp)
        self.split_seq = not self.split_rows and tp.splits_sequence(batch_specs, policy.dp)

    def fresh_cache(self) -> list:
        """A placed cache of the step's batch, every slot empty."""
        return [{name: pl.full(sh, leaf.shape, leaf.dtype, _CACHE_INIT.get(name, 0))
                 for (name, leaf), sh in zip(layer.items(), shs.values())}
                for layer, shs in zip(self.abstract_cache, self.cache_shardings)]

    def __call__(self, params, batch: dict):
        B = next(iter(batch.values())).shape[0]
        if B != self.batch:
            raise ValueError(f"a batch of {B} for a step built for {self.batch}")
        params = self._params(params)
        cache = self.fresh_cache()
        if self.split_seq:
            return cache, self._over_sequence(params, batch, cache)
        logits = []
        for row in self._rows(self.split_rows):
            part = {k: _rows_of(v, row) for k, v in batch.items()}
            _, lg = self.model.prefill(params, part, self.max_seq,
                                       ops=tp.RowOps(self.model.cfg, row), states=cache)
            logits.append(lg.to(self.home))
        return cache, torch.cat(logits)

    def _over_sequence(self, params, batch: dict, cache: list) -> torch.Tensor:
        """The prompt span by span over the data rows into ``cache`` (an
        enc-dec config's frames encoded over the rows first); its last-token
        logits on the mesh's first device."""
        x = batch["embeds"] if "embeds" in batch else batch["tokens"]
        rows = tp.rows_over_sequence(self.mesh, self.coords_by_row, self.batch, x.shape[1])
        cfg = self.model.cfg
        memory = None
        if cfg.is_encdec and "src_embeds" in batch:
            memory = tp.memory_by_device(
                tp.encode_over_rows(self.model, params, batch["src_embeds"], self.mesh,
                                    self.coords_by_row), rows)
        carry = None
        for row in rows:
            part = {k: tp.span_of(v, row) for k, v in batch.items() if k != "src_embeds"}
            with current(row.device):
                _, logits, carry = self.model.prefill_span(
                    params, part, self.max_seq, cache, row.span, carry,
                    ops=tp.RowOps(cfg, row), memory=memory)
        return logits.to(self.home)


class ShardedDecodeStep(_ShardedServeStep):
    """``step(params, cache, tokens, pos[, memory]) -> (next_tok, logits,
    cache)`` on a mesh, the port's ``jit_decode_step``: one greedy token
    for the whole batch.

    * **In:** params as :class:`ShardedPrefillStep`; the cache placed by
      ``cache_specs`` (a whole cache is placed on the way in); ``tokens``
      (B, 1) and ``pos`` (B,) (or an int) whole, or placed as ``next_tok``
      comes out; an enc-dec config's encoder output ``memory`` (B, T, D)
      when built ``with_memory``.
    * **Each data row** computes its rows when the data axes divide the
      batch, else the first computes them all.
    * **Out:** ``next_tok`` (B, 1) int32 placed by ``tok_sharding`` (split
      over the data axes when they divide the batch), the logits (B, V) f32
      whole on the mesh's first device, and the cache, updated in place
      with ``donate`` (else a copy).
    """

    def __init__(self, model, policy, abstract_params, abstract_cache, batch: int,
                 max_seq: int, with_memory: bool = False, donate: bool = True):
        super().__init__(model, policy, abstract_params, abstract_cache, batch, max_seq)
        self.with_memory, self.donate = with_memory, donate

    def __call__(self, params, cache, tokens, pos, memory=None):
        if (memory is not None) != self.with_memory:
            raise TypeError("the step takes a memory" if self.with_memory
                            else "the step was built without with_memory")
        params = self._params(params)
        cache = tree_map(lambda x, s: pl.as_placed(x, s, self.donate), cache,
                         self.cache_shardings)
        if not isinstance(pos, (torch.Tensor, pl.Placed)) or pos.ndim == 0:
            pos = torch.full((self.batch,), int(pos), dtype=torch.int32)
        logits = []
        for row in self._rows(self.batch_split):
            mem = None if memory is None else _rows_of(memory, row)
            lg, _ = self.model.decode_step(params, cache, _rows_of(tokens, row),
                                           _rows_of(pos, row).to(torch.int32), self.max_seq,
                                           mem, ops=tp.RowOps(self.model.cfg, row))
            logits.append(lg.to(self.home))
        logits = torch.cat(logits)
        next_tok = pl.place(torch.argmax(logits, dim=-1)[:, None].to(torch.int32),
                            self.tok_sharding)
        return next_tok, logits, cache


def jit_decode_step(model, policy, abstract_params, abstract_cache, batch: int, max_seq: int,
                    with_memory: bool = False, donate: bool = True) -> ShardedDecodeStep:
    """The sharded decode step on ``policy.mesh`` (:class:`ShardedDecodeStep`),
    with the reference's arguments and placements.  ``abstract_params`` /
    ``abstract_cache``: the trees, concrete or ``meta``
    (``repro_torch.launch.inputs``)."""
    return ShardedDecodeStep(model, policy, abstract_params, abstract_cache, batch, max_seq,
                             with_memory, donate)


def jit_prefill_step(model, policy, abstract_params, abstract_cache, batch_specs: dict,
                     batch: int, max_seq: int) -> ShardedPrefillStep:
    """The sharded prefill step on ``policy.mesh`` (:class:`ShardedPrefillStep`),
    with the reference's arguments and placements."""
    return ShardedPrefillStep(model, policy, abstract_params, abstract_cache, batch_specs,
                              batch, max_seq)
