"""Continuous-batching CNN serving engine over the arena executors.

The port's counterpart of ``repro/serve/cnn_engine.py`` (``CNNEngine`` with
``from_graph`` / ``from_quantized``, sequential and DAG graphs): a deployed
vision or keyword endpoint sees variable-arrival single-image traffic, and
its throughput comes from dynamic batching and from keeping the executors
and their arenas resident across steps.

* **Bucket ladder** — one arena per batch size on a small ladder (1/2/4/8/16
  by default), each prepared at construction (one run of the executor:
  the kernels are built, the bucket's ``(N, arena_elems)`` arena is
  allocated), held in :class:`repro_torch.serve.step.BucketedExecutorCache`.
  Batches pad up to the nearest bucket; padding outputs are dropped.
* **Ping-pong staging banks** — each bucket owns two host staging tensors,
  pinned on CUDA, alternated between consecutive dispatches.  The copy to
  the card is asynchronous, so each bank carries a CUDA event recorded
  after its copy, and the dispatcher waits on it before restaging that bank.
* **Async host pipeline** — a dispatcher thread coalesces, stages, copies
  and launches on the engine's own CUDA stream, then enqueues the copy of
  the result into pinned host memory and records an event; a completer
  thread waits on that event, scatters the outputs and stamps completion
  times.  Both threads' work on the card is ordered on the one stream.  The
  handoff queue holds at most one batch in flight.
* **Coalescing policy** — take the first queued request, then keep draining
  until ``max_batch`` requests are in hand or ``max_wait_s`` has passed.
* **Data-parallel mesh** — pass ``mesh=`` (a
  `repro_torch.launch.mesh.DataMesh`) to the constructors to split every
  bucket's batch over the mesh's devices
  (`repro_torch.sharding.policy.DataParallelPolicy`): weights replicate
  once, buckets round **up** to mesh-size multiples (1/2/4/8/16 on 4
  devices → 4/8/16), each device runs the whole arena executor on its
  shard, and the outputs gather onto the mesh's first device, the engine's
  device.  The extra lanes are ordinary padding lanes, which never change
  a real row.  Outputs are bit-exact against the engine without a mesh in
  int8, and in f32 where the device's kernels give a row the same bits in
  a shard as in the whole batch (``chip_smoke.py``'s ``mesh`` phase records
  this on the card; the CPU's BLAS differs below 6 rows).
* **Persistent kernel cache** — ``persistent_cache_dir=`` keeps the built
  kernels in a directory (`repro_torch.serve.step.enable_persistent_cache`),
  so a fresh replica loads them without running ``nvcc``.

:class:`StreamServer` is the session mode of keyword spotting: one ring state
per open audio stream, one MFCC frame a push (`repro_torch.core.streaming`).

Numerics are the wrapped executor's: engine outputs equal the executor's at
the same bucket, and padding lanes never change a real lane.  There is no
CUDA graph capture yet: a replay would not tick the kernels' launch
counters, which are how a run shows it went through the kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pingpong
from repro_torch.core.graph import DAGGraph
from repro_torch.device import resolve
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.step import BucketedExecutorCache, enable_persistent_cache

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)
_NUMPY_DTYPES = {torch.float32: np.float32, torch.int8: np.int8}


@dataclasses.dataclass(frozen=True)
class CoalescePolicy:
    """When the dispatcher closes a batch: at most ``max_batch`` requests,
    or ``max_wait_s`` after the first request taken for it."""

    max_batch: int = 16
    max_wait_s: float = 0.002


@dataclasses.dataclass
class CNNRequest:
    """One single-image inference request."""

    rid: int
    x: np.ndarray
    t_submit: float = 0.0
    t_done: float = 0.0
    y: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False
    )

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not completed")
        if self.error is not None:
            raise RuntimeError(f"request {self.rid} failed") from self.error
        return self.y


@dataclasses.dataclass
class ServeStats:
    """Engine-side accounting for one serving run.

    The dispatcher and completer threads both mutate an instance, so every
    mutation and every multi-field read goes through ``_lock``;
    :meth:`snapshot` returns a frozen-in-time copy.
    """

    requests: int = 0
    batches: int = 0
    padded_lanes: int = 0
    bucket_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    prewarm_s: float = 0.0
    compiles: int = 0
    # init=False: dataclasses.replace / snapshot give the copy its own lock.
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, repr=False, compare=False
    )

    @property
    def qps(self) -> float:
        return self.requests / self.wall_s if self.wall_s else 0.0

    @property
    def avg_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0

    @property
    def padding_frac(self) -> float:
        lanes = self.requests + self.padded_lanes
        return self.padded_lanes / lanes if lanes else 0.0

    def record_batch(self, bucket: int, n: int) -> int:
        """Account one dispatched batch; returns its 0-based batch id."""
        with self._lock:
            bid = self.batches
            self.batches += 1
            self.requests += n
            self.padded_lanes += bucket - n
            self.bucket_hist[bucket] = self.bucket_hist.get(bucket, 0) + 1
            return bid

    def record_latencies(self, latencies_s) -> None:
        with self._lock:
            self.latencies_s.extend(latencies_s)

    def latency_count(self) -> int:
        with self._lock:
            return len(self.latencies_s)

    def snapshot(self) -> "ServeStats":
        """A consistent point-in-time copy (mutable fields copied)."""
        with self._lock:
            return dataclasses.replace(
                self,
                bucket_hist=dict(self.bucket_hist),
                latencies_s=list(self.latencies_s),
            )

    def latency_ms(self, pct: float) -> float:
        """The ``pct`` latency percentile in milliseconds: ``0.0`` for an
        empty window (a sentinel, not a measurement), the sample itself for
        a single-sample window."""
        with self._lock:
            xs = list(self.latencies_s)
        if not xs:
            return 0.0
        return float(np.percentile(np.asarray(xs), pct) * 1e3)

    def summary(self) -> Dict[str, float]:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "avg_batch": round(self.avg_batch, 2),
            "padding_frac": round(self.padding_frac, 4),
            "qps": round(self.qps, 1),
            "p50_ms": round(self.latency_ms(50), 3),
            "p95_ms": round(self.latency_ms(95), 3),
            "p99_ms": round(self.latency_ms(99), 3),
        }


class CNNEngine:
    """Continuous-batching engine over one arena executor.

    ``executor_fn`` is a ``(params, x) -> y`` executor from
    ``pingpong.make_scan_executor``, ``pingpong.make_dag_executor`` or
    ``quant.exec.make_int8_executor``;
    ``params`` live on ``device``.  ``data_parallel`` (a
    ``DataParallelPolicy`` whose mesh's first device is ``device``) splits
    each batch over its mesh.  Use as a context manager, or call
    :meth:`start` / :meth:`stop`.
    """

    def __init__(
        self,
        executor_fn,
        params,
        in_shape: Sequence[int],
        dtype: torch.dtype,
        *,
        device="cuda",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        policy: Optional[CoalescePolicy] = None,
        prewarm: bool = True,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        data_parallel=None,
        persistent_cache_dir: Optional[str] = None,
    ):
        # Before the ladder is prepared, so its kernels load from the cache.
        if persistent_cache_dir is not None:
            enable_persistent_cache(persistent_cache_dir)
        self.device = resolve(device)
        self.in_shape = tuple(int(d) for d in in_shape)
        self.dtype = dtype
        self.np_dtype = _NUMPY_DTYPES[dtype]
        self.policy = policy or CoalescePolicy()
        # Read per event by the worker loops, so a caller may swap in an
        # enabled Tracer on a running engine; defaults to the shared no-op.
        self.tracer = tracer or NULL_TRACER
        self.metrics = metrics or MetricsRegistry("cnn_engine")
        self.executor = executor_fn
        self.data_parallel = data_parallel
        if data_parallel is not None:
            if data_parallel.devices[0] != self.device:
                raise ValueError(f"the mesh gathers on {data_parallel.devices[0]}, "
                                 f"the engine runs on {self.device}")
            params = data_parallel.replicate(params)
            buckets = tuple(data_parallel.padded_batch(b) for b in buckets)
            self._run = data_parallel.wrap_batched(executor_fn)
        else:
            self._run = executor_fn
        self.params = params
        buckets = tuple(sorted({int(b) for b in buckets}))
        if self.policy.max_batch > buckets[-1]:
            self.policy = dataclasses.replace(self.policy, max_batch=buckets[-1])
        cuda = self.device.type == "cuda"
        # One stream for both worker threads: the current stream is per
        # thread, so each enters this one explicitly.
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        t0 = time.perf_counter()
        self._cache = BucketedExecutorCache(
            self._prepare, buckets, prewarm=prewarm, metrics=self.metrics)
        self.stats = ServeStats(
            prewarm_s=time.perf_counter() - t0 if prewarm else 0.0)
        self.metrics.set_gauge("engine.prewarm_s", self.stats.prewarm_s)
        # Two host staging banks per bucket (pinned on CUDA), alternated
        # between consecutive dispatches, each with the event of its last
        # copy to the card.
        self._banks: Dict[int, List[torch.Tensor]] = {
            b: [torch.zeros((b, *self.in_shape), dtype=dtype, pin_memory=cuda)
                for _ in range(2)]
            for b in buckets
        }
        self._copied: Dict[int, List[Optional[torch.cuda.Event]]] = {
            b: [None, None] for b in buckets}
        self._bank_idx: Dict[int, int] = {b: 0 for b in buckets}
        self._queue: "queue.Queue[CNNRequest]" = queue.Queue()
        # Depth-1 handoff: (host output, its event, requests, batch, bucket).
        self._inflight: "queue.Queue[tuple]" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._rid = 0
        self._lock = threading.Lock()

    # -- constructors ----------------------------------------------------------

    @staticmethod
    def _placement(device, mesh):
        """(engine device, policy or None) for ``device`` and ``mesh``: with
        a mesh, the engine runs on (and gathers onto) the mesh's first
        device, which must be of ``device``'s type."""
        dev = resolve(device)
        if mesh is None:
            return dev, None
        from repro_torch.sharding.policy import DataParallelPolicy

        dp = DataParallelPolicy(mesh)
        if dp.devices[0].type != dev.type:
            raise ValueError(f"mesh on {dp.devices[0]} for an engine on {dev}")
        return dp.devices[0], dp

    @classmethod
    def from_graph(cls, graph, plan, params, *, device="cuda", mesh=None,
                   **kw) -> "CNNEngine":
        """Float engine for a (graph, plan) pair on ``device``: a DAG graph
        through the DAG arena executor (its plan from ``schedule.plan_dag``),
        a sequential one through the sequential arena executor.  ``mesh``
        splits every bucket's batch over a ``("data",)`` device mesh
        (``launch.mesh.make_data_mesh()``); ``persistent_cache_dir=`` keeps
        the built kernels in a directory."""
        dev, dp = cls._placement(device, mesh)
        params = {k: {kk: v.to(dev) for kk, v in p.items()}
                  for k, p in params.items()}
        if isinstance(graph, DAGGraph):
            fn = pingpong.make_dag_executor(graph, plan)
        else:
            fn = pingpong.make_scan_executor(graph, plan)
        return cls(fn, params, tuple(graph.layers[0].shape), torch.float32,
                   device=dev, data_parallel=dp, **kw)

    @classmethod
    def from_quantized(cls, qm, plan, *, device="cuda", mesh=None,
                       **kw) -> "CNNEngine":
        """Int8 engine for a quantized model (sequential or DAG): int8 wire
        format and int8 arena banks, at a quarter of the float bytes.
        ``mesh`` and ``persistent_cache_dir`` as in :meth:`from_graph`."""
        from repro_torch.quant.exec import make_int8_executor

        dev, dp = cls._placement(device, mesh)
        fn, params = make_int8_executor(qm, plan, device=dev)
        return cls(fn, params, tuple(qm.graph.layers[0].shape), torch.int8,
                   device=dev, data_parallel=dp, **kw)

    # -- lifecycle -------------------------------------------------------------

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _prepare(self, bucket: int):
        """Run the executor once at this bucket: builds the kernels and
        allocates the bucket's arena before any request arrives."""
        x = torch.zeros((bucket, *self.in_shape), dtype=self.dtype,
                        device=self.device)
        with self._on_stream():
            self._run(self.params, x)
        if self._stream is not None:
            self._stream.synchronize()
        return self._run

    def start(self) -> "CNNEngine":
        if self._threads:
            return self
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="cnn-engine-dispatch"),
            threading.Thread(target=self._complete_loop, daemon=True,
                             name="cnn-engine-complete"),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """Drain outstanding work, then stop the worker threads."""
        if not self._threads:
            return
        self._queue.join()
        self._inflight.join()
        self._stop.set()
        for t in self._threads:
            t.join()
        self._threads = []

    def __enter__(self) -> "CNNEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path ----------------------------------------------------------

    def submit(self, x: np.ndarray) -> CNNRequest:
        """Enqueue one image; returns a handle with ``.result(timeout)``."""
        if not self._threads:
            raise RuntimeError("engine not started (use `with engine:`)")
        x = np.asarray(x, self.np_dtype)
        if x.shape != self.in_shape:
            raise ValueError(f"request shape {x.shape} != {self.in_shape}")
        with self._lock:
            rid = self._rid
            self._rid += 1
        req = CNNRequest(rid=rid, x=x, t_submit=time.perf_counter())
        tr = self.tracer
        if tr.enabled:
            tr.async_begin("request", rid)
            tr.counter("queue_depth", depth=self._queue.qsize() + 1)
        self._queue.put(req)
        return req

    def serve(
        self,
        images: np.ndarray,
        arrivals_s: Optional[Sequence[float]] = None,
    ) -> Tuple[List[CNNRequest], ServeStats]:
        """Replay a trace: submit ``images[i]`` at ``arrivals_s[i]`` (seconds
        from the start; ``None`` = all at once), wait for completion, and
        return (requests, stats for this run)."""
        before = self.stats.latency_count()
        t0 = time.perf_counter()
        reqs = []
        for i in range(len(images)):
            if arrivals_s is not None:
                delay = t0 + arrivals_s[i] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            reqs.append(self.submit(images[i]))
        for r in reqs:
            r.result(timeout=120.0)
        snap = self.stats.snapshot()
        run = dataclasses.replace(
            snap,
            requests=len(reqs),
            latencies_s=snap.latencies_s[before:],
            wall_s=time.perf_counter() - t0,
            compiles=self._cache.misses,
        )
        return reqs, run

    # -- worker loops ----------------------------------------------------------

    def _coalesce(self) -> List[CNNRequest]:
        """Take one batch off the queue under the coalescing policy."""
        try:
            first = self._queue.get(timeout=0.01)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.policy.max_wait_s
        while len(batch) < self.policy.max_batch:
            timeout = deadline - time.perf_counter()
            try:
                if timeout <= 0:
                    # past the deadline: take only what is already queued
                    batch.append(self._queue.get_nowait())
                else:
                    batch.append(self._queue.get(timeout=timeout))
            except queue.Empty:
                break
        return batch

    def _dispatch_loop(self) -> None:
        self.tracer.name_thread("cnn-engine-dispatch")
        with self._on_stream():
            while not (self._stop.is_set() and self._queue.empty()):
                t_coal = time.monotonic()
                batch = self._coalesce()
                if not batch:
                    continue
                try:
                    self._dispatch(batch, t_coal)
                except Exception as exc:  # noqa: BLE001 - the loop must go on
                    # Fail this batch's requests with the cause and keep
                    # serving: a request never waits on a dead thread.
                    self.metrics.inc("engine.failed_batches")
                    for r in batch:
                        r.error = exc
                        r._done.set()
                finally:
                    for _ in batch:
                        self._queue.task_done()

    def _dispatch(self, batch: List[CNNRequest], t_coal: float) -> None:
        tr = self.tracer  # re-read: callers may enable tracing mid-run
        n = len(batch)
        bucket, executor = self._cache.for_batch(n)
        bid = self.stats.record_batch(bucket, n)
        if tr.enabled:
            tr.complete("coalesce", t_coal, batch=bid, n=n)
            tr.counter("queue_depth", depth=self._queue.qsize())
            tr.counter("batch_occupancy", n=n, bucket=bucket)
        idx = self._bank_idx[bucket]
        self._bank_idx[bucket] = 1 - idx
        bank = self._banks[bucket][idx]
        with tr.span("stage", batch=bid, bucket=bucket, n=n):
            copied = self._copied[bucket][idx]
            if copied is not None:
                copied.synchronize()  # its last copy to the card is done
            host = bank.numpy()
            for i, r in enumerate(batch):
                host[i] = r.x
            if n < bucket:
                host[n:] = 0
        with tr.span("dispatch", batch=bid, bucket=bucket, n=n):
            x = bank.to(self.device, non_blocking=True)
            if self._stream is not None:
                self._copied[bucket][idx] = ev = torch.cuda.Event()
                ev.record(self._stream)
            y = executor(self.params, x)
            done = None
            if self._stream is not None:
                y_host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                y_host.copy_(y, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
                y = y_host
        self._inflight.put((y, done, batch, bid, bucket))
        self.metrics.inc("engine.batches")
        self.metrics.inc("engine.padded_lanes", bucket - n)
        self.metrics.observe("engine.batch_occupancy", n)
        self.metrics.set_gauge("engine.queue_depth", self._queue.qsize())

    def _complete_loop(self) -> None:
        self.tracer.name_thread("cnn-engine-complete")
        while not (self._stop.is_set() and self._inflight.empty()):
            try:
                y, done, batch, bid, bucket = self._inflight.get(timeout=0.01)
            except queue.Empty:
                continue
            tr = self.tracer
            with tr.span("device", batch=bid, bucket=bucket, n=len(batch)):
                if done is not None:
                    done.synchronize()  # the result has reached host memory
                # copy: a pinned block goes back to the allocator's cache
                out = y.numpy().copy()
            with tr.span("complete", batch=bid, bucket=bucket, n=len(batch)):
                t_done = time.perf_counter()
                for i, r in enumerate(batch):
                    r.y = out[i]
                    r.t_done = t_done
                    r._done.set()
                    if tr.enabled:
                        tr.async_end("request", r.rid, batch=bid,
                                     bucket=bucket, lane=i)
            self.stats.record_latencies(r.latency_s for r in batch)
            for r in batch:
                self.metrics.observe("engine.latency_s", r.latency_s)
            self._inflight.task_done()


# ---------------------------------------------------------------------------
# Streaming session mode (per-frame KWS serving)
# ---------------------------------------------------------------------------


class StreamServer:
    """Session-mode serving for the streaming executor.

    A KWS deployment holds one open audio stream per client and consumes
    one MFCC frame at a time, so the unit of serving state is a *session*:
    this server keeps one ring state per stream id on ``device``, and every
    stream shares the one prewarmed per-frame step
    (``StreamingExecutor.aot_step``, run at construction).  Opening a stream
    costs one ``init_state`` (a full-window pass); ``push`` uploads one frame
    and returns the new classification on emitting frames (every
    ``emit_stride``-th, 2 for ``ds_cnn()``), downloading it, and ``None``
    in between, with no synchronisation; ``peek`` reads the held output.

    Numerics follow the wrapped executor: :meth:`from_quantized` serves the
    int8 step (int8 frames on the wire, quantized with
    ``quantize.quantize_input``), :meth:`from_graph` the float step.
    ``persistent_cache_dir=`` keeps the built kernels in a directory, as
    :class:`CNNEngine`'s does.
    """

    def __init__(self, executor, params, *, device="cuda", prewarm: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 persistent_cache_dir: Optional[str] = None):
        if persistent_cache_dir is not None:
            enable_persistent_cache(persistent_cache_dir)
        self.device = resolve(device)
        if executor.device != self.device:
            raise ValueError(f"executor runs on {executor.device}, server on {self.device}")
        self.executor = executor
        self.params = params
        self.np_dtype = _NUMPY_DTYPES[executor.dtype]
        self.metrics = metrics or MetricsRegistry("stream_server")
        t0 = time.perf_counter()
        self._step = executor.aot_step(params) if prewarm else executor.step
        self.prewarm_s = time.perf_counter() - t0 if prewarm else 0.0
        self.metrics.set_gauge("stream.prewarm_s", self.prewarm_s)
        self._states: Dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- constructors ----------------------------------------------------------

    @classmethod
    def from_graph(cls, graph, params, *, splan=None, device="cuda",
                   **kw) -> "StreamServer":
        """Float streaming server for a chain graph on ``device`` (plans the
        ring arena with ``streaming.plan_streaming`` unless ``splan`` is
        given)."""
        from repro_torch.core import streaming

        dev = resolve(device)
        params = {k: {kk: v.to(dev) for kk, v in p.items()} for k, p in params.items()}
        ex = streaming.make_streaming_executor(graph, splan, device=dev)
        return cls(ex, params, device=dev, **kw)

    @classmethod
    def from_quantized(cls, qm, *, splan=None, device="cuda", **kw) -> "StreamServer":
        """Int8 streaming server: int8 frames in, int8 logits out, bit-exact
        against the sliding full-window oracle."""
        from repro_torch.quant.exec import make_int8_streaming_executor

        dev = resolve(device)
        ex, params = make_int8_streaming_executor(qm, splan, device=dev)
        return cls(ex, params, device=dev, **kw)

    # -- session API -----------------------------------------------------------

    @property
    def streams(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._states)

    def open(self, stream_id: str) -> None:
        """Open a stream with the zero-history warm-start state."""
        with self._lock:
            if stream_id in self._states:
                raise ValueError(f"stream {stream_id!r} already open")
            self._states[stream_id] = self.executor.init_state(self.params)
        self.metrics.inc("stream.opened")

    def push(self, stream_id: str, frame: np.ndarray) -> Optional[np.ndarray]:
        """Feed one (C, W) frame; returns the new output on emitting frames,
        ``None`` otherwise.  Unknown stream ids are opened implicitly."""
        with self._lock:
            state = self._states.get(stream_id)
        if state is None:
            self.open(stream_id)
            with self._lock:
                state = self._states[stream_id]
        x = torch.from_numpy(np.array(frame, self.np_dtype))
        if self.device.type == "cuda":
            # pinned, so the copy does not wait for the card's queued work;
            # the caching host allocator keeps the block until it is done
            x = x.pin_memory().to(self.device, non_blocking=True)
        state, out, emitted = self._step(self.params, state, x)
        with self._lock:
            self._states[stream_id] = state
        self.metrics.inc("stream.frames")
        if emitted:
            self.metrics.inc("stream.emissions")
            return out.cpu().numpy()
        return None

    def peek(self, stream_id: str) -> np.ndarray:
        """The stream's held output (last emission; the zero window's head
        output before the first)."""
        with self._lock:
            return self._states[stream_id]["out"].cpu().numpy()

    def close(self, stream_id: str) -> np.ndarray:
        """Close a stream, returning its final held output."""
        with self._lock:
            state = self._states.pop(stream_id)
        self.metrics.inc("stream.closed")
        return state["out"].cpu().numpy()
