"""The loop ``closed``: bulk scoring in a closed loop of equal batches.

A traffic file that names it (``"loop": "closed"``) gives ``batch`` (rows
a call), ``lookahead`` (batches dispatched before the oldest is waited
on), ``input_pool_batches`` (the seeded batches the loop cycles through),
``warmup_batches`` and ``trace_batches``.

A batch is staged from pinned host memory to the first device, run
through the timed path and copied back to pinned host memory.  The window
opens once the warm-up has drained and closes at the first batch
completed at or after ``seconds``; it counts every row whose output
reached host memory in it, over its whole length.  The traced run then
profiles ``trace_batches`` more batches after one warm batch that the
profiler drops.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

from perfbench.harness import LoopContext, LoopResult, profile_slice, sync


def pool_rows(traffic: dict) -> int:
    return int(traffic["input_pool_batches"]) * int(traffic["batch"])


class _HostEvent:
    """The CPU's stand-in for a CUDA event: CPU work is done on return."""

    def synchronize(self) -> None:
        return None


class Loop:
    def __init__(self, ctx: LoopContext):
        tr = ctx.traffic
        self.ctx, self.batch, self.lookahead = ctx, int(tr["batch"]), int(tr["lookahead"])
        self.slots = int(tr["input_pool_batches"])
        self.device = ctx.devices[0]
        self.cuda = self.device.type == "cuda"
        self.ring = [torch.empty((self.batch, *ctx.out_shape), dtype=torch.int8,
                                 pin_memory=self.cuda) for _ in range(self.lookahead + 2)]
        self.pending: collections.deque = collections.deque()
        self.i = 0
        self.spans = False

    def _span(self, name):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"perfbench.{name}")

    def dispatch(self) -> None:
        start = (self.i % self.slots) * self.batch
        with self._span("stage"):
            x = self.ctx.pool[start:start + self.batch].to(self.device, non_blocking=True)
        with self._span("executor"):
            t = time.perf_counter()
            y = self.ctx.run(self.ctx.params, x)
            host_s = time.perf_counter() - t
        with self._span("copy_back"):
            out = self.ring[self.i % len(self.ring)]
            out.copy_(y, non_blocking=True)
            if self.cuda:
                ev = torch.cuda.Event()
                ev.record()
            else:
                ev = _HostEvent()
        self.pending.append((start, ev, out, host_s))
        self.i += 1

    def complete(self):
        """Wait for the oldest batch in flight: (its first pool row, its
        output in host memory, the host seconds of its executor call)."""
        start, ev, out, host_s = self.pending.popleft()
        with self._span("wait"):
            ev.synchronize()
        return start, out, host_s

    def step(self):
        """Dispatch one batch; then, if more than ``lookahead`` are in
        flight, complete the oldest and return it."""
        self.dispatch()
        return self.complete() if len(self.pending) > self.lookahead else None

    def drain(self) -> None:
        while self.pending:
            self.complete()

    def batches(self, n: int) -> None:
        for _ in range(n):
            self.step()
        self.drain()


def run(ctx: LoopContext) -> LoopResult:
    tr, devices = ctx.traffic, ctx.devices
    loop = Loop(ctx)
    loop.batches(int(tr["warmup_batches"]))
    sync(devices)
    setup_end = time.perf_counter()

    ctx.window_opens()
    res = LoopResult(setup_end=setup_end, rows_per_call=loop.batch)
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    while True:
        done = loop.step()
        if done is None:
            continue
        now = time.perf_counter()
        start, out, host_s = done
        res.outputs.append((start, out.numpy().copy()))
        res.host_call_s.append(host_s)
        if now >= t_end:
            res.window_s = now - t0
            break
    res.calls = len(res.outputs)
    res.dispatched_rows = loop.i * loop.batch
    loop.drain()
    sync(devices)

    if ctx.trace:
        n = int(tr["trace_batches"])

        def body():
            loop.spans = True
            loop.batches(n)
            sync(devices)
            loop.spans = False

        res.trace = profile_slice(devices, lambda: loop.batches(1), body)
        res.trace.images, res.trace.batches = n * loop.batch, n
    return res
