"""K4's share of its roofline, in %: the least time of every K4 launch of
the traced slice (``perfbench.counts.kernel_bound_s`` at the cell's shapes,
one launch a layer a card) over the profiler's device time of those
launches.  A cell that runs K4 and finds no device record of it fails the
traced run."""
from perfbench.counts import KERNEL_NAMES


def read(rec):
    if rec.platform != "gpu" or rec.trace is None or not rec.runs_kernel("K4"):
        return None
    t = rec.trace.op_seconds(KERNEL_NAMES["K4"])
    if t <= 0:
        from perfbench.harness import MetricError

        raise MetricError("K4 runs in this cell but the profiler kept no device record of it")
    return 100.0 * rec.kernel_bound_s("K4", rec.trace.batches) / t
