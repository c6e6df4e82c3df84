"""Device microseconds an image of every kernel that is neither K2 nor K4
(the f64 convolutions and the elementwise requantize, ReLU, copy and
gather kernels of the plain int8 ops), over the traced slice, all cards
summed.  Copies and fills by the copy engines are not kernels and are
left out."""
from perfbench.counts import KERNEL_NAMES
from perfbench.trace import is_copy


def read(rec):
    if rec.platform != "gpu" or rec.trace is None:
        return None
    s = sum(op.seconds for op in rec.trace.ops
            if not is_copy(op.name) and not any(p in op.name for p in KERNEL_NAMES.values()))
    return 1e6 * s / rec.trace.images
