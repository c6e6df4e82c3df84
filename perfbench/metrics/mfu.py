"""The whole step's share of the cards' int8 peak, in %: 2 x MACs an image
x images a second in the window, over chips x 1,979e12 OP/s (the H100 SXM
data sheet's dense int8 rate).  The result line's ``device.power_limit``
gives the cards' power limit beside it."""
from perfbench.counts import PEAK_INT8_OPS_PER_S


def read(rec):
    if rec.platform != "gpu":
        return None
    rate = rec.images / rec.window_s
    return 100.0 * 2 * rec.macs_per_image * rate / (rec.chips * PEAK_INT8_OPS_PER_S)
