"""The mesh's busy share over the window, in %: the sum over the cards of
each card's busy spans (CUDA events around each shard's executor call on
its card) over cards x the window's length.  Only on more than one card."""


def read(rec):
    if rec.platform != "gpu" or rec.chips < 2 or not rec.busy_span_s:
        return None
    return 100.0 * sum(rec.busy_span_s.values()) / (rec.chips * rec.window_s)
