"""The device's idle share of the traced slice, in %: 1 - the union of its
operations' intervals over the slice's length, the mean over the cards."""


def read(rec):
    if rec.platform != "gpu" or rec.trace is None:
        return None
    t = rec.trace
    return 100.0 * sum(1 - b / t.window_s for b in t.busy_s.values()) / len(t.busy_s)
