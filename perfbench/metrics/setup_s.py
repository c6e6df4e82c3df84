"""Seconds from the process's start to the end of the warm-up: imports,
weights, calibration and inputs from the seed, the model, the plan, any
kernel build, and warm-up batches of the cell's own shape, drained."""


def read(rec):
    return rec.setup_s
