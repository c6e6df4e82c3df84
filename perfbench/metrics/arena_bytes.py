"""The int8 arena one inference needs, in bytes: the second dimension of
the arena the executor allocated in the run times its element size (the
harness fails the run where it differs from the plan's ``arena_elems``).
It is what the paper's ping-pong plan promises a microcontroller."""


def read(rec):
    return rec.readings.get("arena_bytes") or None
