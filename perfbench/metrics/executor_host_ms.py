"""Host milliseconds of one executor call (the mesh's wrapped call on
more than one card), the mean over the window's counted batches: the time
the host spends enqueueing a batch's work."""


def read(rec):
    if not rec.host_call_s:
        return None
    return 1e3 * sum(rec.host_call_s) / len(rec.host_call_s)
