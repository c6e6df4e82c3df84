"""Images a second: every image whose output reached host memory in the
window, over the window's length (host clock)."""


def read(rec):
    return rec.images / rec.window_s
