"""A progressive preview's million pixel samples over the window: width x
height of every pass whose mean image reached the host, over the window's
seconds (host clock)."""


def read(r):
    if r.work.get("unit") != "pass":
        return None
    return r.work["paths"] / r.window_s / 1e6
