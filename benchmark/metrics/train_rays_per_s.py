"""Million rays through a value-and-gradient and an Adam update, over the
window's seconds (host clock, the window ending in a synchronize)."""


def read(r):
    if r.work.get("unit") != "update":
        return None
    return r.work["rays"] / r.window_s / 1e6
