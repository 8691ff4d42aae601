"""Million pixel samples finished over the window: width x height x spp of
every frame delivered to the host, over the window's seconds (host
clock)."""


def read(r):
    if r.work.get("unit") != "frame":
        return None
    return r.work["paths"] / r.window_s / 1e6
