"""The 95th percentile of every frame's milliseconds in the window, from
the call to the u8 image on the host (host clock)."""

from benchmark.harness import quantile


def read(r):
    if r.work.get("unit") != "frame":
        return None
    return quantile(r.work["times"], 0.95) * 1e3
