"""Device milliseconds per launch of K1 (``mega_whitted*``) in whole
frames, from the torch.profiler trace of the window."""

KERNEL = "mega_whitted"


def read(r):
    if r.trace is None or r.work.get("unit") != "frame":
        return None
    s, n = r.trace.kernel_s(KERNEL)
    return s / n * 1e3 if n else None
