"""Device milliseconds per launch of K1 (``mega_whitted*``) in a
progressive preview, one launch a pass, from the torch.profiler trace of
the window."""

KERNEL = "mega_whitted"


def read(r):
    if r.trace is None or r.work.get("unit") != "pass":
        return None
    s, n = r.trace.kernel_s(KERNEL)
    return s / n * 1e3 if n else None
