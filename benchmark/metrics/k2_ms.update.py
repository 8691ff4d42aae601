"""Device milliseconds per update of K2 (the ``mega_bwd*`` kernels: the
primal, the reverse and the refit), from the torch.profiler trace of the
window."""

KERNEL = "mega_bwd"


def read(r):
    if r.trace is None or r.work.get("unit") != "update":
        return None
    s, n = r.trace.kernel_s(KERNEL)
    return s / r.work["units"] * 1e3 if n else None
