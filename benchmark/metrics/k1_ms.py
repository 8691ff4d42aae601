"""Device milliseconds per launch of K1 (the kernels named by the
configuration's ``k1_kernel``, by default ``mega_whitted*``) in whole
frames, from the torch.profiler trace of the window."""


def read(r):
    if r.trace is None or r.work.get("unit") != "frame":
        return None
    s, n = r.trace.kernel_s(r.run.k1_kernel())
    return s / n * 1e3 if n else None
