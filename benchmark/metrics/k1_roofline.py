"""K1's share of its roofline in whole frames, in %: the least time of a
launch's work (``rooflines/k1.py``, from the reference's count) over K1's
device time a launch (torch.profiler)."""


def read(r):
    if r.trace is None or r.work.get("unit") != "frame" or \
            "k1" not in r.roofline:
        return None
    s, n = r.trace.kernel_s(r.run.k1_kernel())
    if not n:
        return None
    return 100.0 * r.roofline["k1"] / (s / n)
