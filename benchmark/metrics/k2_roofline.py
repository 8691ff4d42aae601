"""K2's share of its roofline, in %: the least time of an update's work
(``rooflines/k2.py``, from the reference's count) over the K2 kernels'
device time an update (torch.profiler)."""

KERNEL = "mega_bwd"


def read(r):
    if r.trace is None or "k2" not in r.roofline or \
            r.work.get("unit") != "update":
        return None
    s, n = r.trace.kernel_s(KERNEL)
    if not n:
        return None
    return 100.0 * r.roofline["k2"] / (s / r.work["units"])
