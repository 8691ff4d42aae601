"""The optimizer layer's own milliseconds an update: the traced window's
wall time an update minus the K2 kernels' device time an update (the
primal, reverse and refit kernels; torch.profiler)."""

KERNEL = "mega_bwd"


def read(r):
    if r.trace is None or r.work.get("unit") != "update":
        return None
    dev_s, _ = r.trace.kernel_s(KERNEL)
    if dev_s <= 0:
        return None
    return (r.trace.window_s - dev_s) / r.work["units"] * 1e3
