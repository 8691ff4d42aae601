"""The renderer's own milliseconds a frame: the traced window's wall time a
frame minus the K1 kernels' device time a frame (torch.profiler)."""


def read(r):
    if r.trace is None or r.work.get("unit") != "frame":
        return None
    dev_s, _ = r.trace.kernel_s(r.run.k1_kernel())
    if dev_s <= 0:
        return None
    return (r.trace.window_s - dev_s) / r.work["units"] * 1e3
