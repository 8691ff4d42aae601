"""The progressive layer's own milliseconds a pass: the traced window's
wall time a pass (its image read included) minus the K1 kernel's device
time a pass (torch.profiler)."""


def read(r):
    if r.trace is None or r.work.get("unit") != "pass":
        return None
    dev_s, _ = r.trace.kernel_s(r.run.k1_kernel())
    if dev_s <= 0:
        return None
    return (r.trace.window_s - dev_s) / r.work["units"] * 1e3
