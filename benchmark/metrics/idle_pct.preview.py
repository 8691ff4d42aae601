"""The device's idle share of a progressive preview's traced window, in %:
100 minus the union of the device operations' intervals over the window's
length (torch.profiler)."""


def read(r):
    if r.trace is None or r.work.get("unit") != "pass":
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
