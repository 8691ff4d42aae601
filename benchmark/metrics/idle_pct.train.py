"""The device's idle share of the traced window, in %: 100 minus the union
of the device operations' intervals over the window's length
(torch.profiler)."""

UNITS = ("update",)


def read(r):
    if r.trace is None or r.work.get("unit") not in UNITS:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
