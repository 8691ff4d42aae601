"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in MiB."""


def read(r):
    if r.work.get("unit") != "update" or not r.work.get("window_peak_bytes"):
        return None
    return r.work["window_peak_bytes"] / 2**20
