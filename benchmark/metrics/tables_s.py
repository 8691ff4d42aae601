"""Host seconds of the set-up's ingest and tables: the scene read, packed,
and the first call that builds the kernel's tables (``_mega_build_cached``
or ``make_diff_render``), a synchronize at its end."""


def read(r):
    s = r.run.spans.total("tables")
    return s if s > 0 else None
