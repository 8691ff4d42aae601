"""K1's least time a launch (one sample of every pixel): the reference's
closest-hit and shadow queries of the launch's rays at the least cost of a
query (``peaks.query_ops``), against the bytes read and written once: each
ray's origin and direction in (24 bytes) and radiance out (12), and the
scene's faces (9 vertex and 3 normal floats) and spheres (4 floats)."""

from benchmark.rooflines import peaks


def least_s(run, counts: dict) -> float:
    faces, spheres = run.config["faces"], run.config["spheres"]
    ops = counts["queries"] * peaks.query_ops(faces, spheres)
    n_bytes = counts["rays"] * 36 + faces * 48 + spheres * 16
    return peaks.least_s(ops, n_bytes)
