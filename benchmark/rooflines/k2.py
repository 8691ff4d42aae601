"""K2's least time an update (the primal and the reverse pass of every ray
of a grid, and the refit): the reference's closest-hit and shadow queries
of the update's forward chain at the least cost of a query
(``peaks.query_ops``), against the bytes read and written once: each ray's
origin and direction (24 bytes), its radiance out (12) and its cotangent
in (12), the scene's faces (12 floats) and spheres (4), and where the
vertices are a field, the vertices read and their gradient written (12
bytes each)."""

from benchmark.rooflines import peaks


def least_s(run, counts: dict) -> float:
    faces, spheres = run.config["faces"], run.config["spheres"]
    ops = counts["queries"] * peaks.query_ops(faces, spheres)
    n_bytes = (counts["rays"] * 48 + faces * 48 + spheres * 16
               + counts["verts"] * 24)
    return peaks.least_s(ops, n_bytes)
