"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit), and the least FP32 cost of one ray query.

A ray query (a closest hit or a shadow ray) over a scene of F triangles
and S spheres costs at least what an ideal walk of a 4-wide tree over
leaves of 4 triangles costs: one node a level, each node 4 box slab tests,
down ceil(log4(ceil(F / 4))) levels, then one leaf's 4 triangle tests, and
every sphere's test.  The operation counts of one test are those of the
tests as written (Cramer's rule up to its t test: 38; a slab test over
three axes: 22; the sphere's quadratic: 66).  It counts the work that the
scene's size asks for, whatever tree or leaf size the program builds.
"""

from __future__ import annotations

import math

FP32_FLOPS = 67e12  # FP32 outside the tensor cores, with FMA
HBM_BYTES_S = 3.35e12
BOX_OPS, FACE_OPS, SPHERE_OPS = 22, 38, 66
NODE_W, LEAF = 4, 4


def query_ops(faces: int, spheres: int) -> int:
    levels = math.ceil(math.log(max(math.ceil(faces / LEAF), 1), NODE_W)) \
        if faces else 0
    leaf = LEAF * FACE_OPS if faces else 0
    return levels * NODE_W * BOX_OPS + leaf + spheres * SPHERE_OPS


def least_s(ops: float, n_bytes: float) -> float:
    """The larger of the operations' time at the FP32 peak and the bytes'
    time at the HBM peak."""
    return max(ops / FP32_FLOPS, n_bytes / HBM_BYTES_S)
