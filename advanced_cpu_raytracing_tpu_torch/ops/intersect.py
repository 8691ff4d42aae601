"""Primitive intersection tests, batched over rays (the JAX package's
``ops/intersect.py``).

Rays are (o, d) with non-unit d allowed: t is preserved across affine ray
transforms as in the reference, which never renormalizes the object-space
direction (src/mesh.cpp:164-165).
"""

from __future__ import annotations

import torch

INF = float("inf")


def ray_aabb(o, d, bb_min, bb_max, min_t):
    """Slab test of BoundingBox::doesIntersectWith (src/shape.hpp:78-100):
    True where tmax > 0, tmax >= tmin and tmin < min_t.  A zero direction
    component gives +-inf like the C++ float math."""
    inv = 1.0 / d
    t1 = (bb_min - o) * inv
    t2 = (bb_max - o) * inv
    tmin = torch.minimum(t1[..., 0], t2[..., 0])
    tmax = torch.maximum(t1[..., 0], t2[..., 0])
    for k in (1, 2):
        tmin = torch.maximum(tmin, torch.minimum(t1[..., k], t2[..., k]))
        tmax = torch.minimum(tmax, torch.maximum(t1[..., k], t2[..., k]))
    return (tmax > 0) & (tmax >= tmin) & (tmin < min_t)


def det3(c0, c1, c2):
    """det[c0 | c1 | c2] of column vectors (..., 3), expanded along the
    first row as the reference's determinant() (JAX intersect.py:46-51)."""
    return (c0[..., 0] * (c1[..., 1] * c2[..., 2] - c2[..., 1] * c1[..., 2])
            - c1[..., 0] * (c0[..., 1] * c2[..., 2] - c2[..., 1] * c0[..., 2])
            + c2[..., 0] * (c0[..., 1] * c1[..., 2] - c1[..., 1] * c0[..., 2]))


def ray_triangle(o, d, v0, v1, v2):
    """Cramer's-rule triangle test (Mesh::IntersectFace,
    src/mesh.cpp:201-236).  Returns (t, beta, gamma, valid); valid requires
    det != 0, beta >= 0, gamma >= 0, beta + gamma <= 1 and t > 0.
    Broadcasts over leading dims."""
    e1 = v0 - v1
    e2 = v0 - v2
    b = v0 - o
    det_a = det3(e1, e2, d)
    safe = torch.where(det_a == 0.0, 1.0, det_a)
    beta = det3(b, e2, d) / safe
    gamma = det3(e1, b, d) / safe
    t = det3(e1, e2, b) / safe
    valid = ((det_a != 0.0) & (beta >= 0.0) & (gamma >= 0.0)
             & (beta + gamma <= 1.0) & (t > 0.0))
    return t, beta, gamma, valid


def ray_sphere(o, d, center, radius):
    """Quadratic sphere test (Sphere::Intersect, src/sphere.cpp:31-64):
    (t, valid) with the smallest positive root.  The where-guards keep
    reverse mode finite where delta <= 0 or d = 0 (those lanes are
    invalid)."""
    oc = o - center
    c = (oc * oc).sum(-1) - radius * radius
    b = 2.0 * (d * oc).sum(-1)
    a = (d * d).sum(-1)
    delta = b * b - 4.0 * a * c
    pos = delta > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, delta, 1.0)), 0.0)
    denom = torch.where(a > 0.0, 2.0 * a, 1.0)
    t1 = (-b + sq) / denom
    t2 = (-b - sq) / denom
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    t = torch.where(lo > 0.0, lo, hi)
    valid = (delta >= 0.0) & (t > 0.0) & (a > 0.0)
    return t, valid


def _matvec3(m, v):
    """(..., 3, 3+) times (..., 3) as explicit products and sums (JAX
    intersect.py:95-107), in f32 on every device."""
    return (m[..., :, 0] * v[..., 0:1] + m[..., :, 1] * v[..., 1:2]
            + m[..., :, 2] * v[..., 2:3])


def transform_ray(minv_3x4, o, d):
    """A packed (3,4) inverse transform: points with w = 1, vectors with
    w = 0 (src/matrix.hpp:113-122)."""
    return (_matvec3(minv_3x4[..., :3, :3], o) + minv_3x4[..., :3, 3],
            _matvec3(minv_3x4[..., :3, :3], d))


def transform_vector(m3x3, v):
    return _matvec3(m3x3, v)


def transform_point(m3x4, p):
    return _matvec3(m3x4[..., :3, :3], p) + m3x4[..., :3, 3]
