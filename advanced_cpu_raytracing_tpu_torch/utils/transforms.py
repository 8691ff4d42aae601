"""4x4 affine transforms and their composition (host side, numpy).

Mirrors the reference matrix factories (src/matrix.hpp:28-74) and the
transform-string composition rules of ``Scene::computeTransform``
(src/parser.cpp:651-723):

  - A transform string like ``"s2 r1 t3"`` applies scale 2 first, then
    rotation 1, then translation 3:  M = T3 @ R1 @ S2.
  - The inverse is composed from per-op analytic inverses in string order:
    M^-1 = S2^-1 @ R1^-1 @ T3^-1 (matching parser.cpp:712-717).
  - The normal matrix is transpose(M^-1) (parser.cpp:720), applied to vectors
    with w = 0.

The reference only supports axis-aligned rotation axes (parser.cpp:667-683);
we support arbitrary axes via Rodrigues' formula (a strict superset: for the
axis-aligned cases the matrices agree to float precision).
"""

from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translation(t) -> np.ndarray:
    m = identity()
    m[:3, 3] = t
    return m


def scale(s) -> np.ndarray:
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotation_axis_angle(axis, angle_deg: float) -> np.ndarray:
    """Rotation about an arbitrary axis (degrees), Rodrigues form.

    For axis-aligned axes this reproduces GetRotationAroundX/Y/Z
    (src/matrix.hpp:46-74) exactly.
    """
    axis = np.asarray(axis, dtype=np.float64)
    n = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = n
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], dtype=np.float64)
    r3 = np.eye(3) * c + s * k + (1 - c) * np.outer(n, n)
    m = identity()
    m[:3, :3] = r3
    return m


def compose(ops: list[tuple[str, object]]) -> tuple[np.ndarray, np.ndarray]:
    """Compose (M, M_inv) from a list of ('t'|'s'|'r', payload) ops in
    application order, using analytic per-op inverses like parser.cpp:684-717.

    payload: 't' -> (tx,ty,tz); 's' -> (sx,sy,sz); 'r' -> (angle_deg, axis3).
    """
    m = identity()
    m_inv = identity()
    for kind, payload in ops:
        if kind == "t":
            op = translation(payload)
            inv = translation([-payload[0], -payload[1], -payload[2]])
        elif kind == "s":
            op = scale(payload)
            inv = scale([1.0 / payload[0], 1.0 / payload[1], 1.0 / payload[2]])
        elif kind == "r":
            angle, axis = payload
            op = rotation_axis_angle(axis, angle)
            inv = rotation_axis_angle(axis, -angle)
        else:  # pragma: no cover - parser guarantees kinds
            raise ValueError(f"unknown transform op {kind!r}")
        m = op @ m
        m_inv = m_inv @ inv
    return m, m_inv


def apply_to_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply 4x4 to (...,3) points with w=1 (src/matrix.hpp:113-117)."""
    return pts @ m[:3, :3].T + m[:3, 3]


def apply_to_vectors(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Apply 4x4 to (...,3) vectors with w=0 (src/matrix.hpp:119-122)."""
    return vecs @ m[:3, :3].T


def transform_aabb(m: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """Transform an AABB by taking min/max of its 8 transformed corners
    (Scene::transformBoundingBox, src/parser.cpp:749-805)."""
    corners = np.array(
        [
            [bmin[0], bmin[1], bmin[2]],
            [bmin[0], bmin[1], bmax[2]],
            [bmin[0], bmax[1], bmin[2]],
            [bmin[0], bmax[1], bmax[2]],
            [bmax[0], bmin[1], bmin[2]],
            [bmax[0], bmin[1], bmax[2]],
            [bmax[0], bmax[1], bmin[2]],
            [bmax[0], bmax[1], bmax[2]],
        ],
        dtype=np.float64,
    )
    tc = apply_to_points(m, corners)
    return tc.min(axis=0), tc.max(axis=0)
