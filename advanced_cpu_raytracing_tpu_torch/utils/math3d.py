"""Batched 3-vector math over ``(..., 3)`` tensors.

Semantics mirror the reference math helpers (src/helperMath.cpp), as the
JAX package's ``utils/math3d.py`` does.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Row-wise dot product over the trailing axis (helperMath.cpp:54-58)."""
    return (a * b).sum(dim=-1)


def cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length(a: Tensor) -> Tensor:
    """Euclidean norm over the trailing axis (helperMath.cpp:112-115)."""
    return torch.sqrt((a * a).sum(dim=-1))


def normalize(a: Tensor, eps: float = 0.0) -> Tensor:
    """Unit vector; matches ``makeUnit`` (helperMath.cpp:116-124).  With
    ``eps``, vectors shorter than ``eps`` map to 0."""
    if eps:
        n2 = (a * a).sum(dim=-1, keepdim=True)
        ok = n2 > eps * eps
        l = torch.sqrt(torch.where(ok, n2, torch.ones_like(n2)))
        return torch.where(ok, a / l, torch.zeros_like(a))
    return a / length(a)[..., None]


def reflect(normal: Tensor, w_o: Tensor) -> Tensor:
    """Mirror direction ``unit(2 n (n.w_o) - w_o)`` (raytracer.cpp:426)."""
    return normalize(normal * (2.0 * dot(normal, w_o))[..., None] - w_o)


def orthonormal_basis(r: Tensor) -> tuple[Tensor, Tensor]:
    """(u, v) orthonormal to ``r`` via the axis-swap trick
    (GetOrthonormalBasis, helperMath.cpp:59-85): the smallest-|component|
    axis of a copy of r is set to 1 (x wins only if strictly smallest, z
    wins y/z ties), then u = unit(r' x r), v = unit(r x u)."""
    ax, ay, az = r[..., 0].abs(), r[..., 1].abs(), r[..., 2].abs()
    use_x = (ax < ay) & (ax < az)
    use_y = (~(ax < ay)) & (ay < az)
    one = torch.ones_like(ax)
    rp = torch.stack([
        torch.where(use_x, one, r[..., 0]),
        torch.where(use_y, one, r[..., 1]),
        torch.where(~(use_x | use_y), one, r[..., 2]),
    ], dim=-1)
    u = normalize(cross(rp, r), eps=1e-20)
    v = normalize(cross(r, u), eps=1e-20)
    return u, v


def luminance(rgb: Tensor) -> Tensor:
    """Rec.709 luminance (src/tonemapper.h:42, 77)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
