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


def _as(x, like: Tensor) -> Tensor:
    return x if torch.is_tensor(x) else torch.tensor(
        x, dtype=like.dtype, device=like.device)


def div(a, b) -> Tensor:
    """a / b rounded once, as an IEEE division.  torch computes a tensor
    over a Python number on the card as a product with the number's
    reciprocal, and a number over a tensor as the tensor's reciprocal times
    the number; each rounds twice."""
    like = a if torch.is_tensor(a) else b
    return torch.div(_as(a, like), _as(b, like))


def maximum(a, b) -> Tensor:
    """Elementwise max that takes Python numbers; at an exact tie its
    gradient splits evenly between the two, as ``jnp.maximum``'s does
    (``torch.clamp`` passes all of it)."""
    like = a if torch.is_tensor(a) else b
    return torch.maximum(_as(a, like), _as(b, like))


def minimum(a, b) -> Tensor:
    """Elementwise min; see ``maximum``."""
    like = a if torch.is_tensor(a) else b
    return torch.minimum(_as(a, like), _as(b, like))


def clip(x: Tensor, lo, hi) -> Tensor:
    """``jnp.clip``: min(max(x, lo), hi), with its gradient at ties."""
    return minimum(maximum(x, lo), hi)
