"""BRDF evaluation: the five pluggable models and the default split
diffuse / specular shading, vectorized with masked dispatch (the JAX
package's ``ops/brdf.py``; reference src/brdf*.cpp).

The reference converts dots to degrees and back (angleBetweenUnitVectors /
cosDeg, src/helperMath.cpp:154-160); this works on the clamped cosines
directly, the same function.  ``pow`` bases are clamped to >= 0 (the
reference can feed negative cosines into std::pow and get NaN).  The clips
are ``torch.maximum`` / ``torch.minimum``, whose gradient splits at an
exact tie as ``jnp.clip``'s does.
"""

from __future__ import annotations

import math

import torch

from advanced_cpu_raytracing_tpu_torch.scene.types import BrdfType
from advanced_cpu_raytracing_tpu_torch.utils.math3d import (
    clip,
    div,
    dot,
    maximum,
    minimum,
    normalize,
)

PI = math.pi


def _clamp_cos(x):
    return clip(x, -1.0, 1.0)


def _powmax(base, e):
    """pow with the base clamped to >= 0 and a reverse-mode-safe zero
    branch (pow(0, e) has an infinite gradient for e < 1; pow(0, 0) = 1
    like C's pow)."""
    pos = base > 0.0
    safe = torch.where(pos, base, 1.0)
    zero_val = torch.where(e == 0.0, 1.0, 0.0)
    return torch.where(pos, torch.pow(safe, e), zero_val)


def eval_brdf(kind, exponent, normalized, kdfresnel, mat_ior, kd, ks, w_i,
              w_o, n):
    """The BRDF of each lane (BRDF::apply): ``kind`` (R,) int, ``exponent``
    (R,), ``normalized`` and ``kdfresnel`` (R,) bool, ``mat_ior`` (R,);
    kd / ks / w_i / w_o / n (R,3).  Returns (R,3)."""
    cos_i = _clamp_cos(dot(w_i, n))
    front = cos_i > 0.0

    half = normalize(w_i + w_o, eps=1e-20)
    cos_h = _clamp_cos(dot(half, n))
    refl = normalize(n * (2.0 * dot(n, w_i))[..., None] - w_i)
    cos_r = _clamp_cos(dot(refl, w_o))

    cos_i_c = maximum(cos_i, 1e-20)[..., None]

    # Phong (brdfPhong.cpp:11-21): kd + ks cos^e(aR) / cos(ti)
    phong = kd + ks * (_powmax(cos_r, exponent)[..., None] / cos_i_c)

    # ModifiedPhong (brdfModifiedPhong.cpp:14-33)
    mp_norm = div(kd, PI) + ks * (
        (div(exponent + 2.0, 2.0 * PI) * _powmax(cos_r, exponent))[..., None])
    mp_plain = kd + ks * _powmax(cos_r, exponent)[..., None]
    modified_phong = torch.where(normalized[..., None], mp_norm, mp_plain)

    # BlinnPhong (brdfBlinnPhong.cpp:11-21)
    blinn = kd + ks * (_powmax(cos_h, exponent)[..., None] / cos_i_c)

    # ModifiedBlinnPhong (brdfModifiedBlinnPhong.cpp:11-30)
    mbp_norm = div(kd, PI) + ks * (
        (div(exponent + 8.0, 8.0 * PI) * _powmax(cos_h, exponent))[..., None])
    mbp_plain = kd + ks * _powmax(cos_h, exponent)[..., None]
    modified_blinn = torch.where(normalized[..., None], mbp_norm, mbp_plain)

    # TorranceSparrow (brdfTorranceSparrow.cpp:15-66)
    d_term = div(exponent + 2.0, 2.0 * PI) * _powmax(dot(half, n), exponent)
    r0 = torch.square(mat_ior - 1.0) / maximum(torch.square(mat_ior + 1.0),
                                               1e-20)
    f_term = r0 + (1.0 - r0) * torch.pow(
        maximum(1.0 - dot(half, w_o), 0.0), 5.0)
    ndoth = dot(n, half)
    ndotwo = dot(n, w_o)
    ndotwi = dot(n, w_i)
    wodoth = torch.where(dot(w_o, half) == 0, 1e-20, dot(w_o, half))
    g_term = minimum(1.0, minimum(2.0 * ndoth * ndotwo / wodoth,
                                  2.0 * ndoth * ndotwi / wodoth))
    kd_coeff = torch.where(kdfresnel, div(1.0 - f_term, PI),
                           div(torch.ones_like(f_term), PI))
    denom = 4.0 * torch.where(ndotwi * ndotwo == 0, 1e-20, ndotwi * ndotwo)
    torrance = kd * kd_coeff[..., None] + ks * (
        (d_term * f_term * g_term / denom)[..., None])

    out = torch.where(
        (kind == int(BrdfType.PHONG))[..., None], phong,
        torch.where(
            (kind == int(BrdfType.MODIFIED_PHONG))[..., None], modified_phong,
            torch.where(
                (kind == int(BrdfType.BLINN_PHONG))[..., None], blinn,
                torch.where(
                    (kind == int(BrdfType.MODIFIED_BLINN_PHONG))[..., None],
                    modified_blinn, torrance))))
    return torch.where(front[..., None], out, 0.0)


def default_diffuse(kd, w_i, n, irradiance):
    """kd * E * max(0, w_i . n) (Raytracer::GetDiffuse,
    src/raytracer.cpp:540-545)."""
    cos_t = maximum(0.0, dot(w_i, n))
    return kd * irradiance * cos_t[..., None]


def default_specular(ks, phong_exponent, w_i, w_o, n, irradiance):
    """The Blinn-Phong lobe (Raytracer::GetSpecular,
    src/raytracer.cpp:547-554)."""
    half = normalize(w_i + w_o, eps=1e-20)
    cos_a = maximum(0.0, dot(n, half))
    return ks * irradiance * _powmax(cos_a, phong_exponent)[..., None]
