"""Texture sampling: images (nearest and bilinear) and procedural Perlin.

Torch counterparts of the JAX package's ``ops/texture.py``
(src/imageTexture.h, src/perlinTexture.{h,cpp}), batched over rays, for the
megakernel's plain version (``ops/megakernel.py::mega_trace_ref``) and the
port's tests.  Conventions, as in the reference:

  * samples are *raw* image units (0..255 for LDR); the /255 normalisation
    is the caller's (raytracer.cpp:494 divides, PerPixel:54 does not);
  * nearest: i = int(u*w) clamped to [0, w-1] (imageTexture.h:60-70);
  * bilinear: coordinates clipped to [0, w-1], four taps with the +1 taps
    clamped to the edge, weights applied as the megakernel applies them,
    ((1-dx)(1-dy)) c00 + (dx(1-dy)) c10 + ((1-dx)dy) c01 + (dx dy) c11.

The images come either as the pack's atlas ``(I, Hmax, Wmax, 3)`` (the JAX
signatures) or as the megakernel's flat texel pool, through ``fetch``.
"""

from __future__ import annotations

import numpy as np
import torch

# Permutation table of src/perlinTexture.cpp:5-33 (the JAX package's
# ops/texture.py::_PERM256), duplicated to 512 entries where it is used.
_PERM256 = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], dtype=np.int32)
PERM512 = np.concatenate([_PERM256, _PERM256])

# the classic 12 gradients (perlinTexture.cpp:35-48)
_GRADIENTS = np.array([
    [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
    [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
    [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
], dtype=np.float32)


# --------------------------------------------------------------------------
# images
# --------------------------------------------------------------------------


def _atlas_fetch(atlas, img_idx):
    return lambda i, j: atlas[img_idx, j, i]


def nearest_ij(u, v, w, h):
    """Integer texel (i, j) of the nearest lookup; ``w``, ``h`` are ints or
    int tensors broadcasting with ``u``."""
    def clamp(x, n):
        hi = torch.as_tensor(n - 1, dtype=torch.int64, device=x.device)
        return torch.clamp(torch.minimum(x, hi), min=0)

    return clamp((u * w).to(torch.int64), w), clamp((v * h).to(torch.int64), h)


def bilinear_taps(u, v, w, h):
    """The four taps (i, j) of a bilinear lookup at (u, v) of a ``w`` x
    ``h`` image and their weights (megakernel.py:1086-1119).  The weights
    are differentiable in u and v as the JAX package's ``jnp.clip`` is:
    the clip is max then min, whose gradient splits evenly at a tie, so a
    coordinate exactly on 0 or w - 1 passes half of it; the taps and the
    floor are constants."""
    fw = torch.as_tensor(w, dtype=torch.float32)
    fh = torch.as_tensor(h, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    fi = torch.minimum(torch.maximum(u * fw, zero), fw - 1.0)
    fj = torch.minimum(torch.maximum(v * fh, zero), fh - 1.0)
    p = torch.floor(fi)
    q = torch.floor(fj)
    dx = fi - p
    dy = fj - q
    p1 = torch.minimum(p + 1.0, fw - 1.0)
    q1 = torch.minimum(q + 1.0, fh - 1.0)
    pi, qi = p.to(torch.int64), q.to(torch.int64)
    p1i, q1i = p1.to(torch.int64), q1.to(torch.int64)
    taps = [(pi, qi), (p1i, qi), (pi, q1i), (p1i, q1i)]
    wts = [(1.0 - dx) * (1.0 - dy), dx * (1.0 - dy), (1.0 - dx) * dy, dx * dy]
    return taps, wts


def bilinear(fetch, u, v, w, h):
    """Bilinear sample at (u, v) of an image of ``w`` x ``h`` texels read
    through ``fetch(i, j) -> (..., 3)``; the tap order and weight
    arithmetic of the megakernel (megakernel.py:1086-1119)."""
    taps, wts = bilinear_taps(u, v, w, h)
    out = wts[0][..., None] * fetch(*taps[0])
    for wt, ij in zip(wts[1:], taps[1:]):
        out = out + wt[..., None] * fetch(*ij)
    return out


def sample_nearest(atlas, img_w, img_h, img_idx, u, v):
    i, j = nearest_ij(u, v, img_w[img_idx], img_h[img_idx])
    return _atlas_fetch(atlas, img_idx)(i, j)


def sample_bilinear(atlas, img_w, img_h, img_idx, u, v):
    return bilinear(_atlas_fetch(atlas, img_idx), u, v, img_w[img_idx],
                    img_h[img_idx])


def tile_uv(x):
    """UV tiling: Mesh::GetFloorForTiledUV (src/mesh.cpp:382-389); an exact
    integer above 1 maps to 1, not 0."""
    frac = x - torch.floor(x)
    frac = torch.where(frac < 0.0001, 1.0, frac)
    return torch.where(x > 1.0001, frac, x)


# --------------------------------------------------------------------------
# Perlin noise (classic, 12 gradients, quintic fade)
# --------------------------------------------------------------------------


def _fade_weight(x):
    """The reference's f(): weight 1 at distance 0, 0 at distance >= 1
    (perlinTexture.h:147-155): 1 - (6|x|^5 - 15|x|^4 + 10|x|^3)."""
    x = torch.abs(x)
    x2 = x * x
    x3 = x2 * x
    w = -6.0 * x3 * x2 + 15.0 * x3 * x - 10.0 * x3 + 1.0
    return torch.where(x > 1.0, 0.0, w)


def perlin_raw(p, perm=None):
    """Raw Perlin noise in [-1, 1] at positions p (R,3)
    (PerlinTexture::GetSampleFromWorldPos, perlinTexture.h:76-133)."""
    if perm is None:
        perm = torch.as_tensor(PERM512, dtype=torch.int64, device=p.device)
    grads = torch.as_tensor(_GRADIENTS, device=p.device)
    fl = torch.floor(p)
    d = p - fl
    cell = fl.to(torch.int64) & 255
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                h = perm[cell[..., 0] + ox + perm[cell[..., 1] + oy
                                                  + perm[cell[..., 2] + oz]]]
                g = grads[h % 12]
                c = (g[..., 0] * (d[..., 0] - ox) + g[..., 1] * (d[..., 1] - oy)
                     + g[..., 2] * (d[..., 2] - oz))
                w = (_fade_weight(d[..., 0] - ox) * _fade_weight(d[..., 1] - oy)
                     * _fade_weight(d[..., 2] - oz))
                total = total + w * c
    return total


def perlin_sample(p, noise_scale, conversion, perm=None):
    """Scaled and converted Perlin sample; conversion (R,) int: 0 linear
    ((n+1)/2), 1 absval (perlinTexture.h:127-132)."""
    n = perlin_raw(p * noise_scale[..., None], perm)
    return torch.where(conversion == 0, (n + 1.0) * 0.5, torch.abs(n))


def atlas_fetch(atlas, img_idx, i, j):
    """Integer texel fetch from the padded atlas: (R,) indices -> (R,3)
    (the JAX ``atlas_fetch``)."""
    return atlas[img_idx, j, i]


def sample_image(atlas, img_w, img_h, img_idx, interp, u, v):
    """An image sample per lane (the JAX ``sample_image``): ``interp`` (R,)
    0 nearest, 1 bilinear."""
    nearest = sample_nearest(atlas, img_w, img_h, img_idx, u, v)
    bil = sample_bilinear(atlas, img_w, img_h, img_idx, u, v)
    return torch.where((interp == 0)[..., None], nearest, bil)
