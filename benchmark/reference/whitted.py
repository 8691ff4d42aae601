"""The plain reference of the Whitted render: camera rays, the shading tree
of each ray, the Gaussian-weighted stratified multisample and the u8 clamp.

The semantics are DorkTracer's Whitted integrator (raytracer.cpp:65-134,
208-415, 701-806) as the program states them: ambient and Blinn-Phong
light from point and directional lights behind shadow rays from the hit
offset along the normal by the shadow epsilon; mirror and conductor
reflection (the conductor weighted by its Fresnel ratio and dropped below
1e-4); the dielectric's Fresnel split into a reflection and a refraction
leg, each with its medium and Beer attenuation over the next segment; no
direct light inside a medium; the background on a primary miss only;
children while depth is left.  The tree of each ray is walked breadth
first here, all rays' nodes of one level at once, so the sum of a ray's
terms is taken in another order than a depth-first walk takes it.

Everything runs in ``dtype``: float32 as the configurations state it, or a
lower precision for the control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import geometry
from .geometry import BIG, Geometry, dot3
from .scene import MAT_CONDUCTOR, MAT_DIELECTRIC, MAT_MIRROR, Scene
from .scene import load  # noqa: F401  (the interface's scene loader)


def norm3(v):
    """v / |v| as IEEE sqrt and division, |v|^2 clamped at 1e-20."""
    inv = 1.0 / torch.sqrt(torch.clamp(dot3(v, v), min=1e-20))
    return v * inv[..., None]


def face_normals(scene: Scene) -> np.ndarray:
    """(F, 3) f32 unit geometric normals cross(v1 - v0, v2 - v0), taken in
    float64."""
    v = scene.verts.astype(np.float64)[scene.faces]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                           1e-30)).astype(np.float32)


@dataclass
class Tables:
    """A scene's tables on one device in one dtype."""

    scene: Scene
    dtype: torch.dtype
    device: torch.device
    groups: torch.Tensor
    tri9: torch.Tensor
    normal: torch.Tensor  # (F, 3) unit, as f32 then cast
    face_mat: torch.Tensor
    sph: torch.Tensor  # (S, 4)
    sph_mat: torch.Tensor
    mat: dict  # name -> tensor
    pl_pos: torch.Tensor
    pl_intensity: torch.Tensor
    dl_wi: torch.Tensor  # (D, 3) unit, toward the light
    dl_radiance: torch.Tensor
    ambient: torch.Tensor
    bg: torch.Tensor
    counts: geometry.Counts

    def geometry(self, tri9=None) -> Geometry:
        return Geometry(self.tri9 if tri9 is None else tri9, self.groups,
                        self.sph, self.counts)


def tables(scene: Scene, device, dtype=torch.float32, groups=None) -> Tables:
    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    if groups is None:
        groups = geometry.clusters(scene.verts, scene.faces, scene.mesh_spans)
    dl = scene.dl_dir.astype(np.float64)
    dl_wi = -dl / np.maximum(np.linalg.norm(dl, axis=-1, keepdims=True), 1e-30)
    mat = {k: t(getattr(scene, "mat_" + k)) for k in (
        "ambient", "diffuse", "specular", "mirror", "phong", "ior", "k",
        "absorb")}
    mat["type"] = t(scene.mat_type, torch.int64)
    return Tables(
        scene=scene, dtype=dtype, device=torch.device(device),
        groups=torch.as_tensor(groups, device=device),
        tri9=t(scene.verts[scene.faces].reshape(-1, 9)),
        normal=t(face_normals(scene)), face_mat=t(scene.face_mat, torch.int64),
        sph=t(np.concatenate([scene.sph_center, scene.sph_radius[:, None]], 1)),
        sph_mat=t(scene.sph_mat, torch.int64), mat=mat, pl_pos=t(scene.pl_pos),
        pl_intensity=t(scene.pl_intensity), dl_wi=t(dl_wi.astype(np.float32)),
        dl_radiance=t(scene.dl_radiance), ambient=t(scene.ambient),
        bg=t(scene.bg), counts=geometry.Counts())


# ---- camera ----

def camera_rays(scene: Scene, px: torch.Tensor, py: torch.Tensor):
    """Primary rays (origin, unit direction), (R, 3) f32, through the
    (fractional) pixel coordinates px, py (R,) f32 (Camera::SetupDefault,
    camera.cpp:5-80; GenerateRay, raytracer.cpp:661-699): the camera's
    frame in float64 on the host, the rays in f32."""
    c = scene.camera
    gaze = c.gaze / np.linalg.norm(c.gaze)
    up = c.up / np.linalg.norm(c.up)
    up = up - gaze * (up @ gaze)
    up /= np.linalg.norm(up)
    right = np.cross(up, -gaze)
    l, r, b, t = c.near_plane
    q = c.position + gaze * c.near_distance + right * l + up * t
    dev = px.device

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    su = (px + 0.5) * f32((r - l) / c.width)
    sv = (py + 0.5) * f32((t - b) / c.height)
    plane = f32(q) + f32(right) * su[:, None] - f32(up) * sv[:, None]
    origin = f32(c.position).expand_as(plane)
    dv = plane - origin
    return origin.contiguous(), dv / torch.sqrt((dv * dv).sum(-1))[:, None]


# ---- the shading tree ----

def radiance(tb: Tables, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(R, 3) radiance of rays o, d (R, 3), in ``tb.dtype``."""
    dt, dev = tb.dtype, o.device
    sc = tb.scene
    geo = tb.geometry()
    mat = tb.mat
    n_rays = o.shape[0]
    o, d = o.to(dt), d.to(dt)
    out = torch.zeros((n_rays, 3), dtype=dt, device=dev)
    diel = bool((sc.mat_type == MAT_DIELECTRIC).any())
    any_spec = bool(np.isin(sc.mat_type, (MAT_MIRROR, MAT_DIELECTRIC,
                                          MAT_CONDUCTOR)).any()) \
        and sc.max_depth > 0
    eps = sc.eps
    owner = torch.arange(n_rays, device=dev)
    w = torch.ones((n_rays, 3), dtype=dt, device=dev)
    a = torch.zeros((n_rays, 3), dtype=dt, device=dev)
    med = torch.ones(n_rays, dtype=dt, device=dev)
    dep = torch.full((n_rays,), sc.max_depth, dtype=torch.int64, device=dev)
    first = torch.ones(n_rays, dtype=torch.bool, device=dev)
    zero3 = torch.zeros(3, dtype=dt, device=dev)
    while owner.numel():
        t, face, sph, snrm = geo.closest(o, d)
        hit = t < BIG * 0.5
        t_safe = torch.where(hit, t, 0.0)
        if diel:  # Beer attenuation of this segment
            w = w * torch.exp(-a * t_safe[:, None])
        contrib = torch.where((~hit & first)[:, None], w * tb.bg, zero3)
        p = o + t_safe[:, None] * d
        wo = -d
        nf = tb.normal[face.clamp(min=0)]
        n = norm3(torch.where((face >= 0)[:, None], nf, snrm))
        m = torch.where(face >= 0, tb.face_mat[face.clamp(min=0)],
                        torch.where(sph >= 0, tb.sph_mat[sph.clamp(min=0)], 0))
        inside = (med > 1.00001) if diel else torch.zeros_like(hit)
        lit = hit & ~inside
        li = lit.nonzero().squeeze(1)
        if li.numel():
            mi = m[li]
            wl, pl_, nl = w[li], p[li], n[li]
            acc = wl * (tb.ambient * mat["ambient"][mi])
            kd, ks = mat["diffuse"][mi], mat["specular"][mi]
            phong = mat["phong"][mi]
            so = pl_ + nl * eps
            wol = wo[li]
            lights = [(True, i) for i in range(tb.pl_pos.shape[0])] + \
                [(False, i) for i in range(tb.dl_wi.shape[0])]
            for point, i in lights:
                if point:
                    tl = tb.pl_pos[i] - pl_
                    d2 = torch.clamp(dot3(tl, tl), min=1e-20)
                    limit = torch.sqrt(d2)
                    wi = tl * (1.0 / limit)[:, None]
                    irr = tb.pl_intensity[i] / d2[:, None]
                else:
                    wi = tb.dl_wi[i].expand_as(pl_)
                    limit = torch.full_like(phong, BIG)
                    irr = tb.dl_radiance[i].expand_as(pl_)
                free = ~geo.blocked(so, wi, limit)
                cos_t = torch.clamp(dot3(wi, nl), min=0.0)
                h = norm3(wi + wol)
                cos_hm = torch.clamp(dot3(h, nl), min=0.0)
                pos = cos_hm > 0
                spec = torch.where(pos, torch.exp(phong * torch.log(
                    torch.where(pos, cos_hm, 1.0))),
                    (phong == 0).to(dt))
                term = wl * irr * (kd * cos_t[:, None] + ks * spec[:, None])
                acc = acc + torch.where(free[:, None], term, zero3)
            contrib = contrib.index_add(0, li, acc)
        out.index_add_(0, owner, contrib)
        if not any_spec:
            break
        # children: reflection legs and the dielectric's refraction leg
        mt = mat["type"][m]
        can = hit & (dep > 0)
        kids = []
        ndw = dot3(n, wo)
        rdir = norm3(2.0 * n * ndw[:, None] - wo)
        mirror = mat["mirror"][m]
        refl = can & (mt == MAT_MIRROR)
        if refl.any():
            kids.append((refl, p + n * eps, rdir, w * mirror,
                         torch.zeros_like(a), torch.ones_like(med)))
        cond = can & (mt == MAT_CONDUCTOR)
        if cond.any():
            n2, k2, c = mat["ior"][m], mat["k"][m], ndw
            n2k2 = n2 * n2 + k2 * k2
            two = 2.0 * n2 * c
            cos2 = c * c
            rs = (n2k2 - two + cos2) / torch.clamp(n2k2 + two + cos2, min=1e-20)
            rp = (n2k2 * cos2 - two + 1.0) / torch.clamp(
                n2k2 * cos2 + two + 1.0, min=1e-20)
            f = 0.5 * (rs + rp)
            kids.append((cond & (f > 1e-4), p + n * eps, rdir,
                         w * mirror * f[:, None], torch.zeros_like(a),
                         torch.ones_like(med)))
        dl_ = can & (mt == MAT_DIELECTRIC)
        if dl_.any():
            ior = mat["ior"][m]
            absorb = mat["absorb"][m]
            cos0 = -dot3(d, n)
            entering = cos0 > 0.0
            sgn = torch.where(entering, 1.0, -1.0).to(dt)
            nm = n * sgn[:, None]
            cos_i = cos0.abs()
            n1 = torch.where(entering, med, ior)
            n2 = torch.where(entering, ior, 1.0)
            ratio = n1 / torch.clamp(n2, min=1e-20)
            crit = ratio * ratio * (1.0 - cos_i * cos_i)
            ndwm = dot3(nm, wo)
            rd = norm3(2.0 * nm * ndwm[:, None] - wo)
            tir = crit > 1.0
            cos_p = torch.sqrt(torch.clamp(1.0 - crit, min=0.0))
            n2cos, n1cosp = n2 * cos_i, n1 * cos_p
            rpar = (n2cos - n1cosp) / torch.clamp(n2cos + n1cosp, min=1e-20)
            rperp = (n1 * cos_i - n2 * cos_p) / torch.clamp(
                n1 * cos_i + n2 * cos_p, min=1e-20)
            r_refl = 0.5 * (rpar * rpar + rperp * rperp)
            r_refr = 1.0 - r_refl
            zero = torch.zeros_like(absorb)
            # the reflection leg: in total internal reflection the weight
            # and the medium are kept
            a_refl = torch.where(
                (tir & (med > 1.0001) | ~tir & (n2 > 1.00001))[:, None],
                absorb, zero)
            kids.append((dl_, p + nm * eps, rd,
                         torch.where(tir[:, None], w, w * r_refl[:, None]),
                         a_refl, torch.where(tir, med, n2)))
            fd = norm3((d + nm * cos_i[:, None]) * ratio[:, None]
                       - nm * cos_p[:, None])
            kids.append((dl_ & ~tir, p - nm * eps, fd, w * r_refr[:, None],
                         torch.where((n2 > 1.001)[:, None], absorb, zero), n2))
        if not kids:
            break
        sel = [k[0].nonzero().squeeze(1) for k in kids]
        owner = torch.cat([owner[s] for s in sel])
        o = torch.cat([k[1][s] for k, s in zip(kids, sel)])
        d = torch.cat([k[2][s] for k, s in zip(kids, sel)])
        w = torch.cat([k[3][s] for k, s in zip(kids, sel)])
        a = torch.cat([k[4][s] for k, s in zip(kids, sel)])
        med = torch.cat([k[5][s] for k, s in zip(kids, sel)])
        dep = torch.cat([dep[s] - 1 for s in sel])
        first = torch.zeros(owner.shape[0], dtype=torch.bool, device=dev)
    return out


# ---- pixels ----

SIGMA = 1.0 / 6.0


def multisample(tb: Tables, pixels: torch.Tensor, jitter: torch.Tensor,
                n_cells: int) -> torch.Tensor:
    """(P, 3) Gaussian-weighted mean radiance of the pixels ``pixels``
    (int64 scanline indices) over n_cells^2 stratified samples whose in-cell
    offsets are ``jitter`` (S, P, 2) (sigma = 1/6 pixel, gaussian.h:3-21;
    main.cpp:79-100)."""
    w = tb.scene.camera.width
    px = (pixels % w).to(torch.float32)
    py = (pixels // w).to(torch.float32)
    inv_2s2 = 1.0 / (2.0 * SIGMA * SIGMA)
    c1 = 1.0 / (2.0 * math.pi * SIGMA * SIGMA)
    acc = torch.zeros((px.shape[0], 3), dtype=tb.dtype, device=px.device)
    wacc = torch.zeros(px.shape[0], dtype=tb.dtype, device=px.device)
    for s in range(n_cells * n_cells):
        row, col = divmod(s, n_cells)
        psi = jitter[s]
        sx = (col + psi[:, 0]) / n_cells
        sy = (row + psi[:, 1]) / n_cells
        o, d = camera_rays(tb.scene, px + sx, py + sy)
        colr = radiance(tb, o, d)
        dx = (sx - 0.5).to(tb.dtype)
        dy = (sy - 0.5).to(tb.dtype)
        wgt = c1 * torch.exp(-(dx * dx + dy * dy) * inv_2s2)
        acc = acc + colr * wgt[:, None]
        wacc = wacc + wgt
    return acc / wacc[:, None]


def to_u8(col: torch.Tensor) -> torch.Tensor:
    """(int)c clamped to [0, 255] (helperMath.cpp:140-152)."""
    return torch.nan_to_num(col.float()).clamp(0.0, 255.0).to(torch.uint8)


def frame_jitter(frame_seed: int, n_pixels: int, n_samples: int, device):
    """(S, n_pixels, 2): the in-cell offsets a frame of ``frame_seed`` draws,
    a (n_pixels, 2) block of ``torch.rand`` per sample from a generator on
    ``device`` seeded with ``frame_seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(frame_seed))
    return torch.stack([torch.rand((n_pixels, 2), generator=g, device=device)
                        for _ in range(n_samples)])


def progressive_mean(tb: Tables, seed: int, pixels: torch.Tensor,
                     upto: list[int], block: int = 1 << 16) -> dict:
    """{k: (P, 3) f32 mean radiance after passes 0..k} at the pixels
    ``pixels``, for each k of ``upto``: pass 0 at the integer pixel
    coordinates, pass s > 0 jittered by its Philox offsets; the sum in
    float64, pass after pass.  Passes are traced together, ``block`` rays
    at a time."""
    from .philox import pass_jitter

    w = tb.scene.camera.width
    n_pix = pixels.shape[0]
    px0 = (pixels % w).to(torch.float32)
    py0 = (pixels // w).to(torch.float32)
    acc = torch.zeros((n_pix, 3), dtype=torch.float64, device=pixels.device)
    out, want = {}, set(upto)
    per = max(block // max(n_pix, 1), 1)
    for s0 in range(0, max(upto) + 1, per):
        passes = range(s0, min(s0 + per, max(upto) + 1))
        px, py = [], []
        for s in passes:
            if s > 0:
                j = pass_jitter(seed, s, pixels)
                px.append(px0 + j[:, 0])
                py.append(py0 + j[:, 1])
            else:
                px.append(px0)
                py.append(py0)
        rad = radiance(tb, *camera_rays(tb.scene, torch.cat(px),
                                        torch.cat(py)))
        rad = rad.to(torch.float64).reshape(len(passes), n_pix, 3)
        for i, s in enumerate(passes):
            acc += rad[i]
            if s in want:
                out[s] = (acc / (s + 1)).to(torch.float32)
    return out
