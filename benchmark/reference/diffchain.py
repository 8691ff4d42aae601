"""The plain reference of the differentiable Whitted render and of the
inverse-rendering job that drives it.

Per ray a chain of max_depth + 1 segments.  Each segment finds its
topology without gradient (the closest hit among the faces at the call's
vertices and the spheres, shadow visibility per light, the material's
branch, the dielectric's one leg: reflection where the branch uniform
falls below the Fresnel reflectance, else refraction, each leg keeping the
weight), then takes one differentiable step: the hit's t by Cramer's rule
through the winner's vertices (a sphere's quadratic through the ray),
Beer's attenuation, the primary miss's background, ambient and Blinn-Phong
point and directional light, and the child ray.  Autograd gives the
gradient.  The shading normal of a face is its normal at the scene file's
vertices, as the program's tables keep it.

``Job`` is the inverse-rendering loop: a loss over ray grids against
targets rendered at the true parameters, ``torch.optim.Adam`` per grid.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import BIG, dot3
from .philox import branch_uniforms
from .scene import MAT_CONDUCTOR, MAT_DIELECTRIC, MAT_MIRROR
from .whitted import Tables, norm3


def _cramer_t(v, o, d):
    """t of the plane hit through vertices v (R, 9), differentiable."""
    v0x, v0y, v0z = v[:, 0], v[:, 1], v[:, 2]
    e1x, e1y, e1z = v0x - v[:, 3], v0y - v[:, 4], v0z - v[:, 5]
    e2x, e2y, e2z = v0x - v[:, 6], v0y - v[:, 7], v0z - v[:, 8]
    bx, by, bz = v0x - o[:, 0], v0y - o[:, 1], v0z - o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    m0 = e2y * dz - dy * e2z
    m1 = e2x * dz - dx * e2z
    m2 = e2x * dy - dx * e2y
    det = e1x * m0 - e1y * m1 + e1z * m2
    safe = torch.where(det == 0.0, 1.0, det)
    q0 = e2y * bz - by * e2z
    q1 = e2x * bz - bx * e2z
    q2 = e2x * by - bx * e2y
    return (e1x * q0 - e1y * q1 + e1z * q2) / safe


def _sphere_t(s, o, d):
    oc = o - s[:, 0:3]
    rad = s[:, 3]
    a = dot3(d, d)
    b = 2.0 * dot3(d, oc)
    cc = dot3(oc, oc) - rad * rad
    delta = b * b - 4.0 * a * cc
    pos = delta > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, delta, 1.0)), 0.0)
    denom = torch.where(a > 0.0, 2.0 * a, 1.0)
    t1 = (-b + sq) / denom
    t2 = (-b - sq) / denom
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    return torch.where(lo > 0.0, lo, hi)


def _conductor_ratio(n2, k2, c):
    n2k2 = n2 * n2 + k2 * k2
    two = 2.0 * n2 * c
    cos2 = c * c
    rs = (n2k2 - two + cos2) / torch.clamp(n2k2 + two + cos2, min=1e-20)
    rp = (n2k2 * cos2 - two + 1.0) / torch.clamp(n2k2 * cos2 + two + 1.0,
                                                 min=1e-20)
    return 0.5 * (rs + rp)


def _powmax(base, e):
    pos = base > 0.0
    val = torch.exp(e * torch.log(torch.where(pos, base, 1.0)))
    return torch.where(pos, val, (e == 0.0).to(val.dtype))


def render(tb: Tables, params: dict, o, d, ud) -> torch.Tensor:
    """(R, 3) radiance of rays o, d with ``params`` (any of
    ``mat_diffuse`` (M, 3), ``pl_intensity`` (P, 3), ``verts`` (V, 3)) in
    place of the scene's, differentiable in them; ``ud`` (max_depth + 1,
    R) the branch uniforms."""
    sc = tb.scene
    dt, dev = tb.dtype, o.device
    r = o.shape[0]
    kd_tab = params.get("mat_diffuse", tb.mat["diffuse"])
    pl_tab = params.get("pl_intensity", tb.pl_intensity)
    verts = params.get("verts")
    faces = torch.as_tensor(sc.faces, device=dev)
    tri9 = (tb.tri9 if verts is None else verts[faces].reshape(-1, 9))
    geo = tb.geometry(tri9.detach())
    mat = tb.mat
    max_depth = sc.max_depth
    depth = max_depth + 1
    diel = bool((sc.mat_type == MAT_DIELECTRIC).any())
    any_spec = bool(np.isin(sc.mat_type, (MAT_MIRROR, MAT_DIELECTRIC,
                                          MAT_CONDUCTOR)).any())
    eps = sc.eps
    zero = torch.zeros((), dtype=dt, device=dev)

    idx = torch.arange(r, device=dev)  # the chain's rays, compacted
    o3, d3 = o.to(dt), d.to(dt)
    w3 = torch.ones((r, 3), dtype=dt, device=dev)
    medium = torch.ones(r, dtype=dt, device=dev)
    absorb = torch.zeros((r, 3), dtype=dt, device=dev)
    out = torch.zeros((r, 3), dtype=dt, device=dev)
    for k in range(depth):
        n = idx.shape[0]
        # ---- topology (stop-grad) ----
        with torch.no_grad():
            od, dd = o3.detach(), d3.detach()
            t0, face, sph, snrm = geo.closest(od, dd)
            hit = t0 < BIG * 0.5
            is_tri, is_sph = face >= 0, sph >= 0
            ng = torch.where(is_tri[:, None], tb.normal[face.clamp(min=0)],
                             norm3(snrm))
            ng = torch.where((is_tri | is_sph)[:, None], ng,
                             torch.tensor([0.0, 0.0, 1.0], dtype=dt,
                                          device=dev))
            matl = torch.where(is_tri, tb.face_mat[face.clamp(min=0)],
                               torch.where(is_sph, tb.sph_mat[sph.clamp(
                                   min=0)], 0))
            mt = mat["type"][matl]
            lit = hit & ~(medium > 1.00001) if diel else hit
            t_safe = torch.where(hit, t0, 0.0)
            p_top = od + t_safe[:, None] * dd
            chain = torch.zeros_like(hit)
            is_mirror = is_cond = d_reflect = d_refract = chain
            next_medium = torch.ones(n, dtype=dt, device=dev)
            next_absorb = torch.zeros((n, 3), dtype=dt, device=dev)
            sgn = ratio_n = torch.ones(n, dtype=dt, device=dev)
            if k < max_depth and any_spec:
                is_mirror = hit & (mt == MAT_MIRROR)
                cos_g = dot3(ng, -dd)
                ratio_g = _conductor_ratio(mat["ior"][matl], mat["k"][matl],
                                           cos_g)
                is_cond = hit & (mt == MAT_CONDUCTOR) & (ratio_g > 1e-4)
                if diel:
                    is_diel = hit & (mt == MAT_DIELECTRIC)
                    cos0 = -dot3(ng, dd)
                    entering = cos0 > 0.0
                    ior = mat["ior"][matl]
                    n1 = torch.where(entering, medium, ior)
                    n2d = torch.where(entering, ior, 1.0)
                    ratio_n = n1 / torch.clamp(n2d, min=1e-20)
                    cos_i = cos0.abs()
                    crit = ratio_n * ratio_n * (1.0 - cos_i * cos_i)
                    tir = crit > 1.0
                    cos_p = torch.where(tir, 0.0, torch.sqrt(
                        torch.clamp(1.0 - crit, min=1e-20)))
                    n2cos, n1cosp = n2d * cos_i, n1 * cos_p
                    rpar = (n2cos - n1cosp) / torch.clamp(n2cos + n1cosp,
                                                          min=1e-20)
                    rperp = (n1 * cos_i - n2d * cos_p) / torch.clamp(
                        n1 * cos_i + n2d * cos_p, min=1e-20)
                    r_refl = 0.5 * (rpar * rpar + rperp * rperp)
                    choose = ud[k][idx].to(dt) < r_refl
                    rl = is_diel & ~tir
                    d_reflect = (is_diel & tir) | (rl & choose)
                    d_refract = rl & ~choose
                    sgn = torch.where(entering, 1.0, -1.0).to(dt)
                    next_medium = torch.where(is_diel & tir, medium,
                                              next_medium)
                    next_medium = torch.where(rl, n2d, next_medium)
                    take = ((is_diel & tir & (medium > 1.0001))
                            | (rl & choose & (n2d > 1.00001))
                            | (rl & ~choose & (n2d > 1.001)))
                    next_absorb = torch.where(take[:, None],
                                              mat["absorb"][matl], next_absorb)
                chain = is_mirror | is_cond | d_reflect | d_refract
            so = p_top + ng * eps
            li = lit.nonzero().squeeze(1)
            vis = []
            for i in range(tb.pl_pos.shape[0]):
                tl = tb.pl_pos[i] - p_top[li]
                d2 = torch.clamp(dot3(tl, tl), min=1e-20)
                wi = tl * (1.0 / torch.sqrt(d2))[:, None]
                v = torch.zeros(n, dtype=torch.bool, device=dev)
                v[li] = ~geo.blocked(so[li], wi, torch.sqrt(d2))
                vis.append(("p", i, v))
            for i in range(tb.dl_wi.shape[0]):
                v = torch.zeros(n, dtype=torch.bool, device=dev)
                v[li] = ~geo.blocked(so[li], tb.dl_wi[i].expand(li.shape[0], 3),
                                     torch.full((li.shape[0],), BIG, dtype=dt,
                                                device=dev))
                vis.append(("d", i, v))

        # ---- the differentiable step ----
        amb3 = mat["ambient"][matl]
        kd3 = kd_tab.to(dt)[matl]
        ks3 = mat["specular"][matl]
        mir3 = mat["mirror"][matl]
        phong = mat["phong"][matl]
        t = torch.zeros(n, dtype=dt, device=dev)
        nrm = torch.where(is_tri[:, None], tb.normal[face.clamp(min=0)],
                          torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev))
        if tri9.shape[0]:
            tc = _cramer_t(tri9[face.clamp(min=0)].to(dt), o3, d3)
            t = torch.where(is_tri, tc, 0.0)
        if tb.sph.shape[0]:
            s_sel = tb.sph[sph.clamp(min=0)]
            ts = _sphere_t(s_sel, o3, d3)
            ns = norm3(o3 + torch.where(is_sph, ts, 0.0)[:, None] * d3
                       - s_sel[:, 0:3])
            t = torch.where(is_sph, ts, t)
            nrm = torch.where(is_sph[:, None], ns, nrm)
        t = torch.where(hit, t, 0.0)
        p = o3 + t[:, None] * d3
        wo = -d3
        wb = w3
        if diel and k > 0:
            wb = w3 * torch.exp(-absorb * t[:, None])
        seg = torch.zeros((n, 3), dtype=dt, device=dev)
        if k == 0:
            seg = seg + torch.where((~hit)[:, None], wb * tb.bg, zero)
        seg = seg + torch.where(lit[:, None], wb * tb.ambient * amb3, zero)

        def shade_unit(wi):
            cos_t = torch.clamp(dot3(wi, nrm), min=0.0)
            h = norm3(wi + wo)
            spec = _powmax(torch.clamp(dot3(h, nrm), min=0.0), phong)
            return kd3 * cos_t[:, None] + ks3 * spec[:, None]

        for kind, i, v in vis:
            g = (lit & v)[:, None]
            if kind == "p":
                tl = tb.pl_pos[i] - p
                d2 = torch.clamp(dot3(tl, tl), min=1e-20)
                u = shade_unit(tl * (1.0 / torch.sqrt(d2))[:, None])
                seg = seg + torch.where(g, wb * pl_tab.to(dt)[i] / d2[:, None]
                                        * u, zero)
            else:
                u = shade_unit(tb.dl_wi[i].expand(n, 3))
                seg = seg + torch.where(g, wb * tb.dl_radiance[i] * u, zero)
        out = out.index_add(0, idx, seg)
        if k == depth - 1 or not any_spec or not bool(chain.any()):
            break
        # ---- the child ----
        ndotwo = dot3(nrm, wo)
        rdir = norm3(2.0 * nrm * ndotwo[:, None] - wo)
        f3 = torch.where(is_mirror[:, None], mir3, zero)
        ratio = _conductor_ratio(mat["ior"][matl], mat["k"][matl], ndotwo)
        f3 = torch.where(is_cond[:, None], mir3 * ratio[:, None], f3)
        o2 = p + nrm * eps
        d2_ = rdir
        w2 = wb * f3
        if diel:
            nm = nrm * sgn[:, None]
            cos_i = -dot3(d3, nm)
            rm = norm3(2.0 * nm * cos_i[:, None] + d3)
            crit = ratio_n * ratio_n * (1.0 - cos_i * cos_i)
            cos_p = torch.sqrt(torch.where(
                d_refract, torch.clamp(1.0 - crit, min=1e-20), 1.0))
            tn = norm3((d3 + nm * cos_i[:, None]) * ratio_n[:, None]
                       - nm * cos_p[:, None])
            o2 = torch.where(d_reflect[:, None], p + nm * eps, o2)
            o2 = torch.where(d_refract[:, None], p - nm * eps, o2)
            d2_ = torch.where(d_reflect[:, None], rm, d2_)
            d2_ = torch.where(d_refract[:, None], tn, d2_)
            w2 = torch.where((d_reflect | d_refract)[:, None], wb, w2)
        keep = chain.nonzero().squeeze(1)
        idx = idx[keep]
        o3, d3, w3 = o2[keep], d2_[keep], w2[keep]
        medium, absorb = next_medium[keep], next_absorb[keep]
    return out


class Job:
    """The inverse-rendering job of a training cell on the reference: the
    loss of a grid, its gradient by autograd, and Adam.

    ``scales`` maps a field to the divisor of its optimized form (the
    appearance job's u = p / max|p_true|); a field without one is
    optimized as it is.  ``norm`` divides the residual (255 for the
    appearance job)."""

    def __init__(self, tb: Tables, true: dict, start: dict, rates: dict,
                 scales: dict, norm: float, draw_seed: int):
        self.tb, self.true, self.scales, self.norm = tb, true, scales, norm
        self.draw_seed = draw_seed
        self.u = {k: (v / scales[k] if k in scales else v).detach().clone()
                  .to(tb.dtype).requires_grad_(True) for k, v in start.items()}
        self.adam = torch.optim.Adam([{"params": [self.u[k]], "lr": rates[k]}
                                      for k in self.u])

    def _ud(self, n):
        return branch_uniforms(self.draw_seed, 0, n, self.tb.scene.max_depth
                               + 1, device=self.tb.device)

    def params(self, u) -> dict:
        return {k: (v * self.scales[k] if k in self.scales else v)
                for k, v in u.items()}

    def target(self, o, d) -> torch.Tensor:
        with torch.no_grad():
            return render(self.tb, {k: v.to(self.tb.dtype)
                                    for k, v in self.true.items()},
                          o, d, self._ud(o.shape[0]))

    def update(self, o, d, target) -> tuple[float, dict]:
        """One value-and-gradient and Adam step on the grid o, d: (the
        loss, each field's gradient as Adam got it)."""
        self.adam.zero_grad(set_to_none=True)
        img = render(self.tb, self.params(self.u), o, d, self._ud(o.shape[0]))
        loss = torch.mean(((img - target) / self.norm) ** 2)
        loss.backward()
        grads = {k: v.grad.detach().clone() for k, v in self.u.items()}
        self.adam.step()
        return float(loss.detach()), grads
