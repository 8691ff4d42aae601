"""The Whitted megakernel (K1a): host tables, the plain torch version and
the wrapper of the CUDA kernel ``csrc/mega_whitted.cu``.

It replaces the Whitted core of the JAX package's fused Pallas kernel
(``ops/pallas/megakernel.py::_kernel``, launched by ``mega_trace_flat``):
per ray, the closest hit over world-space triangles in BVH-ordered 128-face
chunks behind AABB culls plus analytic spheres, shadow rays to point and
directional lights, ambient + Blinn-Phong shading, mirror and conductor
reflection, and the dielectric Fresnel split with Beer attenuation on a
per-ray stack (raytracer.cpp:65-134, 208-415).

Scene constants travel as small f32 tensors (spheres, materials, lights)
that the kernel reads at run time, so one build serves every scene.  A
scene outside this slice's envelope (``mega_missing``) raises
``NotImplementedError`` on CUDA; the plain version runs only for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.scene.types import MaterialType
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

BIG = 3.0e37  # "no hit" distance
CHUNK = 128  # faces per culling chunk (BVH depth-first order)
MAX_FACES = 98304  # beyond this the JAX kernel streams geometry (K1e)
MAX_SPHERES = 8
MAX_MATERIALS = 128
MAX_DEPTH = 10  # stack_k = MAX_DEPTH + 2 = the kernel's MAX_K

_MIRROR = int(MaterialType.MIRROR)
_DIELECTRIC = int(MaterialType.DIELECTRIC)
_CONDUCTOR = int(MaterialType.CONDUCTOR)

# column layouts of the constant tables (mirrored in csrc/mega_whitted.cu)
TRI_COLS = 16  # v0 0:3, v1 3:6, v2 6:9, world normal 9:12, mat 12,
#                mesh light 13, emissive 14, pad 15
SPH_COLS = 26  # minv 0:12 (3x4 row-major), nrm 12:21 (3x3), center 21:24,
#                radius 24, mat 25
MAT_COLS = 20  # type 0, ambient 1:4, diffuse 4:7, specular 7:10,
#                mirror 10:13, phong 13, ior 14, cond_k 15, absorb 16:19
LIGHT_COLS = 6  # point: pos 0:3, intensity 3:6; dir: unit-to-light 0:3,
#                 radiance 3:6


@dataclass(eq=False)
class MegaConsts:
    """Scene constants of one render (tables on the render's device)."""

    n_tri: int
    n_chunks: int
    spheres: torch.Tensor  # (S, SPH_COLS)
    materials: torch.Tensor  # (M, MAT_COLS)
    point_lights: torch.Tensor  # (P, LIGHT_COLS)
    dir_lights: torch.Tensor  # (D, LIGHT_COLS)
    ambient: tuple
    bg: tuple
    eps: float  # shadow_ray_epsilon
    max_depth: int
    has_mirror: bool
    has_dielectric: bool
    has_conductor: bool
    stack_k: int
    max_iters: int


def mega_missing(static, opts) -> list[str]:
    """Features of a scene/render outside this kernel's envelope (empty
    list = eligible).  Mirrors the JAX ``mega_eligible`` for the Whitted
    core; everything beyond it waits for the K1b-K1e slices."""
    missing = []
    if opts.path_tracing:
        missing.append("path tracing")
    if static.n_textures:
        missing.append("textures")
    if static.n_env:
        missing.append("environment light")
    if static.n_spot:
        missing.append("spot lights")
    if static.n_area:
        missing.append("area lights")
    if static.n_mesh_lights:
        missing.append("mesh lights")
    if static.has_motion:
        missing.append("motion blur")
    if static.has_rough:
        missing.append("roughness")
    if static.n_brdfs:
        missing.append("BRDF table")
    if static.has_emissive_mat:
        missing.append("emissive materials")
    if static.n_work_items > MAX_FACES or (static.n_faces
                                           and not static.n_work_items):
        missing.append(f"more than {MAX_FACES:,} faces")
    if not (static.n_work_items or static.n_spheres):
        missing.append("empty scene")
    if static.n_spheres > MAX_SPHERES:
        missing.append(f"more than {MAX_SPHERES} spheres")
    if static.n_materials > MAX_MATERIALS:
        missing.append(f"more than {MAX_MATERIALS} materials")
    if opts.max_depth > MAX_DEPTH:
        missing.append(f"depth above {MAX_DEPTH}")
    return missing


def mega_eligible(static, opts) -> bool:
    """Static feature gate for the kernel (see ``mega_missing``)."""
    return not mega_missing(static, opts)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def build_mega(pack, opts, device=None):
    """(MegaConsts, tri_tab (max(W,1), 16) f32, chunk_tab (n_chunks, 8) f32)
    on ``device`` (default ``cuda``), as the JAX ``build_mega`` builds them
    for a scene inside the envelope: tri table columns 0:16 and one AABB
    (min 0:3, max 3:6) per CHUNK consecutive faces."""
    dev = resolve_device(device)
    st = pack.static
    w = st.n_work_items
    tab = np.zeros((max(w, 1), TRI_COLS), np.float32)
    tab[:, 13] = -1.0
    if w:
        wi_mat = _np(pack.wi_mat)[:w]
        tab[:, 0:3] = _np(pack.wi_v0)[:w]
        tab[:, 3:6] = _np(pack.wi_v1)[:w]
        tab[:, 6:9] = _np(pack.wi_v2)[:w]
        tab[:, 9:12] = _np(pack.wi_normal)[:w]
        tab[:, 12] = wi_mat.astype(np.float32)
        tab[:, 13] = _np(pack.ent_mlight)[_np(pack.wi_ent)[:w]]
        tab[:, 14] = _np(pack.mat_type)[wi_mat] == int(MaterialType.EMISSIVE)

    n_chunks = max((w + CHUNK - 1) // CHUNK, 1)
    ctab = np.zeros((n_chunks, 8), np.float32)
    for ci in range(n_chunks):
        vs = tab[ci * CHUNK:min((ci + 1) * CHUNK, max(w, 1)), 0:9]
        vs = vs.reshape(-1, 3)
        ctab[ci, 0:3] = vs.min(axis=0)
        ctab[ci, 3:6] = vs.max(axis=0)

    sph = np.zeros((st.n_spheres, SPH_COLS), np.float32)
    for i in range(st.n_spheres):
        sph[i, 0:12] = _np(pack.sph_minv)[i].reshape(-1)
        sph[i, 12:21] = _np(pack.sph_nrm)[i].reshape(-1)
        sph[i, 21:24] = _np(pack.sph_center)[i]
        sph[i, 24] = _np(pack.sph_radius)[i]
        sph[i, 25] = _np(pack.sph_material)[i]

    # every row of the pack's material table: a scene without materials
    # still has its one default row, which the kernel may index
    n_mat = len(pack.mat_type)
    mat = np.zeros((n_mat, MAT_COLS), np.float32)
    for i in range(n_mat):
        mat[i, 0] = _np(pack.mat_type)[i]
        mat[i, 1:4] = _np(pack.mat_ambient)[i]
        mat[i, 4:7] = _np(pack.mat_diffuse)[i]
        mat[i, 7:10] = _np(pack.mat_specular)[i]
        mat[i, 10:13] = _np(pack.mat_mirror)[i]
        mat[i, 13] = _np(pack.mat_phong)[i]
        mat[i, 14] = _np(pack.mat_ior)[i]
        mat[i, 15] = _np(pack.mat_cond_k)[i]
        mat[i, 16:19] = _np(pack.mat_absorption)[i]

    pl = np.zeros((st.n_point, LIGHT_COLS), np.float32)
    pl[:, 0:3] = _np(pack.pl_pos)[:st.n_point]
    pl[:, 3:6] = _np(pack.pl_intensity)[:st.n_point]
    dl = np.zeros((st.n_directional, LIGHT_COLS), np.float32)
    for i in range(st.n_directional):
        d = _np(pack.dl_dir)[i].astype(np.float64)
        dl[i, 0:3] = -d / max(np.linalg.norm(d), 1e-30)  # toward the light
        dl[i, 3:6] = _np(pack.dl_radiance)[i]

    max_depth = int(opts.max_depth)
    if st.has_dielectric:
        max_iters = min(2 ** (max_depth + 1), 4096) + 4
        stack_k = max_depth + 2
    else:
        max_iters = max_depth + 2
        stack_k = 0

    def tens(a):
        return torch.as_tensor(a, device=dev)

    mc = MegaConsts(
        n_tri=w, n_chunks=n_chunks,
        spheres=tens(sph), materials=tens(mat),
        point_lights=tens(pl), dir_lights=tens(dl),
        ambient=tuple(float(x) for x in _np(pack.ambient_light)),
        bg=tuple(float(x) for x in _np(pack.bg_color)),
        eps=float(_np(pack.shadow_eps)),
        max_depth=max_depth,
        has_mirror=st.has_mirror, has_dielectric=st.has_dielectric,
        has_conductor=st.has_conductor,
        stack_k=stack_k, max_iters=max_iters,
    )
    return mc, tens(tab), tens(ctab)


# ---------------------------------------------------------------------------
# plain torch version (vectorised over rays)
# ---------------------------------------------------------------------------


def _norm3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _tri_hit(v0, v1, v2, px, py, pz, vx, vy, vz):
    """Cramer's-rule test (Mesh::IntersectFace, src/mesh.cpp:201-236) of
    rays (R,1) against faces (1,F): returns (t, valid), each (R,F)."""
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = v0x - v1[0], v0y - v1[1], v0z - v1[2]
    e2x, e2y, e2z = v0x - v2[0], v0y - v2[1], v0z - v2[2]
    bx, by, bz = v0x - px, v0y - py, v0z - pz
    m0 = e2y * vz - vy * e2z
    m1 = e2x * vz - vx * e2z
    m2 = e2x * vy - vx * e2y
    det_a = e1x * m0 - e1y * m1 + e1z * m2
    safe = torch.where(det_a == 0.0, torch.ones_like(det_a), det_a)
    beta = (bx * m0 - by * m1 + bz * m2) / safe
    n0 = by * vz - vy * bz
    n1 = bx * vz - vx * bz
    n2 = bx * vy - vx * by
    gamma = (e1x * n0 - e1y * n1 + e1z * n2) / safe
    q0 = e2y * bz - by * e2z
    q1 = e2x * bz - bx * e2z
    q2 = e2x * by - bx * e2y
    t = (e1x * q0 - e1y * q1 + e1z * q2) / safe
    valid = ((det_a != 0.0) & (beta >= 0.0) & (gamma >= 0.0)
             & (beta + gamma <= 1.0) & (t > 0.0))
    return t, valid


def _sphere_hit(s, px, py, pz, vx, vy, vz):
    """Quadratic sphere test in object space (Sphere::Intersect,
    src/sphere.cpp:31-72).  ``s`` is one row of the sphere table as Python
    floats.  Returns (t, valid, unnormalised world normal xyz)."""
    m = s[0:12]
    olx = m[0] * px + m[1] * py + m[2] * pz + m[3]
    oly = m[4] * px + m[5] * py + m[6] * pz + m[7]
    olz = m[8] * px + m[9] * py + m[10] * pz + m[11]
    dlx = m[0] * vx + m[1] * vy + m[2] * vz
    dly = m[4] * vx + m[5] * vy + m[6] * vz
    dlz = m[8] * vx + m[9] * vy + m[10] * vz
    ocx, ocy, ocz = olx - s[21], oly - s[22], olz - s[23]
    rad = s[24]
    a = dlx * dlx + dly * dly + dlz * dlz
    b = 2.0 * (dlx * ocx + dly * ocy + dlz * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    delta = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp(delta, min=0.0))
    denom = torch.where(a > 0.0, 2.0 * a, torch.ones_like(a))
    t1 = (-b + sq) / denom
    t2 = (-b - sq) / denom
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    t = torch.where(lo > 0.0, lo, hi)
    valid = (delta >= 0.0) & (t > 0.0) & (a > 0.0)
    prx, pry, prz = ocx + t * dlx, ocy + t * dly, ocz + t * dlz
    nm = s[12:21]
    nwx = nm[0] * prx + nm[1] * pry + nm[2] * prz
    nwy = nm[3] * prx + nm[4] * pry + nm[5] * prz
    nwz = nm[6] * prx + nm[7] * pry + nm[8] * prz
    return t, valid, nwx, nwy, nwz


def _slab_enter(box, px, py, pz, ivx, ivy, ivz, t_b):
    """Chunk AABB slab test (shape.hpp:78-100) — the kernel's cull.  The
    plain version does not skip on it; it only counts the kernel's work."""
    t1 = (box[0] - px) * ivx
    t2 = (box[3] - px) * ivx
    tmin, tmax = torch.minimum(t1, t2), torch.maximum(t1, t2)
    t1 = (box[1] - py) * ivy
    t2 = (box[4] - py) * ivy
    tmin = torch.maximum(tmin, torch.minimum(t1, t2))
    tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    t1 = (box[2] - pz) * ivz
    t2 = (box[5] - pz) * ivz
    tmin = torch.maximum(tmin, torch.minimum(t1, t2))
    tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    return (tmax > 0) & (tmax >= tmin) & (tmin < t_b)


class _Geometry:
    """The scene tables split into per-chunk face columns for the brute
    force sweeps of the plain version."""

    def __init__(self, mc: MegaConsts, tri_tab, chunk_tab, stats):
        self.mc = mc
        self.stats = stats
        self.chunks = []
        for ci in range(mc.n_chunks if mc.n_tri else 0):
            rows = tri_tab[ci * CHUNK:min((ci + 1) * CHUNK, mc.n_tri)]
            cols = [rows[:, k][None, :] for k in range(13)]
            self.chunks.append((cols, chunk_tab[ci].tolist()))
        self.spheres = mc.spheres.tolist()

    def _count(self, key, n):
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + int(n)

    def trace(self, px, py, pz, vx, vy, vz):
        """Closest hit for rays (R,): (t, nx, ny, nz (unit), matf, hit).
        Faces in table order, strict ``t < t_best``: the first index wins a
        tie, as in the kernel's sequential sweep."""
        r = px.shape[0]
        t_b = torch.full((r,), BIG, dtype=px.dtype, device=px.device)
        nx = torch.zeros_like(px)
        ny = torch.zeros_like(px)
        nz = torch.ones_like(px)
        mf = torch.zeros_like(px)
        rays = [c[:, None] for c in (px, py, pz, vx, vy, vz)]
        culled = self.mc.n_chunks > 1
        if culled:
            ivx, ivy, ivz = 1.0 / vx, 1.0 / vy, 1.0 / vz
        for cols, box in self.chunks:
            if culled:
                enter = _slab_enter(box, px, py, pz, ivx, ivy, ivz, t_b)
                self._count("slab_tests", r)
                self._count("tri_tests", enter.sum() * cols[0].shape[1])
            else:
                self._count("tri_tests", r * cols[0].shape[1])
            t, valid = _tri_hit(cols[0:3], cols[3:6], cols[6:9], *rays)
            t = torch.where(valid, t, torch.full_like(t, float("inf")))
            t_c, i_c = t.min(dim=1)  # first index on a tie
            better = t_c < t_b
            t_b = torch.where(better, t_c, t_b)
            nx = torch.where(better, cols[9][0, i_c], nx)
            ny = torch.where(better, cols[10][0, i_c], ny)
            nz = torch.where(better, cols[11][0, i_c], nz)
            mf = torch.where(better, cols[12][0, i_c], mf)
        for s in self.spheres:
            self._count("sphere_tests", r)
            t, valid, nwx, nwy, nwz = _sphere_hit(s, px, py, pz, vx, vy, vz)
            better = valid & (t < t_b)
            t_b = torch.where(better, t, t_b)
            nx = torch.where(better, nwx, nx)
            ny = torch.where(better, nwy, ny)
            nz = torch.where(better, nwz, nz)
            mf = torch.where(better, torch.full_like(mf, s[25]), mf)
        hit = t_b < BIG * 0.5
        nx, ny, nz = _norm3(nx, ny, nz)
        return t_b, nx, ny, nz, mf, hit

    def shadow(self, px, py, pz, vx, vy, vz, limit):
        """Any hit closer than ``limit`` along unit v (IsInShadow,
        src/raytracer.cpp:567-583) for rays (R,)."""
        r = px.shape[0]
        blocked = torch.zeros(r, dtype=torch.bool, device=px.device)
        rays = [c[:, None] for c in (px, py, pz, vx, vy, vz)]
        culled = self.mc.n_chunks > 1
        if culled:
            ivx, ivy, ivz = 1.0 / vx, 1.0 / vy, 1.0 / vz
        for cols, box in self.chunks:
            n_f = cols[0].shape[1]
            live = torch.where(blocked, torch.zeros_like(limit), limit)
            if culled:
                enter = _slab_enter(box, px, py, pz, ivx, ivy, ivz, live)
                self._count("slab_tests", (~blocked).sum())
            else:
                enter = ~blocked
            t, valid = _tri_hit(cols[0:3], cols[3:6], cols[6:9], *rays)
            hits = valid & (t < limit[:, None])
            # the kernel stops at the first blocking face
            first = torch.where(hits.any(dim=1),
                                hits.to(torch.int8).argmax(dim=1) + 1, n_f)
            self._count("tri_tests",
                        torch.where(enter & ~blocked, first, 0).sum())
            blocked = blocked | hits.any(dim=1)
        for s in self.spheres:
            self._count("sphere_tests", (~blocked).sum())
            t, valid = _sphere_hit(s, px, py, pz, vx, vy, vz)[:2]
            blocked = blocked | (valid & (t < limit))
        return blocked


def _powmax(base, e):
    """pow with base clamped > 0 and C-style pow(0, 0) = 1."""
    pos = base > 0.0
    val = torch.exp(e * torch.log(torch.where(pos, base,
                                              torch.ones_like(base))))
    return torch.where(pos, val, torch.where(e == 0.0, torch.ones_like(e),
                                             torch.zeros_like(e)))


def mega_trace_ref(mc: MegaConsts, tri_tab, chunk_tab, o, d, stats=None):
    """Plain torch version of the kernel: radiance (R,3) for rays o/d (R,3).

    The shading tree runs as a loop over iterations, one node per active
    ray each, with the kernel's stack discipline: the reflection leg
    continues in place, a dielectric's refraction leg is pushed, a ray
    without a continuation pops.  Closest hits are brute force over all
    faces, 128 at a time.  ``stats`` (a dict), when given, receives the
    slab, triangle and sphere tests the culled kernel performs on these
    rays, and the numbers of traced and shadow rays."""
    dev, f32 = o.device, torch.float32
    geo = _Geometry(mc, tri_tab, chunk_tab, stats)
    mats = mc.materials.tolist()
    r = o.shape[0]
    ones, zeros = torch.ones(r, dtype=f32, device=dev), torch.zeros(
        r, dtype=f32, device=dev)

    def mat_field(mi, col):
        table = mc.materials[:, col]
        return table[mi]

    L = [zeros.clone() for _ in range(3)]
    co = [o[:, k].clone() for k in range(3)]
    cd = [d[:, k].clone() for k in range(3)]
    cw = [ones.clone() for _ in range(3)]
    ca = [zeros.clone() for _ in range(3)]
    cmed = ones.clone()
    cdep = torch.full((r,), mc.max_depth, dtype=torch.int32, device=dev)
    act = torch.ones(r, dtype=torch.bool, device=dev)
    k = mc.stack_k
    # stack: (K, R) planes for o3 d3 w3 a3 med, plus depth
    s_f = torch.zeros((13, max(k, 1), r), dtype=f32, device=dev)
    s_dep = torch.zeros((max(k, 1), r), dtype=torch.int32, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    diel = mc.has_dielectric
    any_spec = ((mc.has_mirror or mc.has_conductor or diel)
                and mc.max_depth > 0)
    eps = mc.eps
    types = [int(m[0]) for m in mats]

    for it in range(mc.max_iters):
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        if stats is not None:
            stats["traces"] = stats.get("traces", 0) + idx.numel()
        g = [x[idx] for x in (*co, *cd, *cw, *ca, cmed)]
        cox, coy, coz, cdx, cdy, cdz, cwx, cwy, cwz, cax, cay, caz, med = g
        dep = cdep[idx]
        t, nx, ny, nz, matf, hit = geo.trace(cox, coy, coz, cdx, cdy, cdz)
        t_safe = torch.where(hit, t, torch.zeros_like(t))
        if diel:
            cwx = cwx * torch.exp(-cax * t_safe)
            cwy = cwy * torch.exp(-cay * t_safe)
            cwz = cwz * torch.exp(-caz * t_safe)
        lr, lg, lb = (x[idx] for x in L)
        if it == 0:
            miss = ~hit
            lr = lr + torch.where(miss, cwx * mc.bg[0], 0.0)
            lg = lg + torch.where(miss, cwy * mc.bg[1], 0.0)
            lb = lb + torch.where(miss, cwz * mc.bg[2], 0.0)
        px, py, pz = cox + t_safe * cdx, coy + t_safe * cdy, coz + t_safe * cdz
        wox, woy, woz = -cdx, -cdy, -cdz
        inside = (med > 1.00001) if diel else torch.zeros_like(hit)
        lit = hit & ~inside
        mi = matf.to(torch.int64)

        if any(a != 0.0 for a in mc.ambient):
            lr = lr + torch.where(lit, cwx * (mc.ambient[0] * mat_field(mi, 1)), 0.0)
            lg = lg + torch.where(lit, cwy * (mc.ambient[1] * mat_field(mi, 2)), 0.0)
            lb = lb + torch.where(lit, cwz * (mc.ambient[2] * mat_field(mi, 3)), 0.0)
        kd = [mat_field(mi, c) for c in (4, 5, 6)]
        ks = [mat_field(mi, c) for c in (7, 8, 9)]
        phong = mat_field(mi, 13)
        sox, soy, soz = px + nx * eps, py + ny * eps, pz + nz * eps

        def shade_unit(wix, wiy, wiz):
            cos_t = torch.clamp(wix * nx + wiy * ny + wiz * nz, min=0.0)
            hx, hy, hz = _norm3(wix + wox, wiy + woy, wiz + woz)
            cos_hm = torch.clamp(hx * nx + hy * ny + hz * nz, min=0.0)
            spec = _powmax(cos_hm, phong)
            return [kd[c] * cos_t + ks[c] * spec for c in range(3)]

        def add_light(lrgb, wi, irr, gate):
            v = shade_unit(*wi)
            return [lrgb[c] + torch.where(gate, cw3[c] * irr[c] * v[c], 0.0)
                    for c in range(3)]

        cw3 = (cwx, cwy, cwz)
        lrgb = [lr, lg, lb]
        # direct light is computed for lit rays only (the kernel's gate)
        lit_i = lit.nonzero().squeeze(1)
        for lp in mc.point_lights.tolist():
            tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
            d2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
            dist = torch.sqrt(d2)
            inv = 1.0 / dist
            wi = (tlx * inv, tly * inv, tlz * inv)
            blocked = torch.zeros_like(lit)
            if stats is not None:
                stats["shadow_rays"] = stats.get("shadow_rays", 0) + lit_i.numel()
            blocked[lit_i] = geo.shadow(
                sox[lit_i], soy[lit_i], soz[lit_i], wi[0][lit_i],
                wi[1][lit_i], wi[2][lit_i], dist[lit_i])
            lrgb = add_light(lrgb, wi, [lp[3 + c] / d2 for c in range(3)],
                             lit & ~blocked)
        for ld in mc.dir_lights.tolist():
            wi = tuple(torch.full_like(px, ld[c]) for c in range(3))
            blocked = torch.zeros_like(lit)
            if stats is not None:
                stats["shadow_rays"] = stats.get("shadow_rays", 0) + lit_i.numel()
            blocked[lit_i] = geo.shadow(
                sox[lit_i], soy[lit_i], soz[lit_i], wi[0][lit_i],
                wi[1][lit_i], wi[2][lit_i], torch.full_like(px[lit_i], BIG))
            lrgb = add_light(lrgb, wi,
                             [torch.full_like(px, ld[3 + c]) for c in range(3)],
                             lit & ~blocked)
        lr, lg, lb = lrgb

        # ---- children: reflection continues in place, refraction pushes
        new_act = torch.zeros_like(hit)
        nox, noy, noz = px, py, pz
        ndx, ndy, ndz = wox, woy, woz
        nwx, nwy, nwz = cwx, cwy, cwz
        nax = nay = naz = torch.zeros_like(px)
        nmed = torch.ones_like(px)
        sp_i = sp[idx]

        def mask_of(mtype):
            m = torch.zeros_like(hit)
            for i, ty in enumerate(types):
                if ty == mtype:
                    m = m | (matf == float(i))
            return m

        if any_spec:
            can = dep > 0
            ndotwo = nx * wox + ny * woy + nz * woz
            rx, ry, rz = _norm3(2.0 * nx * ndotwo - wox, 2.0 * ny * ndotwo - woy,
                                2.0 * nz * ndotwo - woz)
            mir = [mat_field(mi, c) for c in (10, 11, 12)]
            if mc.has_mirror:
                mm = hit & mask_of(_MIRROR) & can
                new_act = new_act | mm
                nox = torch.where(mm, px + nx * eps, nox)
                noy = torch.where(mm, py + ny * eps, noy)
                noz = torch.where(mm, pz + nz * eps, noz)
                ndx = torch.where(mm, rx, ndx)
                ndy = torch.where(mm, ry, ndy)
                ndz = torch.where(mm, rz, ndz)
                nwx = torch.where(mm, cwx * mir[0], nwx)
                nwy = torch.where(mm, cwy * mir[1], nwy)
                nwz = torch.where(mm, cwz * mir[2], nwz)
            if mc.has_conductor:
                # conductor Fresnel (raytracer.cpp:208-254)
                n2 = mat_field(mi, 14)
                k2 = mat_field(mi, 15)
                cos_t = ndotwo
                n2k2 = n2 * n2 + k2 * k2
                two = 2.0 * n2 * cos_t
                cos2 = cos_t * cos_t
                rs = (n2k2 - two + cos2) / torch.clamp(n2k2 + two + cos2, min=1e-20)
                rp = (n2k2 * cos2 - two + 1.0) / torch.clamp(
                    n2k2 * cos2 + two + 1.0, min=1e-20)
                ratio = 0.5 * (rs + rp)
                cm = hit & mask_of(_CONDUCTOR) & can & (ratio > 1e-4)
                new_act = new_act | cm
                nox = torch.where(cm, px + nx * eps, nox)
                noy = torch.where(cm, py + ny * eps, noy)
                noz = torch.where(cm, pz + nz * eps, noz)
                ndx = torch.where(cm, rx, ndx)
                ndy = torch.where(cm, ry, ndy)
                ndz = torch.where(cm, rz, ndz)
                nwx = torch.where(cm, cwx * mir[0] * ratio, nwx)
                nwy = torch.where(cm, cwy * mir[1] * ratio, nwy)
                nwz = torch.where(cm, cwz * mir[2] * ratio, nwz)
            if diel:
                # dielectric Fresnel split (raytracer.cpp:261-415)
                is_diel = mask_of(_DIELECTRIC)
                ior = mat_field(mi, 14)
                ab = [mat_field(mi, c) for c in (16, 17, 18)]
                cos0 = -(cdx * nx + cdy * ny + cdz * nz)
                entering = cos0 > 0.0
                sgn = torch.where(entering, 1.0, -1.0)
                nmx, nmy, nmz = nx * sgn, ny * sgn, nz * sgn
                cos_i = cos0.abs()
                n1 = torch.where(entering, med, ior)
                n2d = torch.where(entering, ior, torch.ones_like(ior))
                obj_n = n2d
                ratio_n = n1 / torch.clamp(n2d, min=1e-20)
                sin2 = 1.0 - cos_i * cos_i
                crit = ratio_n * ratio_n * sin2
                tir = crit > 1.0
                ndw = nmx * wox + nmy * woy + nmz * woz
                rdx, rdy, rdz = _norm3(2.0 * nmx * ndw - wox, 2.0 * nmy * ndw - woy,
                                       2.0 * nmz * ndw - woz)
                # TIR: reflect only, weight kept, medium kept (292-311)
                is_tir = hit & is_diel & tir & can
                new_act = new_act | is_tir
                tin = is_tir & (med > 1.0001)
                nox = torch.where(is_tir, px + nmx * eps, nox)
                noy = torch.where(is_tir, py + nmy * eps, noy)
                noz = torch.where(is_tir, pz + nmz * eps, noz)
                ndx = torch.where(is_tir, rdx, ndx)
                ndy = torch.where(is_tir, rdy, ndy)
                ndz = torch.where(is_tir, rdz, ndz)
                nax = torch.where(tin, ab[0], nax)
                nay = torch.where(tin, ab[1], nay)
                naz = torch.where(tin, ab[2], naz)
                nmed = torch.where(is_tir, med, nmed)
                # partial reflect + refract (313-410)
                cos_p = torch.sqrt(torch.clamp(1.0 - crit, min=0.0))
                n2cos = n2d * cos_i
                n1cosp = n1 * cos_p
                rpar = (n2cos - n1cosp) / torch.clamp(n2cos + n1cosp, min=1e-20)
                rperp = (n1 * cos_i - n2d * cos_p) / torch.clamp(
                    n1 * cos_i + n2d * cos_p, min=1e-20)
                r_refl = 0.5 * (rpar * rpar + rperp * rperp)
                r_refr = 1.0 - r_refl
                is_rl = hit & is_diel & ~tir & can
                new_act = new_act | is_rl
                rin = is_rl & (obj_n > 1.00001)
                nox = torch.where(is_rl, px + nmx * eps, nox)
                noy = torch.where(is_rl, py + nmy * eps, noy)
                noz = torch.where(is_rl, pz + nmz * eps, noz)
                ndx = torch.where(is_rl, rdx, ndx)
                ndy = torch.where(is_rl, rdy, ndy)
                ndz = torch.where(is_rl, rdz, ndz)
                nwx = torch.where(is_rl, cwx * r_refl, nwx)
                nwy = torch.where(is_rl, cwy * r_refl, nwy)
                nwz = torch.where(is_rl, cwz * r_refl, nwz)
                nax = torch.where(rin, ab[0], nax)
                nay = torch.where(rin, ab[1], nay)
                naz = torch.where(rin, ab[2], naz)
                nmed = torch.where(is_rl, obj_n, nmed)
                # refraction leg -> push (dropped past K slots, as in JAX)
                f0x = (cdx + nmx * cos_i) * ratio_n - nmx * cos_p
                f0y = (cdy + nmy * cos_i) * ratio_n - nmy * cos_p
                f0z = (cdz + nmz * cos_i) * ratio_n - nmz * cos_p
                fdx, fdy, fdz = _norm3(f0x, f0y, f0z)
                fin = obj_n > 1.001
                push = is_rl & (sp_i < k)
                pi = idx[push]
                slot = sp_i[push]
                vals = (px - nmx * eps, py - nmy * eps, pz - nmz * eps,
                        fdx, fdy, fdz, cwx * r_refr, cwy * r_refr, cwz * r_refr,
                        torch.where(fin, ab[0], 0.0), torch.where(fin, ab[1], 0.0),
                        torch.where(fin, ab[2], 0.0), obj_n)
                for f, v in enumerate(vals):
                    s_f[f, slot, pi] = v[push]
                s_dep[slot, pi] = (dep - 1)[push]
                sp_i = sp_i + is_rl.to(sp_i.dtype)

        # ---- pop for rays without a continuation
        ndep = dep - 1
        if k:
            need = ~new_act & (sp_i > 0)
            top = sp_i - 1
            pop_ok = need & (top < k)
            pi = idx[pop_ok]
            slot = top[pop_ok]
            outs = [nox, noy, noz, ndx, ndy, ndz, nwx, nwy, nwz, nax, nay, naz, nmed]
            for f in range(13):
                v = torch.where(need, torch.zeros_like(outs[f]), outs[f])
                v[pop_ok] = s_f[f, slot, pi]
                outs[f] = v
            nox, noy, noz, ndx, ndy, ndz, nwx, nwy, nwz, nax, nay, naz, nmed = outs
            ndep = torch.where(need, torch.zeros_like(ndep), ndep)
            ndep[pop_ok] = s_dep[slot, pi]
            sp_i = sp_i - need.to(sp_i.dtype)
            new_act = new_act | need
        sp[idx] = sp_i

        for dst, v in zip(L, (lr, lg, lb)):
            dst[idx] = v
        for dst, v in zip((*co, *cd, *cw, *ca, cmed),
                          (nox, noy, noz, ndx, ndy, ndz, nwx, nwy, nwz,
                           nax, nay, naz, nmed)):
            dst[idx] = v
        cdep[idx] = ndep
        act[idx] = new_act
    return torch.stack(L, dim=-1)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _check(name, x, shape=None):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"{name}: needs a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def mega_trace(mc: MegaConsts, tri_tab, chunk_tab, o, d):
    """Radiance (R,3) f32 for rays o/d (R,3) f32.

    CPU tensors run the plain version (``mega_trace_ref``); CUDA tensors
    launch the CUDA kernel or raise.  ``mega_trace.launches`` counts the
    kernel launches."""
    if o.device.type == "cpu":
        return mega_trace_ref(mc, tri_tab, chunk_tab, o, d)
    from advanced_cpu_raytracing_tpu_torch.ops import _build

    r = o.shape[0]
    _check("o", o, (r, 3))
    _check("d", d, (r, 3))
    _check("tri_tab", tri_tab, (max(mc.n_tri, 1), TRI_COLS))
    _check("chunk_tab", chunk_tab, (mc.n_chunks, 8))
    for name in ("spheres", "materials", "point_lights", "dir_lights"):
        _check(name, getattr(mc, name))
    if tri_tab.data_ptr() % 16 or chunk_tab.data_ptr() % 16:
        raise ValueError("tri_tab and chunk_tab must be 16-byte aligned")
    if mc.stack_k > MAX_DEPTH + 2:
        raise ValueError(f"stack_k {mc.stack_k} > {MAX_DEPTH + 2}")
    devs = {t.device for t in (o, d, tri_tab, chunk_tab, mc.spheres,
                               mc.materials, mc.point_lights, mc.dir_lights)}
    if len(devs) != 1:
        raise ValueError(f"mega_trace: tensors on several devices {devs}")
    out = torch.empty((r, 3), dtype=torch.float32, device=o.device)
    if r == 0:
        return out
    lib = _build.load("mega_whitted")
    consts = (ctypes.c_float * 7)(mc.eps, *mc.ambient, *mc.bg)
    flags = ((1 if mc.has_mirror else 0) | (2 if mc.has_dielectric else 0)
             | (4 if mc.has_conductor else 0))
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        rc = lib.mega_whitted_launch(
            _ptr(o), _ptr(d), _ptr(out), r,
            _ptr(tri_tab), mc.n_tri, _ptr(chunk_tab), mc.n_chunks,
            _ptr(mc.spheres), mc.spheres.shape[0],
            _ptr(mc.materials), mc.materials.shape[0],
            _ptr(mc.point_lights), mc.point_lights.shape[0],
            _ptr(mc.dir_lights), mc.dir_lights.shape[0],
            consts, mc.max_depth, mc.stack_k, mc.max_iters, flags,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"mega_whitted launch failed: CUDA error {rc} "
                           f"({lib.mega_whitted_error_string(rc).decode()})")
    mega_trace.launches += 1
    return out


mega_trace.launches = 0
