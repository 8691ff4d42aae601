"""The differentiable render: host tables, the plain torch version and the
wrapper of kernel K2a, the fused forward and reverse Whitted chain.

It replaces the Whitted part of the JAX package's fused fwd+bwd Pallas
kernel (``ops/pallas/megabwd.py::_kernel``, launched by ``_bwd_call``,
reduced by ``_reduce_streams``, wrapped by ``make_diff_render``): per ray,
a linear chain of ``bc_depth`` segments; each traces the scene, fixes the
segment's topology (which primitive wins, shadow visibility, the material
branches, the dielectric's reflect-or-refract choice) as constants, and
takes one differentiable step — the hit's t (Cramer's rule through the
winner's vertices, or the sphere's quadratic through the ray), Beer's
attenuation, the primary miss's background, emissive hits, ambient, point
and directional Blinn-Phong light, and the one child ray: mirror,
conductor with its Fresnel ratio, or the dielectric's single sampled leg
(raytracer.cpp:65-134, 208-415, 442-472, 701-806).  The parameters are the
tables of each call, not constants: the materials' ambient, diffuse,
specular, mirror, Phong and radiance columns, the point and directional
intensities, the background, and the world vertices of the work items.

* ``diff_trace_ref`` is the plain version: the chain in torch, under
  ``torch.no_grad()`` for the topology (the port's ``_Geometry`` sweeps)
  and differentiated by autograd through each step;
* ``mega_bwd_trace`` launches ``csrc/mega_bwd.cu`` (K2a): its primal
  instantiation (the forward only) or its fwd+bwd one, whose hand-derived
  reverse sweep scatters the cotangents with atomics in place of the TPU's
  one-hot MXU epilogue;
* ``make_diff_render`` wraps both in a ``torch.autograd.Function``.

The draws are the dielectric's branch uniforms only: one plane per segment
(``(D, R)``, the ``ud`` output of the JAX ``wavefront_rng``), handed in, or
from Philox keyed by (seed, step), counter (ray, segment, 0, 0)
(``ud_table`` is its torch twin).  Scenes outside K2a (``bwd_missing``:
path tracing, spot, area and mesh lights, textures, ...) raise
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import torch

from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.scene.pack import STREAM_MAX_FACES
from advanced_cpu_raytracing_tpu_torch.scene.types import DecalMode
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

BIG = mk.BIG
TWO_PI = mk.TWO_PI
MAT_PARAM_COLS = 16  # ambient 0:3, diffuse 3:6, specular 6:9, mirror 9:12,
# phong 12, radiance 13:16 (the JAX kernel's mat_tab)
# point + directional lights: the kernel keeps a segment's shadow
# visibility as one bit per light (csrc/mega_bwd.cu VIS_BITS)
MAX_LIGHTS = 32


@dataclass(eq=False)
class BwdConsts:
    """Scene facts of the differentiable render that no parameter moves,
    as tensors on one device (the JAX ``BwdConsts``): the K1 tables of the
    initial pack (``mc``: the spheres, the lights' positions and
    directions, the materials' type, ior, absorption index and Beer
    coefficient; the chunk boxes ``chunk_tab`` and ``mc.tree``, built once
    — vertices moved by a parameter keep their old boxes, as in JAX), the
    tri-table columns after the vertices (``tri_rest``: normal, material,
    mesh light, emissive), and the map from the pack's ``verts`` to the
    work items' world vertices, ``rot @ verts[tv] + trn``."""

    mc: mk.MegaConsts
    chunk_tab: torch.Tensor  # (n_chunks, 8)
    tri_rest: torch.Tensor  # (max(W,1), 7): tri-table columns 9:16
    rot: torch.Tensor  # (W, 3, 3)
    trn: torch.Tensor  # (W, 3)
    tv: torch.Tensor  # (W, 3) int64 vertex indices
    mat_types: tuple  # per material: MaterialType int
    max_depth: int
    has_mirror: bool
    has_conductor: bool
    has_dielectric: bool
    has_emissive: bool

    @property
    def n_tri(self) -> int:
        return self.mc.n_tri

    @property
    def n_mat(self) -> int:
        return self.mc.materials.shape[0]

    @property
    def variant(self) -> str:
        """``mega_bwd`` over the 128-face chunks, or ``mega_bwd_tree``."""
        return "mega_bwd" + ("_tree" if self.mc.tree is not None else "")


class BwdTables(NamedTuple):
    """The parameter tables of one call (differentiable)."""

    mat: torch.Tensor  # (M, MAT_PARAM_COLS)
    pl: torch.Tensor  # (P, 3) point-light intensities
    dl: torch.Tensor  # (Pd, 3) directional radiances
    bg: torch.Tensor  # (3,) background
    tri_w: torch.Tensor  # (max(W,1), 9) world vertices v0 v1 v2


class BwdGrads(NamedTuple):
    """Cotangents of ``BwdTables`` and of the rays."""

    mat: torch.Tensor
    pl: torch.Tensor
    dl: torch.Tensor
    bg: torch.Tensor
    tri_w: torch.Tensor
    o: torch.Tensor  # (R, 3)
    d: torch.Tensor  # (R, 3)


def bc_depth(bc: BwdConsts) -> int:
    """Chain segments: the primary ray and max_depth bounces."""
    return bc.max_depth + 1


_DIFFUSE_DECALS = {int(DecalMode.REPLACE_KD), int(DecalMode.BLEND_KD)}


def bwd_missing(static, opts, pack=None) -> list[str]:
    """Features of a scene/render outside K2a (empty list = eligible), each
    worded by what to remove and, where a later slice adds it, which.  The
    JAX ``bwd_eligible``'s semantic gates (no env light, motion, roughness
    or pluggable BRDFs; no specular-slot, Perlin, bump or normal-map
    textures) without its TPU caps (rows, materials, texels, light and
    sphere counts, depth 8); the port's own caps are the K1 kernels' and
    ``MAX_LIGHTS`` point and directional lights."""
    missing = []
    if opts.path_tracing:
        missing.append("path tracing (K2b)")
    for n, what in ((static.n_spot, "spot lights"),
                    (static.n_area, "area lights"),
                    (static.n_mesh_lights, "mesh lights")):
        if n:
            missing.append(f"{what} (K2b)")
    if static.n_textures:
        missing += _texture_missing(static, pack)
    if static.n_env:
        missing.append("an environment light")
    if static.has_motion:
        missing.append("motion blur")
    if static.has_rough:
        missing.append("roughness")
    if static.n_brdfs:
        missing.append("pluggable BRDFs")
    if static.n_faces and not static.n_work_items:
        missing.append(f"more than {STREAM_MAX_FACES:,} faces")
    if not (static.n_work_items or static.n_spheres):
        missing.append("empty scene")
    if static.n_spheres > mk.MAX_SPHERES:
        missing.append(f"more than {mk.MAX_SPHERES} spheres")
    if static.n_materials > mk.MAX_MATERIALS:
        missing.append(f"more than {mk.MAX_MATERIALS} materials")
    if opts.max_depth > mk.MAX_DEPTH:
        missing.append(f"depth above {mk.MAX_DEPTH}")
    if static.n_point + static.n_directional > MAX_LIGHTS:
        missing.append(f"more than {MAX_LIGHTS} point and directional lights")
    return missing


def _texture_missing(static, pack) -> list[str]:
    if pack is None:
        return ["textures"]
    kind = mk._np(pack.tex_kind)[:static.n_textures]
    decal = mk._np(pack.tex_decal)[:static.n_textures]
    timg = mk._np(pack.tex_img)[:static.n_textures]
    missing = []
    if any(kind[i] == 0 and timg[i] >= 0 and int(decal[i]) in _DIFFUSE_DECALS
           for i in range(static.n_textures)):
        missing.append("diffuse image textures (K2c)")
    if any(not (kind[i] == 0 and int(decal[i]) in _DIFFUSE_DECALS)
           for i in range(static.n_textures)):
        missing.append("specular-slot, Perlin, bump or normal-map textures")
    return missing


def bwd_eligible(static, opts, pack=None) -> bool:
    """Static feature gate of K2a (see ``bwd_missing``)."""
    return not bwd_missing(static, opts, pack)


def build_bwd_consts(pack, opts, device=None) -> BwdConsts:
    """The constant tables of the differentiable render of ``pack`` on
    ``device`` (default ``cuda``); raises ``NotImplementedError`` for a
    scene outside K2a."""
    dev = resolve_device(device)
    st = pack.static
    missing = bwd_missing(st, opts, pack)
    if missing:
        raise NotImplementedError(
            "scene outside the differentiable kernel K2a: " + ", ".join(missing))
    mc, tri_tab, chunk_tab = mk.build_mega(pack, opts, device=dev)
    w = st.n_work_items
    ent = pack.ent_fwd.to(dev)[pack.wi_ent[:w].to(dev).long()]  # (W,3,4)
    return BwdConsts(
        mc=mc, chunk_tab=chunk_tab, tri_rest=tri_tab[:, 9:].contiguous(),
        rot=ent[:, :, :3].contiguous(), trn=ent[:, :, 3].contiguous(),
        tv=pack.tri_vidx.to(dev)[pack.wi_face[:w].to(dev).long()].long(),
        mat_types=tuple(int(x) for x in mk._np(pack.mat_type)),
        max_depth=int(opts.max_depth), has_mirror=bool(st.has_mirror),
        has_conductor=bool(st.has_conductor),
        has_dielectric=bool(st.has_dielectric),
        has_emissive=bool(st.has_emissive_mat))


def world_vertices(bc: BwdConsts, verts: torch.Tensor) -> torch.Tensor:
    """The work items' world vertices (max(W,1), 9) from the pack's
    ``verts`` (V,3): ``rot @ verts[tv] + trn`` per corner, elementwise (the
    JAX ``tables``), so that autograd maps their cotangent to ``verts``."""
    if not bc.n_tri:
        return torch.zeros((1, 9), dtype=torch.float32, device=bc.rot.device)
    vk = verts[bc.tv]  # (W, 3 corners, 3)
    tri_w = (bc.rot[:, None, :, :] * vk[:, :, None, :]).sum(-1) \
        + bc.trn[:, None, :]
    return tri_w.reshape(bc.n_tri, 9)


def ud_table(seed: int, step: int, n_rays: int, depth: int,
             device=None) -> torch.Tensor:
    """The dielectric branch uniforms (depth, n_rays) that the kernel draws
    without a table: Philox4x32-10 keyed by (seed, step), counter (ray,
    segment, 0, 0), word 0 (``ops/rng.py``)."""
    return rng.philox_table(seed, step, n_rays, depth, 1, device=device)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm3(v):
    return mk._norm3(*v)


def _powmax(base, e):
    """``powmax`` of the JAX kernel (megabwd.py:469-473): e * log(base)
    only where base > 0, so that autograd gives no gradient elsewhere."""
    pos = base > 0.0
    val = torch.exp(e * torch.log(torch.where(pos, base, 1.0)))
    return torch.where(pos, val, torch.where(e == 0.0, 1.0, 0.0))


def _cramer_t(v9, o, d):
    """The ray parameter of the plane hit through the winner's vertices
    (Mesh::IntersectFace, mesh.cpp:201-236; megabwd.py:809-818): the t of
    ``_tri_hit``, differentiable in v9, o and d."""
    v0x, v0y, v0z, v1x, v1y, v1z, v2x, v2y, v2z = v9
    e1x, e1y, e1z = v0x - v1x, v0y - v1y, v0z - v1z
    e2x, e2y, e2z = v0x - v2x, v0y - v2y, v0z - v2z
    bx, by, bz = v0x - o[0], v0y - o[1], v0z - o[2]
    m0 = e2y * d[2] - d[1] * e2z
    m1 = e2x * d[2] - d[0] * e2z
    m2 = e2x * d[1] - d[0] * e2y
    det_a = e1x * m0 - e1y * m1 + e1z * m2
    safe = torch.where(det_a == 0.0, 1.0, det_a)
    q0 = e2y * bz - by * e2z
    q1 = e2x * bz - bx * e2z
    q2 = e2x * by - bx * e2y
    return (e1x * q0 - e1y * q1 + e1z * q2) / safe


def _sphere_local(s, o, d):
    """The ray in a sphere's object space: s (R, SPH_COLS) rows."""
    ol = [s[:, 4 * i] * o[0] + s[:, 4 * i + 1] * o[1] + s[:, 4 * i + 2] * o[2]
          + s[:, 4 * i + 3] for i in range(3)]
    dl = [s[:, 4 * i] * d[0] + s[:, 4 * i + 1] * d[1] + s[:, 4 * i + 2] * d[2]
          for i in range(3)]
    return ol, dl


def _sphere_t(s, o, d):
    """Differentiable quadratic solve (Sphere::Intersect, sphere.cpp:31-72;
    megabwd.py:545-566), its square root guarded where the discriminant is
    not positive."""
    ol, dl = _sphere_local(s, o, d)
    oc = [ol[i] - s[:, 21 + i] for i in range(3)]
    rad = s[:, 24]
    a = _dot(dl, dl)
    b = 2.0 * _dot(dl, oc)
    cc = _dot(oc, oc) - rad * rad
    delta = b * b - 4.0 * a * cc
    pos = delta > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, delta, 1.0)), 0.0)
    denom = torch.where(a > 0.0, 2.0 * a, 1.0)
    t1 = (-b + sq) / denom
    t2 = (-b - sq) / denom
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    return torch.where(lo > 0.0, lo, hi)


def _sphere_normal(s, o, d, t):
    """Unit world normal at t (megabwd.py:568-580): nrm @ ((ol + t dl) - c)."""
    ol, dl = _sphere_local(s, o, d)
    pr = [ol[i] + t * dl[i] - s[:, 21 + i] for i in range(3)]
    return _norm3([s[:, 12 + 3 * i] * pr[0] + s[:, 13 + 3 * i] * pr[1]
                   + s[:, 14 + 3 * i] * pr[2] for i in range(3)])


def _conductor_ratio(n2, k2, c):
    """The conductor's Fresnel ratio at cos c (raytracer.cpp:208-254;
    megabwd.py:1102-1109)."""
    n2k2 = n2 * n2 + k2 * k2
    two = 2.0 * n2 * c
    cos2 = c * c
    rs = (n2k2 - two + cos2) / torch.clamp(n2k2 + two + cos2, min=1e-20)
    rp = (n2k2 * cos2 - two + 1.0) / torch.clamp(n2k2 * cos2 + two + 1.0,
                                                 min=1e-20)
    return 0.5 * (rs + rp)


def diff_trace_ref(bc: BwdConsts, tabs: BwdTables, o, d, draws=None,
                   stats=None):
    """Plain torch version of K2a: radiance (R,3) of rays o, d (R,3),
    differentiable by autograd in ``tabs`` and in o and d.

    Shaped like the JAX kernel's unrolled chain (megabwd.py:1189-1411):
    for each of the ``bc_depth`` segments, the closest hit of the rays still
    in the chain (the port's ``_Geometry`` over ``tabs.tri_w`` and the
    constant boxes, under ``no_grad``), the stop-grad topology, then one
    differentiable step over every ray (masked, with the JAX kernel's
    guards, so that a masked lane passes no NaN back).  ``draws`` (D, R)
    are the dielectric's branch uniforms, needed in a scene with a
    dielectric.  ``stats``, when given, receives the slab, triangle and
    sphere tests the kernel performs (``_Geometry``'s counts) and the
    traced nodes, shadow rays and lit light evaluations."""
    mc = bc.mc
    dev, f32 = o.device, torch.float32
    r = o.shape[0]
    depth = bc_depth(bc)
    if bc.has_dielectric and (draws is None
                              or tuple(draws.shape) != (depth, r)):
        raise ValueError(f"a scene with a dielectric needs draws ({depth}, {r})")
    with torch.no_grad():
        tri_tab = torch.cat([tabs.tri_w.detach(), bc.tri_rest], 1)
        geo = mk._Geometry(mc, tri_tab, bc.chunk_tab, stats)
        mfix = mc.materials  # type 0, ior 14, k 15, absorption 16:19
        # sphere rows, and an identity row for the lanes that hit no sphere
        n_sph = mc.spheres.shape[0]
        ident = torch.zeros((1, mk.SPH_COLS), dtype=f32, device=dev)
        ident[0, [0, 5, 10, 12, 16, 20, 24]] = 1.0
        sph_tab = torch.cat([mc.spheres, ident])
        pl_pos = mc.point_lights[:, 0:3]
        dl_wi = mc.dir_lights[:, 0:3]
        ambient = torch.tensor(mc.ambient, dtype=f32, device=dev)
    has_amb = any(a != 0.0 for a in mc.ambient)
    eps = mc.eps
    any_spec = bc.has_mirror or bc.has_conductor or bc.has_dielectric

    def count(key, n):
        if stats is not None:
            stats[key] = stats.get(key, 0) + int(n)

    def type_mask(matl, mtype):
        m = torch.zeros(r, dtype=torch.bool, device=dev)
        for i, ty in enumerate(bc.mat_types):
            if ty == mtype:
                m = m | (matl == i)
        return m

    o3 = [o[:, i] for i in range(3)]
    d3 = [d[:, i] for i in range(3)]
    w3 = [torch.ones(r, dtype=f32, device=dev) for _ in range(3)]
    active = torch.ones(r, dtype=torch.bool, device=dev)
    medium = torch.ones(r, dtype=f32, device=dev)
    absorb = torch.zeros((r, 3), dtype=f32, device=dev)
    L = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
    for k in range(depth):
        # ---- topology (stop-grad) ----
        with torch.no_grad():
            od = [c.detach() for c in o3]
            dd = [c.detach() for c in d3]
            idx = active.nonzero().squeeze(1)
            count("traces", idx.numel())
            t0 = torch.zeros(r, dtype=f32, device=dev)
            hit = torch.zeros(r, dtype=torch.bool, device=dev)
            win = torch.full((r,), -1, dtype=torch.int64, device=dev)
            matl = torch.zeros(r, dtype=torch.int64, device=dev)
            if idx.numel():
                tb, _, _, _, mf, _, h, wn = geo.trace(
                    *(c[idx] for c in od + dd), want_win=True)
                t0[idx], hit[idx], win[idx] = tb, h, wn
                matl[idx] = mf.long()
            row = torch.where(win >= 0, win, -1)
            sph = torch.where(win <= -2, -2 - win, -1)
            is_tri, is_sph = row >= 0, sph >= 0
            s_sel = sph_tab[torch.where(is_sph, sph, n_sph)]
            t_safe = torch.where(hit, t0, 0.0)
            n_tri = bc.tri_rest[row.clamp(min=0), 0:3]
            ng = [torch.where(is_tri, n_tri[:, i], 0.0 if i < 2 else 1.0)
                  for i in range(3)]
            if n_sph:
                ns = _sphere_normal(s_sel, od, dd, torch.where(is_sph, t0, 0.0))
                ng = [torch.where(is_sph, ns[i], ng[i]) for i in range(3)]
            is_em = (hit & type_mask(matl, mk._EMISSIVE) if bc.has_emissive
                     else torch.zeros_like(hit))
            lit = hit & ~is_em
            if bc.has_dielectric:
                lit = lit & ~(medium > 1.00001)
            miss_primary = active & ~hit if k == 0 else torch.zeros_like(hit)
            # children: mirror, conductor, dielectric (depth left)
            chain = torch.zeros_like(hit)
            is_mirror = is_cond = d_reflect = d_refract = chain
            next_medium = torch.ones(r, dtype=f32, device=dev)
            next_absorb = torch.zeros((r, 3), dtype=f32, device=dev)
            sgn = ratio_n = torch.ones(r, dtype=f32, device=dev)
            mrow = mfix[matl]
            if k < bc.max_depth and any_spec:
                if bc.has_mirror:
                    is_mirror = hit & type_mask(matl, mk._MIRROR)
                if bc.has_conductor:
                    cos_g = _dot(ng, [-c for c in dd])
                    ratio_g = _conductor_ratio(mrow[:, 14], mrow[:, 15], cos_g)
                    is_cond = hit & type_mask(matl, mk._CONDUCTOR) \
                        & (ratio_g > 1e-4)
                if bc.has_dielectric:
                    is_diel = hit & type_mask(matl, mk._DIELECTRIC)
                    cos0 = -_dot(ng, dd)
                    entering = cos0 > 0.0
                    ior = mrow[:, 14]
                    n1 = torch.where(entering, medium, ior)
                    n2d = torch.where(entering, ior, 1.0)
                    obj_n = n2d
                    ratio_n = mk._div(n1, torch.clamp(n2d, min=1e-20))
                    cos_i = cos0.abs()
                    crit = ratio_n * ratio_n * (1.0 - cos_i * cos_i)
                    tir = crit > 1.0
                    cos_p = torch.where(tir, 0.0, torch.sqrt(
                        torch.clamp(1.0 - crit, min=1e-20)))
                    n2cos = n2d * cos_i
                    n1cosp = n1 * cos_p
                    rpar = (n2cos - n1cosp) / torch.clamp(n2cos + n1cosp,
                                                          min=1e-20)
                    rperp = (n1 * cos_i - n2d * cos_p) / torch.clamp(
                        n1 * cos_i + n2d * cos_p, min=1e-20)
                    r_refl = 0.5 * (rpar * rpar + rperp * rperp)
                    choose_refl = draws[k] < r_refl
                    rl = is_diel & ~tir
                    d_reflect = (is_diel & tir) | (rl & choose_refl)
                    d_refract = rl & ~choose_refl
                    sgn = torch.where(entering, 1.0, -1.0)
                    next_medium = torch.where(is_diel & tir, medium, next_medium)
                    next_medium = torch.where(rl, obj_n, next_medium)
                    take = ((is_diel & tir & (medium > 1.0001))
                            | (rl & choose_refl & (obj_n > 1.00001))
                            | (rl & ~choose_refl & (obj_n > 1.001)))
                    next_absorb = torch.where(take[:, None], mrow[:, 16:19],
                                              next_absorb)
                chain = is_mirror | is_cond | d_reflect | d_refract
            # shadow visibility per light (stop-grad), from the lit lanes
            p_top = [od[i] + t_safe * dd[i] for i in range(3)]
            so = [p_top[i] + ng[i] * eps for i in range(3)]
            lidx = lit.nonzero().squeeze(1)
            vis_p, vis_d = [], []
            for i in range(pl_pos.shape[0]):
                tl = [pl_pos[i, c] - p_top[c] for c in range(3)]
                dist = torch.sqrt(torch.clamp(_dot(tl, tl), min=1e-20))
                inv = 1.0 / dist
                vis_p.append(_visible(geo, lidx, so, [c * inv for c in tl],
                                      dist, r))
            for i in range(dl_wi.shape[0]):
                wi = [dl_wi[i, c].expand(r) for c in range(3)]
                vis_d.append(_visible(geo, lidx, so, wi,
                                      torch.full((r,), BIG, device=dev), r))
            count("shadow_rays", lidx.numel() * (len(vis_p) + len(vis_d)))

        # ---- the differentiable step ----
        matp = tabs.mat[matl]
        amb3 = [matp[:, c] for c in range(3)]
        kd3 = [matp[:, 3 + c] for c in range(3)]
        ks3 = [matp[:, 6 + c] for c in range(3)]
        mir3 = [matp[:, 9 + c] for c in range(3)]
        phong = matp[:, 12]
        rad3 = [matp[:, 13 + c] for c in range(3)]
        t = torch.zeros(r, dtype=f32, device=dev)
        nrm = [torch.where(is_tri, n_tri[:, i], 0.0 if i < 2 else 1.0)
               for i in range(3)]
        if bc.n_tri:
            v9 = tabs.tri_w[row.clamp(min=0)]
            t = torch.where(is_tri, _cramer_t([v9[:, j] for j in range(9)],
                                              o3, d3), 0.0)
        if n_sph:
            ts = _sphere_t(s_sel, o3, d3)
            ns = _sphere_normal(s_sel, o3, d3, torch.where(is_sph, ts, 0.0))
            t = torch.where(is_sph, ts, t)
            nrm = [torch.where(is_sph, ns[i], nrm[i]) for i in range(3)]
        t = torch.where(hit, t, 0.0)
        p = [o3[i] + t * d3[i] for i in range(3)]
        wo = [-c for c in d3]
        wb = w3
        if bc.has_dielectric and k > 0:
            wb = [w3[c] * torch.exp(-absorb[:, c] * t) for c in range(3)]
        seg = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
        for c in range(3):
            if k == 0:
                seg[c] = seg[c] + torch.where(miss_primary,
                                              wb[c] * tabs.bg[c], 0.0)
            if bc.has_emissive:
                seg[c] = seg[c] + torch.where(is_em, wb[c] * rad3[c] * TWO_PI,
                                              0.0)
            if has_amb:
                seg[c] = seg[c] + torch.where(lit, wb[c] * ambient[c] * amb3[c],
                                              0.0)

        def shade_unit(wi):
            cos_t = torch.clamp(_dot(wi, nrm), min=0.0)
            h = _norm3([wi[i] + wo[i] for i in range(3)])
            spec = _powmax(torch.clamp(_dot(h, nrm), min=0.0), phong)
            return [kd3[c] * cos_t + ks3[c] * spec for c in range(3)]

        for i, vis in enumerate(vis_p):
            tl = [pl_pos[i, c] - p[c] for c in range(3)]
            d2 = torch.clamp(_dot(tl, tl), min=1e-20)
            inv = 1.0 / torch.sqrt(d2)
            v = shade_unit([c * inv for c in tl])
            g = lit & vis
            for c in range(3):
                seg[c] = seg[c] + torch.where(
                    g, mk._div(wb[c] * tabs.pl[i, c], d2) * v[c], 0.0)
        for i, vis in enumerate(vis_d):
            v = shade_unit([dl_wi[i, c].expand(r) for c in range(3)])
            g = lit & vis
            for c in range(3):
                seg[c] = seg[c] + torch.where(g, wb[c] * tabs.dl[i, c] * v[c],
                                              0.0)
        count("lit_light_evals", int(lit.sum()) * (len(vis_p) + len(vis_d)))
        L = [L[c] + seg[c] for c in range(3)]
        if k == depth - 1 or not any_spec:
            break
        with torch.no_grad():
            if not bool(chain.any()):
                break
        # ---- the child: mirror, conductor or the dielectric's leg ----
        ndotwo = _dot(nrm, wo)
        rdir = _norm3([2.0 * nrm[i] * ndotwo - wo[i] for i in range(3)])
        f3 = [torch.zeros(r, dtype=f32, device=dev) for _ in range(3)]
        if bc.has_mirror:
            f3 = [torch.where(is_mirror, mir3[c], f3[c]) for c in range(3)]
        if bc.has_conductor:
            ratio = _conductor_ratio(mrow[:, 14], mrow[:, 15], ndotwo)
            f3 = [torch.where(is_cond, mir3[c] * ratio, f3[c]) for c in range(3)]
        o2 = [p[i] + nrm[i] * eps for i in range(3)]
        d2_ = rdir
        w2 = [wb[c] * f3[c] for c in range(3)]
        if bc.has_dielectric:
            nm = [nrm[i] * sgn for i in range(3)]
            cos_i = -_dot(d3, nm)
            rm = _norm3([2.0 * nm[i] * cos_i + d3[i] for i in range(3)])
            crit = ratio_n * ratio_n * (1.0 - cos_i * cos_i)
            cos_p = torch.sqrt(torch.where(
                d_refract, torch.clamp(1.0 - crit, min=1e-20), 1.0))
            tn = _norm3([(d3[i] + nm[i] * cos_i) * ratio_n - nm[i] * cos_p
                         for i in range(3)])
            o2 = [torch.where(d_reflect, p[i] + nm[i] * eps, o2[i])
                  for i in range(3)]
            o2 = [torch.where(d_refract, p[i] - nm[i] * eps, o2[i])
                  for i in range(3)]
            d2_ = [torch.where(d_reflect, rm[i], d2_[i]) for i in range(3)]
            d2_ = [torch.where(d_refract, tn[i], d2_[i]) for i in range(3)]
            w2 = [torch.where(d_reflect | d_refract, wb[c], w2[c])
                  for c in range(3)]
        o3 = [torch.where(chain, o2[i], 0.0) for i in range(3)]
        d3 = [torch.where(chain, d2_[i], 0.0 if i < 2 else 1.0)
              for i in range(3)]
        w3 = [torch.where(chain, w2[c], 0.0) for c in range(3)]
        active, medium, absorb = chain, next_medium, next_absorb
    return torch.stack(L, dim=-1)


def _visible(geo, lidx, so, wi, limit, r):
    """Shadow visibility (R,) bool of rays from ``so`` along ``wi`` up to
    ``limit``, traced for the lanes ``lidx`` (false elsewhere)."""
    vis = torch.zeros(r, dtype=torch.bool, device=so[0].device)
    if lidx.numel():
        blocked = geo.shadow(*(c[lidx] for c in so), *(c[lidx] for c in wi),
                             limit[lidx])
        vis[lidx] = ~blocked
    return vis


# ---------------------------------------------------------------------------
# the kernel's wrapper and the autograd Function
# ---------------------------------------------------------------------------

LIBRARY = "mega_bwd"
# kernel launches per instantiation: the primal (forward only) and the
# fwd+bwd one, each over the chunks or (``_tree``) the tree
LAUNCHES = {k: 0 for k in ("mega_bwd_primal", "mega_bwd",
                           "mega_bwd_primal_tree", "mega_bwd_tree")}
FLAG_EMISSIVE, FLAG_NO_SCATTER = 8, 16


def mega_bwd_trace_ref(bc: BwdConsts, tabs: BwdTables, o, d, draws=None,
                       gbar=None, stats=None):
    """The plain version of ``mega_bwd_trace`` on any device: the radiance
    of ``diff_trace_ref``, and with ``gbar`` the cotangents by autograd (a
    ``BwdGrads``); ``stats`` as ``diff_trace_ref``'s."""
    if gbar is None:
        with torch.no_grad():
            return diff_trace_ref(bc, tabs, o, d, draws, stats)
    leaves = [t.detach().requires_grad_(True) for t in (*tabs, o, d)]
    with torch.enable_grad():
        out = diff_trace_ref(bc, BwdTables(*leaves[:5]), leaves[5], leaves[6],
                             draws, stats)
        grads = torch.autograd.grad(out, leaves, gbar, allow_unused=True)
    return out.detach(), BwdGrads(*(torch.zeros_like(x) if g is None else g
                                    for g, x in zip(grads, leaves)))


def mega_bwd_trace(bc: BwdConsts, tabs: BwdTables, o, d, draws=None,
                   seed: int = 0, step: int = 0, gbar=None,
                   scatter: bool = True):
    """Radiance (R,3) f32 of rays o/d (R,3) f32 under the parameter tables
    ``tabs``; with ``gbar`` (R,3), the radiance's cotangent, also the
    cotangents of ``tabs``, o and d (a ``BwdGrads``).

    CPU tensors run the plain version (autograd for the cotangents); CUDA
    tensors launch K2a or raise: the primal instantiation without
    ``gbar``, the fwd+bwd one with it.  The dielectric's branch uniforms
    come from ``draws`` (D, R) when given, else from Philox keyed by
    (``seed``, ``step``) — on the CPU through ``ud_table``.  ``scatter=False``
    skips the fwd+bwd kernel's scatter of the parameter cotangents (they
    stay 0; a measurement of the scatter's cost).  ``LAUNCHES`` counts the
    launches."""
    r = o.shape[0]
    depth = bc_depth(bc)
    if o.device.type == "cpu":
        if bc.has_dielectric and draws is None:
            draws = ud_table(seed, step, r, depth)
        return mega_bwd_trace_ref(bc, tabs, o, d, draws, gbar)
    from advanced_cpu_raytracing_tpu_torch.ops import _build

    mc = bc.mc
    n_mat, n_pl, n_dl = bc.n_mat, mc.point_lights.shape[0], mc.dir_lights.shape[0]
    w_rows = max(bc.n_tri, 1)
    mk._check("o", o, (r, 3))
    mk._check("d", d, (r, 3))
    mk._check("mat", tabs.mat, (n_mat, MAT_PARAM_COLS))
    mk._check("pl", tabs.pl, (n_pl, 3))
    mk._check("dl", tabs.dl, (n_dl, 3))
    mk._check("bg", tabs.bg, (3,))
    mk._check("tri_w", tabs.tri_w, (w_rows, 9))
    if draws is not None:
        mk._check("draws", draws, (depth, r))
    if gbar is not None:
        mk._check("gbar", gbar, (r, 3))
    if mc.tree is not None and mc.tree_depth > mk.TREE_STACK:
        raise ValueError(f"tree depth {mc.tree_depth} > {mk.TREE_STACK}")
    if depth > mk.MAX_DEPTH + 1:
        raise ValueError(f"depth {depth} segments > {mk.MAX_DEPTH + 1}")
    # the call's tables in the K1 layouts: vertices beside the constant
    # columns, parameters beside the materials' and lights' constants
    m = mc.materials
    tri = torch.cat([tabs.tri_w, bc.tri_rest], 1).contiguous()
    mat = torch.cat([m[:, 0:1], tabs.mat[:, 0:13], m[:, 14:19],
                     tabs.mat[:, 13:16]], 1).contiguous()
    pl = torch.cat([mc.point_lights[:, 0:3], tabs.pl], 1).contiguous()
    dl = torch.cat([mc.dir_lights[:, 0:3], tabs.dl], 1).contiguous()
    tables = [tri, bc.chunk_tab, mc.spheres, mat, pl, dl, tabs.bg]
    if mc.tree is not None:
        tables.append(mc.tree)
    for i, t in enumerate(tables):
        mk._check(f"table {i}", t)
    devs = {t.device for t in (o, d, *tables)}
    devs |= {t.device for t in (draws, gbar) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"mega_bwd_trace: tensors on several devices {devs}")
    if any(t.data_ptr() % 16 for t in (tri, bc.chunk_tab, *(
            [] if mc.tree is None else [mc.tree]))):
        raise ValueError("the tri table, chunk_tab and the tree must be "
                         "16-byte aligned")
    f32 = torch.float32
    out = torch.empty((r, 3), dtype=f32, device=o.device)
    grads = None
    if gbar is not None:
        grads = BwdGrads(
            torch.zeros((n_mat, MAT_PARAM_COLS), dtype=f32, device=o.device),
            torch.zeros((n_pl, 3), dtype=f32, device=o.device),
            torch.zeros((n_dl, 3), dtype=f32, device=o.device),
            torch.zeros(3, dtype=f32, device=o.device),
            torch.zeros((w_rows, 9), dtype=f32, device=o.device),
            torch.zeros((r, 3), dtype=f32, device=o.device),
            torch.zeros((r, 3), dtype=f32, device=o.device))
    if r == 0:
        return out if gbar is None else (out, grads)
    lib = _build.load(LIBRARY)
    consts = (ctypes.c_float * 4)(mc.eps, *mc.ambient)
    flags = ((1 if bc.has_mirror else 0) | (2 if bc.has_dielectric else 0)
             | (4 if bc.has_conductor else 0)
             | (FLAG_EMISSIVE if bc.has_emissive else 0)
             | (0 if scatter else FLAG_NO_SCATTER))

    def ptr(x):
        return ctypes.c_void_p(None if x is None else x.data_ptr())

    g = grads or BwdGrads(*([None] * 7))
    with torch.cuda.device(o.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream)
        rc = lib.mega_bwd_launch(
            mk._ptr(o), mk._ptr(d), ptr(gbar), mk._ptr(out), r,
            mk._ptr(tri), bc.n_tri, mk._ptr(bc.chunk_tab), mc.n_chunks,
            ptr(mc.tree), mk._ptr(mc.spheres), mc.spheres.shape[0],
            mk._ptr(mat), n_mat, mk._ptr(pl), n_pl, mk._ptr(dl), n_dl,
            mk._ptr(tabs.bg), consts, ptr(draws), depth, bc.max_depth, flags,
            ctypes.c_uint32(seed & 0xFFFFFFFF),
            ctypes.c_uint32(step & 0xFFFFFFFF),
            ptr(g.tri_w), ptr(g.mat), ptr(g.pl), ptr(g.dl), ptr(g.bg),
            ptr(g.o), ptr(g.d), stream)
    name = (bc.variant if gbar is not None
            else bc.variant.replace("mega_bwd", "mega_bwd_primal"))
    if rc != 0:
        err = lib.mega_bwd_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({err})")
    LAUNCHES[name] += 1
    return out if gbar is None else (out, grads)


class _Render(torch.autograd.Function):
    """Forward: K2a's primal (or the plain version on the CPU); backward:
    its fwd+bwd instantiation.  The JAX ``make_diff_render``'s
    ``custom_vjp``."""

    @staticmethod
    def forward(ctx, bc, draws, seed, step, mat, pl, dl, bg, tri_w, o, d):
        ctx.bc, ctx.draws, ctx.key = bc, draws, (seed, step)
        ctx.save_for_backward(mat, pl, dl, bg, tri_w, o, d)
        return mega_bwd_trace(bc, BwdTables(mat, pl, dl, bg, tri_w), o, d,
                              draws, seed, step)

    @staticmethod
    def backward(ctx, gbar):
        mat, pl, dl, bg, tri_w, o, d = ctx.saved_tensors
        _, g = mega_bwd_trace(ctx.bc, BwdTables(mat, pl, dl, bg, tri_w), o, d,
                              ctx.draws, *ctx.key, gbar=gbar.contiguous())
        return (None, None, None, None, g.mat, g.pl, g.dl, g.bg, g.tri_w,
                g.o, g.d)


def make_diff_render(pack, opts, device=None):
    """Differentiable render of ``pack`` on ``device`` (default ``cuda``):
    returns ``f(params, o, d, draws=None, seed=0, step=0) -> (R,3)``.

    ``params`` maps any of ``mat_ambient``, ``mat_diffuse``,
    ``mat_specular``, ``mat_mirror``, ``mat_phong``, ``mat_radiance``,
    ``pl_intensity``, ``dl_radiance``, ``bg_color`` and ``verts`` to
    tensors; the others come from ``pack``.  The forward runs K2a's primal,
    ``backward`` its fwd+bwd instantiation (on the CPU, the plain version
    both ways).  The tables are built from ``params`` with torch ops
    outside the kernel (the JAX ``tables``), so the vertices' cotangent
    reaches ``verts`` through autograd.  ``f.bc`` is the scene's
    ``BwdConsts``."""
    bc = build_bwd_consts(pack, opts, device)
    dev = bc.rot.device
    n_mat = bc.n_mat
    n_pl, n_dl = bc.mc.point_lights.shape[0], bc.mc.dir_lights.shape[0]

    def tables(params) -> BwdTables:
        def g(f):
            return params.get(f, getattr(pack, f)).to(dev, torch.float32)

        mat = torch.cat([g("mat_ambient")[:n_mat], g("mat_diffuse")[:n_mat],
                         g("mat_specular")[:n_mat], g("mat_mirror")[:n_mat],
                         g("mat_phong")[:n_mat, None],
                         g("mat_radiance")[:n_mat]], 1)
        return BwdTables(mat, g("pl_intensity").reshape(-1, 3)[:n_pl],
                         g("dl_radiance").reshape(-1, 3)[:n_dl],
                         g("bg_color").reshape(3),
                         world_vertices(bc, g("verts")))

    def f(params, o, d, draws=None, seed: int = 0, step: int = 0):
        tabs = [t.contiguous() for t in tables(params)]
        return _Render.apply(bc, draws, seed, step, *tabs, o.contiguous(),
                             d.contiguous())

    f.bc = bc
    f.tables = tables
    return f
