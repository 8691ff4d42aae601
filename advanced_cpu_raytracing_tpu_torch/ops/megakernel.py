"""The megakernel: host tables, the plain torch version and the wrappers
of its three CUDA variants.

It replaces the JAX package's fused Pallas kernel
(``ops/pallas/megakernel.py::_kernel``, launched by ``mega_trace_flat``):
per ray, the closest hit over world-space triangles in BVH-ordered 128-face
chunks behind AABB culls plus analytic spheres, shadow rays to point and
directional lights, ambient + Blinn-Phong shading, mirror and conductor
reflection, and the dielectric Fresnel split with Beer attenuation on a
per-ray stack (raytracer.cpp:65-134, 208-415) — K1a, ``csrc/mega_whitted.cu``
— and, on top of it, path tracing (GI continuation, Russian roulette,
importance or uniform hemisphere sampling), emissive hits and Monte-Carlo
mesh-light sampling (raytracer.cpp:135-191, 778-803) — K1b,
``csrc/mega_pt.cu``, drawing its randoms through ``ops/rng.py`` — and the
same shading tree extended with spot and area lights, the five pluggable
BRDFs, glossy roughness and motion blur (raytracer.cpp:192-206, 424-440,
720-776; mesh.cpp:167-170) — K1c, the ``mega_ext`` instantiation of the
same ``csrc/mega_pt.cu``.

Scene constants travel as small f32 tensors (spheres, materials, lights,
mesh-light faces) that the kernels read at run time, so one build serves
every scene.  A scene outside the envelope (``mega_missing``) raises
``NotImplementedError``; the plain version runs only for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.scene.types import BrdfType, MaterialType
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

BIG = 3.0e37  # "no hit" distance
CHUNK = 128  # faces per culling chunk (BVH depth-first order)
MAX_FACES = 98304  # beyond this the JAX kernel streams geometry (K1e)
MAX_SPHERES = 8
MAX_MATERIALS = 128
MAX_MESH_LIGHTS = 4
MAX_DEPTH = 10
RR_DEPTH_FLOOR = 8  # bounces past depth 0 under Russian roulette
# stack slots of each kernel: Whitted max_depth + 2; path tracing with
# specular materials (b - 1) * d_total + 4 with b = 3 (dielectric) and
# d_total = MAX_DEPTH + RR_DEPTH_FLOOR
MAX_K_WHITTED = MAX_DEPTH + 2
MAX_K_PT = 2 * (MAX_DEPTH + RR_DEPTH_FLOOR) + 4
TWO_PI = 2.0 * math.pi

_MIRROR = int(MaterialType.MIRROR)
_DIELECTRIC = int(MaterialType.DIELECTRIC)
_CONDUCTOR = int(MaterialType.CONDUCTOR)
_EMISSIVE = int(MaterialType.EMISSIVE)

# column layouts of the constant tables (mirrored in csrc/mega_common.cuh)
TRI_COLS = 16  # v0 0:3, v1 3:6, v2 6:9, world normal 9:12, mat 12,
#                mesh light 13, emissive 14, pad 15
SPH_COLS = 26  # minv 0:12 (3x4 row-major), nrm 12:21 (3x3), center 21:24,
#                radius 24, mat 25
MAT_COLS = 22  # type 0, ambient 1:4, diffuse 4:7, specular 7:10,
#                mirror 10:13, phong 13, ior 14, cond_k 15, absorb 16:19,
#                emission 19:22
LIGHT_COLS = 6  # point: pos 0:3, intensity 3:6; dir: unit-to-light 0:3,
#                 radiance 3:6
ML_FACE_COLS = 10  # world corners v0 0:3, v1 3:6, v2 6:9,
#                    faceArea / surfaceArea 9
ML_LIGHT_COLS = 5  # radiance 0:3, first face row 3, face count 4
SPOT_COLS = 12  # pos 0:3, dir 3:6, intensity 6:9, cos(coverage/2) 9,
#                 cos(falloff/2) 10, max(cos(fall/2) - cos(cov/2), 1e-9) 11
AREA_COLS = 17  # pos 0:3, normal 3:6, radiance 6:9, extent 9, area 10,
#                 u 11:14, v 14:17
MATX_COLS = 11  # roughness 0, BRDF kind 1 (-1: none), exponent 2,
#                 normalized 3, kdfresnel 4, lobe factor 5, diffuse term
#                 6:9, Torrance-Sparrow r0 9 and 1 - r0 10
MOTION_COLS = 3  # per face (world) or per sphere (object space)
ROUGH_MIN = 0.001  # a material is rough above this roughness


def _brdf_consts(kind: int, e: float, normed: bool, kd, ior: float):
    """(lobe factor, diffuse term (3,), r0, 1 - r0) of one material's BRDF,
    in double precision as the JAX kernel folds them into f32 constants
    (megakernel.py:2178-2216; brdf*.cpp)."""
    kd = [float(x) for x in kd]
    lobe, diff = 1.0, kd
    if kind == int(BrdfType.MODIFIED_PHONG) and normed:
        lobe, diff = (e + 2.0) / (2.0 * math.pi), [x / math.pi for x in kd]
    elif kind == int(BrdfType.MODIFIED_BLINN_PHONG) and normed:
        lobe, diff = (e + 8.0) / (8.0 * math.pi), [x / math.pi for x in kd]
    elif kind == int(BrdfType.TORRANCE_SPARROW):
        lobe = (e + 2.0) / (2.0 * math.pi)
    r0 = (ior - 1.0) ** 2 / max((ior + 1.0) ** 2, 1e-20)
    return lobe, diff, r0, 1.0 - r0


@dataclass(eq=False)
class MegaConsts:
    """Scene constants of one render (tables on the render's device)."""

    n_tri: int
    n_chunks: int
    spheres: torch.Tensor  # (S, SPH_COLS)
    materials: torch.Tensor  # (M, MAT_COLS)
    point_lights: torch.Tensor  # (P, LIGHT_COLS)
    dir_lights: torch.Tensor  # (D, LIGHT_COLS)
    ml_faces: torch.Tensor  # (F_l, ML_FACE_COLS), faces of every mesh light
    ml_lights: torch.Tensor  # (L, ML_LIGHT_COLS)
    ambient: tuple
    bg: tuple
    eps: float  # shadow_ray_epsilon
    max_depth: int
    has_mirror: bool
    has_dielectric: bool
    has_conductor: bool
    stack_k: int
    max_iters: int
    # ---- path tracing and emissive surfaces (K1b) ----
    pt: bool = False
    pt_importance: bool = False
    pt_nee: bool = False
    pt_rr: bool = False
    rr_floor: int = RR_DEPTH_FLOOR
    has_emissive: bool = False
    n_draws: int = 0  # draws per node iteration (the rng.py slot layout)
    # ---- spot and area lights, BRDFs, roughness, motion (K1c) ----
    spot_lights: torch.Tensor | None = None  # (N_s, SPOT_COLS)
    area_lights: torch.Tensor | None = None  # (N_a, AREA_COLS)
    mat_ext: torch.Tensor | None = None  # (M, MATX_COLS)
    tri_motion: torch.Tensor | None = None  # (max(W,1), 3) world, per face
    sph_motion: torch.Tensor | None = None  # (S, 3) object space
    has_rough: bool = False
    has_motion: bool = False
    has_brdf: bool = False  # a material shades with a pluggable BRDF
    faces_move: bool = False  # a face has non-zero motion
    spheres_move: bool = False  # a sphere has non-zero motion

    @property
    def kernel(self) -> str:
        """The CUDA variant that renders this scene: the K1c one for spot
        or area lights, BRDFs, roughness or motion; else the K1b one for
        path tracing, emissive surfaces and mesh lights; else the Whitted
        one."""
        if (self.spot_lights.shape[0] or self.area_lights.shape[0]
                or self.has_brdf or self.has_rough or self.has_motion):
            return "mega_ext"
        if self.pt or self.has_emissive or self.ml_lights.shape[0]:
            return "mega_pt"
        return "mega_whitted"


def mega_missing(static, opts) -> list[str]:
    """Features of a scene/render outside the kernels' envelope (empty
    list = eligible).  Mirrors the JAX ``mega_eligible`` for what K1a-K1c
    cover, without its TPU unrolling caps on spot and area lights;
    textures and the environment light wait for K1d, streamed geometry
    for K1e."""
    missing = []
    if static.n_textures:
        missing.append("textures")
    if static.n_env:
        missing.append("environment light")
    if static.n_mesh_lights > MAX_MESH_LIGHTS:
        missing.append(f"more than {MAX_MESH_LIGHTS} mesh lights")
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
    """Static feature gate for the kernels (see ``mega_missing``)."""
    return not mega_missing(static, opts)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _sizing(st, opts):
    """(max_iters, stack_k, n_draws) as the JAX ``build_mega`` sizes them
    (megakernel.py:644-679)."""
    max_depth = int(opts.max_depth)
    any_spec_mat = st.has_mirror or st.has_conductor or st.has_dielectric
    d_total = max_depth + (RR_DEPTH_FLOOR if (opts.path_tracing
                                              and opts.russian_roulette) else 0)
    if opts.path_tracing and not any_spec_mat:
        # diffuse PT: the GI bounce is the ray's continuation, no stack
        max_iters, stack_k = d_total + 2, 0
    elif opts.path_tracing:
        # PT with specular materials: GI (and refraction) children push,
        # a b-ary tree of nodes
        b = 3 if st.has_dielectric else 2
        max_iters = min(b ** (min(d_total, 9) + 1), 4096) + 4
        stack_k = (b - 1) * max(d_total, 1) + 4
    elif st.has_dielectric:
        max_iters, stack_k = min(2 ** (max_depth + 1), 4096) + 4, max_depth + 2
    else:
        max_iters, stack_k = max_depth + 2, 0
    n_ml = st.n_mesh_lights if st.n_work_items else 0
    if (opts.path_tracing or n_ml or st.n_area or st.has_rough
            or st.has_motion or st.n_env):
        # slots: 0 RR | 1-2 GI | 3.. mesh lights (3 each) | area (2 each)
        # | env candidates (48) | roughness (4) | motion time (1)
        n_draws = (3 + 3 * n_ml + 2 * st.n_area + (48 if st.n_env else 0)
                   + (4 if st.has_rough else 0) + (1 if st.has_motion else 0))
    else:
        n_draws = 0
    return max_iters, stack_k, n_draws


def build_mega(pack, opts, device=None):
    """(MegaConsts, tri_tab (max(W,1), 16) f32, chunk_tab (n_chunks, 8) f32)
    on ``device`` (default ``cuda``), as the JAX ``build_mega`` builds them
    for a scene inside the envelope: tri table columns 0:16, one AABB
    (min 0:3, max 3:6) per CHUNK consecutive faces, swept over both ends
    of the motion in motion scenes, and in tables of their own what the
    TPU kernel bakes in as constants or keeps in wider tri-table columns:
    mesh-light faces, spot and area lights, the materials' roughness and
    BRDF, per-face and per-sphere motion."""
    dev = resolve_device(device)
    st = pack.static
    w = st.n_work_items
    tab = np.zeros((max(w, 1), TRI_COLS), np.float32)
    tab[:, 13] = -1.0
    tmo = np.zeros((max(w, 1), MOTION_COLS), np.float32)
    if w:
        wi_mat = _np(pack.wi_mat)[:w]
        tab[:, 0:3] = _np(pack.wi_v0)[:w]
        tab[:, 3:6] = _np(pack.wi_v1)[:w]
        tab[:, 6:9] = _np(pack.wi_v2)[:w]
        tab[:, 9:12] = _np(pack.wi_normal)[:w]
        tab[:, 12] = wi_mat.astype(np.float32)
        tab[:, 13] = _np(pack.ent_mlight)[_np(pack.wi_ent)[:w]]
        tab[:, 14] = _np(pack.mat_type)[wi_mat] == _EMISSIVE
        if st.has_motion:
            tmo[:] = _np(pack.wi_motion)[:w]

    n_chunks = max((w + CHUNK - 1) // CHUNK, 1)
    ctab = np.zeros((n_chunks, 8), np.float32)
    for ci in range(n_chunks):
        lo, hi = ci * CHUNK, min((ci + 1) * CHUNK, max(w, 1))
        vs = tab[lo:hi, 0:9].reshape(-1, 3)
        ctab[ci, 0:3] = vs.min(axis=0)
        ctab[ci, 3:6] = vs.max(axis=0)
        if st.has_motion:
            # the ray origin shifts by +motion * time, so the face sweeps
            # by -motion over time [0, 1]: the box covers both ends
            moved = (vs.reshape(-1, 3, 3) - tmo[lo:hi, None]).reshape(-1, 3)
            ctab[ci, 0:3] = np.minimum(ctab[ci, 0:3], moved.min(axis=0))
            ctab[ci, 3:6] = np.maximum(ctab[ci, 3:6], moved.max(axis=0))

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
    mat[:, 0] = _np(pack.mat_type)
    mat[:, 1:4] = _np(pack.mat_ambient)
    mat[:, 4:7] = _np(pack.mat_diffuse)
    mat[:, 7:10] = _np(pack.mat_specular)
    mat[:, 10:13] = _np(pack.mat_mirror)
    mat[:, 13] = _np(pack.mat_phong)
    mat[:, 14] = _np(pack.mat_ior)
    mat[:, 15] = _np(pack.mat_cond_k)
    mat[:, 16:19] = _np(pack.mat_absorption)
    mat[:, 19:22] = _np(pack.mat_radiance)

    pl = np.zeros((st.n_point, LIGHT_COLS), np.float32)
    pl[:, 0:3] = _np(pack.pl_pos)[:st.n_point]
    pl[:, 3:6] = _np(pack.pl_intensity)[:st.n_point]
    dl = np.zeros((st.n_directional, LIGHT_COLS), np.float32)
    for i in range(st.n_directional):
        d = _np(pack.dl_dir)[i].astype(np.float64)
        dl[i, 0:3] = -d / max(np.linalg.norm(d), 1e-30)  # toward the light
        dl[i, 3:6] = _np(pack.dl_radiance)[i]

    # spot lights (spotLight.h:33-57): cone tests in cosine space, the
    # falloff's denominator folded in double as the JAX kernel folds it
    sl = np.zeros((st.n_spot, SPOT_COLS), np.float32)
    for i in range(st.n_spot):
        chc = float(_np(pack.sl_cos_half_cov)[i])
        chf = float(_np(pack.sl_cos_half_fall)[i])
        sl[i, 0:3] = _np(pack.sl_pos)[i]
        sl[i, 3:6] = _np(pack.sl_dir)[i]
        sl[i, 6:9] = _np(pack.sl_intensity)[i]
        sl[i, 9:12] = (chc, chf, max(chf - chc, 1e-9))
    # area lights (areaLight.h:34-41): a square of side `extent` spanned by
    # u and v around its position
    al = np.zeros((st.n_area, AREA_COLS), np.float32)
    for i in range(st.n_area):
        al[i, 0:3] = _np(pack.al_pos)[i]
        al[i, 3:6] = _np(pack.al_normal)[i]
        al[i, 6:9] = _np(pack.al_radiance)[i]
        al[i, 9] = _np(pack.al_extent)[i]
        al[i, 10] = _np(pack.al_area)[i]
        al[i, 11:14] = _np(pack.al_u)[i]
        al[i, 14:17] = _np(pack.al_v)[i]
    # roughness and the pluggable BRDF of each material, resolved from the
    # scene's BRDF table
    mx = np.zeros((n_mat, MATX_COLS), np.float32)
    mx[:, 0] = _np(pack.mat_roughness)
    mx[:, 1] = -1.0
    if st.n_brdfs:
        mat_brdf = _np(pack.mat_brdf)
        for i in range(n_mat):
            b = int(mat_brdf[i])
            if b < 0:
                continue
            kind = int(_np(pack.brdf_kind)[b])
            e = float(_np(pack.brdf_exponent)[b])
            normed = bool(_np(pack.brdf_normalized)[b])
            lobe, diff, r0, one_r0 = _brdf_consts(kind, e, normed, mat[i, 4:7],
                                                  float(mat[i, 14]))
            mx[i, 1:5] = (kind, e, normed, bool(_np(pack.brdf_kdfresnel)[b]))
            mx[i, 5:11] = (lobe, *diff, r0, one_r0)
    smo = np.zeros((st.n_spheres, MOTION_COLS), np.float32)
    if st.has_motion:
        smo[:] = _np(pack.sph_motion)[:st.n_spheres]

    # mesh lights (MeshLight::SampleRandomPoint, meshLight.h:27-50): each
    # light's work-item rows in table order, weight faceArea / surfaceArea
    # in object space
    ml_faces, ml_lights = [], []
    if st.n_mesh_lights and w:
        wi_ent = _np(pack.wi_ent)[:w]
        wi_face = _np(pack.wi_face)[:w]
        tri_area = _np(pack.tri_area)
        for i in range(st.n_mesh_lights):
            area = float(_np(pack.ml_area)[i])
            rows = np.where(wi_ent == int(_np(pack.ml_ent)[i]))[0]
            ml_lights.append([*_np(pack.ml_radiance)[i], len(ml_faces),
                              len(rows)])
            for rw in rows:
                ml_faces.append([*tab[rw, 0:9],
                                 float(tri_area[wi_face[rw]]) / max(area, 1e-20)])
    ml_faces = np.asarray(ml_faces, np.float32).reshape(-1, ML_FACE_COLS)
    ml_lights = np.asarray(ml_lights, np.float32).reshape(-1, ML_LIGHT_COLS)

    max_iters, stack_k, n_draws = _sizing(st, opts)

    def tens(a):
        return torch.as_tensor(a, device=dev)

    mc = MegaConsts(
        n_tri=w, n_chunks=n_chunks,
        spheres=tens(sph), materials=tens(mat),
        point_lights=tens(pl), dir_lights=tens(dl),
        ml_faces=tens(ml_faces), ml_lights=tens(ml_lights),
        ambient=tuple(float(x) for x in _np(pack.ambient_light)),
        bg=tuple(float(x) for x in _np(pack.bg_color)),
        eps=float(_np(pack.shadow_eps)),
        max_depth=int(opts.max_depth),
        has_mirror=st.has_mirror, has_dielectric=st.has_dielectric,
        has_conductor=st.has_conductor,
        stack_k=stack_k, max_iters=max_iters,
        pt=bool(opts.path_tracing),
        pt_importance=bool(opts.importance_sampling),
        pt_nee=bool(opts.next_event_estimation),
        pt_rr=bool(opts.russian_roulette),
        has_emissive=st.has_emissive_mat,
        n_draws=n_draws,
        spot_lights=tens(sl), area_lights=tens(al), mat_ext=tens(mx),
        tri_motion=tens(tmo), sph_motion=tens(smo),
        has_rough=bool(st.has_rough), has_motion=bool(st.has_motion),
        has_brdf=bool((mx[:, 1] >= 0).any()),
        faces_move=bool(tmo.any()), spheres_move=bool(smo.any()),
    )
    return mc, tens(tab), tens(ctab)


# ---------------------------------------------------------------------------
# plain torch version (vectorised over rays)
# ---------------------------------------------------------------------------


def _norm3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _onb(nx, ny, nz):
    """Axis-swap orthonormal basis (GetOrthonormalBasis,
    helperMath.cpp:59-85; the JAX kernel's ``onb``): unit u, v with n."""
    ax, ay, az = nx.abs(), ny.abs(), nz.abs()
    use_x = (ax < ay) & (ax < az)
    use_y = ~(ax < ay) & (ay < az)
    use_z = ~(use_x | use_y)
    rpx = torch.where(use_x, 1.0, nx)
    rpy = torch.where(use_y, 1.0, ny)
    rpz = torch.where(use_z, 1.0, nz)
    ux, uy, uz = _norm3(rpy * nz - rpz * ny, rpz * nx - rpx * nz,
                        rpx * ny - rpy * nx)
    vx, vy, vz = _norm3(ny * uz - nz * uy, nz * ux - nx * uz,
                        nx * uy - ny * ux)
    return (ux, uy, uz), (vx, vy, vz)


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


def _sphere_hit(s, px, py, pz, vx, vy, vz, mo=None, tau=None):
    """Quadratic sphere test in object space (Sphere::Intersect,
    src/sphere.cpp:31-72).  ``s`` is one row of the sphere table as Python
    floats; with motion ``mo`` (object space, Python floats) the local
    origin moves by ``mo * tau``.  Returns (t, valid, unnormalised world
    normal xyz)."""
    m = s[0:12]
    olx = m[0] * px + m[1] * py + m[2] * pz + m[3]
    oly = m[4] * px + m[5] * py + m[6] * pz + m[7]
    olz = m[8] * px + m[9] * py + m[10] * pz + m[11]
    if mo is not None:
        olx = olx + mo[0] * tau
        oly = oly + mo[1] * tau
        olz = olz + mo[2] * tau
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
            lo, hi = ci * CHUNK, min((ci + 1) * CHUNK, mc.n_tri)
            cols = [tri_tab[lo:hi, k][None, :] for k in range(15)]
            # tests of moving faces among the chunk's first n: moving[n]
            moving = torch.zeros(hi - lo + 1, dtype=torch.int64)
            if mc.has_motion:  # columns 15:18: the faces' motion
                cols += [mc.tri_motion[lo:hi, k][None, :] for k in range(3)]
                moving[1:] = torch.cumsum(
                    (mc.tri_motion[lo:hi] != 0).any(dim=1).cpu(), 0)
            self.chunks.append((cols, chunk_tab[ci].tolist(),
                                moving.to(tri_tab.device)))
        self.spheres = mc.spheres.tolist()
        self.sph_motion = (mc.sph_motion.tolist() if mc.has_motion
                           else [None] * len(self.spheres))

    def _count(self, key, n):
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + int(n)

    def _tri_rays(self, cols, rays, tau):
        """The rays as (R,1) columns against the faces of ``cols``; with
        motion the origin moves by +motion * tau first (mesh.cpp:167-170),
        (R,F) each."""
        if tau is None:
            return rays
        px, py, pz = (p + m * tau[:, None] for p, m in zip(rays[:3], cols[15:18]))
        return [px, py, pz, *rays[3:]]

    def trace(self, px, py, pz, vx, vy, vz, tau=None):
        """Closest hit for rays (R,): (t, nx, ny, nz (unit), matf, mesh
        light id (-1 for none), hit).  Faces in table order, strict
        ``t < t_best``: the first index wins a tie, as in the kernel's
        sequential sweep; a sphere hit resets the mesh-light id.  ``tau``
        (R,) is each ray's motion time in a motion scene."""
        r = px.shape[0]
        t_b = torch.full((r,), BIG, dtype=px.dtype, device=px.device)
        nx = torch.zeros_like(px)
        ny = torch.zeros_like(px)
        nz = torch.ones_like(px)
        mf = torch.zeros_like(px)
        ml = torch.full_like(px, -1.0)
        rays = [c[:, None] for c in (px, py, pz, vx, vy, vz)]
        culled = self.mc.n_chunks > 1
        if culled:
            ivx, ivy, ivz = 1.0 / vx, 1.0 / vy, 1.0 / vz
        for cols, box, moving in self.chunks:
            n_in = (_slab_enter(box, px, py, pz, ivx, ivy, ivz, t_b).sum()
                    if culled else r)
            if culled:
                self._count("slab_tests", r)
            self._count("tri_tests", n_in * cols[0].shape[1])
            self._count("tri_motion_tests", n_in * moving[-1])
            t, valid = _tri_hit(cols[0:3], cols[3:6], cols[6:9],
                                *self._tri_rays(cols, rays, tau))
            t = torch.where(valid, t, torch.full_like(t, float("inf")))
            t_c, i_c = t.min(dim=1)  # first index on a tie
            better = t_c < t_b
            t_b = torch.where(better, t_c, t_b)
            nx = torch.where(better, cols[9][0, i_c], nx)
            ny = torch.where(better, cols[10][0, i_c], ny)
            nz = torch.where(better, cols[11][0, i_c], nz)
            mf = torch.where(better, cols[12][0, i_c], mf)
            ml = torch.where(better, cols[13][0, i_c], ml)
        for s, mo in zip(self.spheres, self.sph_motion):
            self._count("sphere_tests", r)
            if mo is not None and any(mo):
                self._count("sphere_motion_tests", r)
            t, valid, nwx, nwy, nwz = _sphere_hit(s, px, py, pz, vx, vy, vz,
                                                  mo, tau)
            better = valid & (t < t_b)
            t_b = torch.where(better, t, t_b)
            nx = torch.where(better, nwx, nx)
            ny = torch.where(better, nwy, ny)
            nz = torch.where(better, nwz, nz)
            mf = torch.where(better, torch.full_like(mf, s[25]), mf)
            ml = torch.where(better, -1.0, ml)
        hit = t_b < BIG * 0.5
        nx, ny, nz = _norm3(nx, ny, nz)
        return t_b, nx, ny, nz, mf, ml, hit

    def shadow(self, px, py, pz, vx, vy, vz, limit, tau=None):
        """Any hit closer than ``limit`` along unit v (IsInShadow,
        src/raytracer.cpp:567-583) for rays (R,), at motion time ``tau``.
        Emissive faces cast no shadow (CastShadowRay,
        raytracer.cpp:590-593)."""
        r = px.shape[0]
        blocked = torch.zeros(r, dtype=torch.bool, device=px.device)
        rays = [c[:, None] for c in (px, py, pz, vx, vy, vz)]
        culled = self.mc.n_chunks > 1
        if culled:
            ivx, ivy, ivz = 1.0 / vx, 1.0 / vy, 1.0 / vz
        for cols, box, moving in self.chunks:
            n_f = cols[0].shape[1]
            live = torch.where(blocked, torch.zeros_like(limit), limit)
            if culled:
                enter = _slab_enter(box, px, py, pz, ivx, ivy, ivz, live)
                self._count("slab_tests", (~blocked).sum())
            else:
                enter = ~blocked
            t, valid = _tri_hit(cols[0:3], cols[3:6], cols[6:9],
                                *self._tri_rays(cols, rays, tau))
            if self.mc.has_emissive:
                valid = valid & (cols[14] < 0.5)
            hits = valid & (t < limit[:, None])
            # the kernel stops at the first blocking face
            first = torch.where(hits.any(dim=1),
                                hits.to(torch.int8).argmax(dim=1) + 1, n_f)
            tested = enter & ~blocked
            self._count("tri_tests", torch.where(tested, first, 0).sum())
            self._count("tri_motion_tests",
                        torch.where(tested, moving[first], 0).sum())
            blocked = blocked | hits.any(dim=1)
        for s, mo in zip(self.spheres, self.sph_motion):
            self._count("sphere_tests", (~blocked).sum())
            if mo is not None and any(mo):
                self._count("sphere_motion_tests", (~blocked).sum())
            t, valid = _sphere_hit(s, px, py, pz, vx, vy, vz, mo, tau)[:2]
            blocked = blocked | (valid & (t < limit))
        return blocked


def _powmax(base, e):
    """pow with base clamped > 0 and C-style pow(0, 0) = 1."""
    pos = base > 0.0
    val = torch.exp(e * torch.log(torch.where(pos, base,
                                              torch.ones_like(base))))
    return torch.where(pos, val, torch.where(e == 0.0, torch.ones_like(e),
                                             torch.zeros_like(e)))


def _brdf_unit(mx, ks, nrm, wo, wi, h, default):
    """``default`` (diffuse + Blinn-Phong with unit irradiance) replaced,
    for rays whose material has a pluggable BRDF (``mx``: their
    (R, MATX_COLS) rows), by that BRDF's value times cos+ and gated to the
    front side (Raytracer::Shade dispatch, raytracer.cpp:192-206;
    brdf*.cpp; megakernel.py:2159-2221).  ``h`` is the unit half vector."""
    (nx, ny, nz), (wox, woy, woz), (wix, wiy, wiz), (hx, hy, hz) = nrm, wo, wi, h
    kind, e = mx[:, 1], mx[:, 2]
    ndwi = wix * nx + wiy * ny + wiz * nz
    cos_ic = torch.clamp(ndwi, -1.0, 1.0)
    front = cos_ic > 0.0
    cos_pos = torch.clamp(cos_ic, min=0.0)
    cos_den = torch.clamp(cos_ic, min=1e-20)
    rlx, rly, rlz = _norm3(2.0 * nx * ndwi - wix, 2.0 * ny * ndwi - wiy,
                           2.0 * nz * ndwi - wiz)
    cos_r = torch.clamp(rlx * wox + rly * woy + rlz * woz, -1.0, 1.0)
    cos_hc = torch.clamp(hx * nx + hy * ny + hz * nz, -1.0, 1.0)
    # Phong lobes around the mirror direction, Blinn-Phong and
    # Torrance-Sparrow ones around the half vector
    mirror_lobe = (kind == int(BrdfType.PHONG)) | (
        kind == int(BrdfType.MODIFIED_PHONG))
    pw = _powmax(torch.where(mirror_lobe, cos_r, cos_hc), e)
    original = (kind == int(BrdfType.PHONG)) | (
        kind == int(BrdfType.BLINN_PHONG))
    lobe = torch.where(original, pw / cos_den, mx[:, 5] * pw)
    # Torrance-Sparrow (brdfTorranceSparrow.cpp:15-66): Schlick's Fresnel,
    # the geometry term, and 1e-20 for a zero h.wo or n.wi * n.wo
    ts = kind == int(BrdfType.TORRANCE_SPARROW)
    hdwo = hx * wox + hy * woy + hz * woz
    om = torch.clamp(1.0 - hdwo, min=0.0)
    f_t = mx[:, 9] + mx[:, 10] * om * om * om * om * om
    ndwo = nx * wox + ny * woy + nz * woz
    wodh = torch.where(hdwo == 0.0, 1e-20, hdwo)
    g_t = torch.clamp(torch.minimum(2.0 * cos_hc * ndwo / wodh,
                                    2.0 * cos_hc * ndwi / wodh), max=1.0)
    kd_c = torch.where(mx[:, 4] > 0.5, (1.0 - f_t) / math.pi, 1.0 / math.pi)
    nn = ndwi * ndwo
    den = 4.0 * torch.where(nn == 0.0, 1e-20, nn)
    lobe = torch.where(ts, lobe * f_t * g_t / den, lobe)
    out = []
    for c in range(3):
        diff = mx[:, 6 + c]
        val = torch.where(ts, diff * kd_c, diff) + ks[c] * lobe
        gated = torch.where(front, val, 0.0) * cos_pos
        out.append(torch.where(kind >= 0.0, gated, default[c]))
    return out


def _perturb(ax, ay, az, p1, p2, rough, is_rough):
    """Glossy perturbation (Raytracer::Reflect, raytracer.cpp:424-440;
    megakernel.py:2421-2432): unit(a + (u p1 + v p2) roughness) with (u, v)
    the basis around unit(a), where the material is rough; else unit(a)."""
    (ux, uy, uz), (vx, vy, vz) = _onb(*_norm3(ax, ay, az))
    qx, qy, qz = _norm3(ax + (ux * p1 + vx * p2) * rough,
                        ay + (uy * p1 + vy * p2) * rough,
                        az + (uz * p1 + vz * p2) * rough)
    bx, by, bz = _norm3(ax, ay, az)
    return (torch.where(is_rough, qx, bx), torch.where(is_rough, qy, by),
            torch.where(is_rough, qz, bz))


def mega_trace_ref(mc: MegaConsts, tri_tab, chunk_tab, o, d, draws=None,
                   stats=None):
    """Plain torch version of the kernels: radiance (R,3) for rays o/d (R,3).

    The shading tree runs as a loop over iterations, one node per active
    ray each, with the kernel's stack discipline: the reflection leg
    continues in place, a dielectric's refraction leg is pushed, in path
    tracing the GI child continues (diffuse scenes) or is pushed after the
    refraction leg (where a specular chain continues), and a ray without a
    continuation pops.  Closest hits are brute force over all faces, 128 at
    a time; in a motion scene every ray of a primary ray's tree sees the
    scene at the time drawn once for it.  ``draws`` is the draw table
    ``(max_iters * n_draws, R)`` of ``ops/rng.py``, needed when
    ``mc.n_draws > 0``.  ``stats`` (a dict),
    when given, receives the slab, triangle and sphere tests the culled
    kernel performs on these rays, how many of the triangle and sphere
    tests are of a face or sphere that moves (``tri_motion_tests``,
    ``sphere_motion_tests``), and the numbers of traced nodes, GI rays and
    shadow rays."""
    dev, f32 = o.device, torch.float32
    r = o.shape[0]
    if mc.n_draws and (draws is None or tuple(draws.shape) != (
            mc.max_iters * mc.n_draws, r)):
        raise ValueError(f"this scene draws randoms: needs a draw table "
                         f"({mc.max_iters * mc.n_draws}, {r})")
    geo = _Geometry(mc, tri_tab, chunk_tab, stats)
    mats = mc.materials.tolist()
    ones, zeros = torch.ones(r, dtype=f32, device=dev), torch.zeros(
        r, dtype=f32, device=dev)

    def count(key, n):
        if stats is not None:
            stats[key] = stats.get(key, 0) + int(n)

    def mat_field(mi, col):
        return mc.materials[:, col][mi]

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
    sample_direct = (not mc.pt) or mc.pt_nee
    ml_lights = mc.ml_lights.tolist()
    # draw slots of the area lights and of the roughness pairs (rng.py)
    base_area = 3 + 3 * len(ml_lights)
    base_rough = base_area + 2 * mc.area_lights.shape[0]
    # the motion time: one draw per primary ray, at iteration 0, from the
    # last slot (megakernel.py:1776-1779)
    tau_all = (rng.rnd(draws, 0, mc.n_draws - 1, mc.max_iters, mc.n_draws)
               if mc.has_motion else None)

    def mask_of(matf, mtype):
        m = torch.zeros_like(matf, dtype=torch.bool)
        for i, ty in enumerate(types):
            if ty == mtype:
                m = m | (matf == float(i))
        return m

    def push(sp_i, idx, gate, vals, dep):
        """Write the entries ``vals`` of rays ``gate`` at their slot
        ``sp_i``; one past K is dropped but still counted, as in JAX."""
        ok = gate & (sp_i < k)
        pi, slot = idx[ok], sp_i[ok]
        for f, v in enumerate(vals):
            s_f[f, slot, pi] = v[ok]
        s_dep[slot, pi] = dep[ok]
        return sp_i + gate.to(sp_i.dtype)

    for it in range(mc.max_iters):
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        count("traces", idx.numel())

        def rnd(slot):
            return rng.rnd(draws, it, slot, mc.max_iters, mc.n_draws)[idx]

        g = [x[idx] for x in (*co, *cd, *cw, *ca, cmed)]
        cox, coy, coz, cdx, cdy, cdz, cwx, cwy, cwz, cax, cay, caz, med = g
        dep = cdep[idx]
        tau = None if tau_all is None else tau_all[idx]
        t, nx, ny, nz, matf, _, hit = geo.trace(cox, coy, coz, cdx, cdy, cdz,
                                                tau)
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
        mi = matf.to(torch.int64)

        # emissive hit: radiance * 2pi and nothing else (raytracer.cpp:81-84)
        shadeable = hit
        if mc.has_emissive:
            gate_em = hit & mask_of(matf, _EMISSIVE)
            lr = lr + torch.where(gate_em, cwx * mat_field(mi, 19) * TWO_PI, 0.0)
            lg = lg + torch.where(gate_em, cwy * mat_field(mi, 20) * TWO_PI, 0.0)
            lb = lb + torch.where(gate_em, cwz * mat_field(mi, 21) * TWO_PI, 0.0)
            shadeable = hit & ~gate_em
        lit = shadeable & ~inside

        # ---- path tracing: the GI sample, traced at once so that NEE can
        # skip the mesh light it hit (ComputeGlobalIllumination,
        # raytracer.cpp:135-191)
        skip_ml = None
        if mc.pt:
            if mc.pt_rr:
                maxw = torch.maximum(cwx, torch.maximum(cwy, cwz))
                prob = torch.clamp(maxw, 1e-4, 1.0)
                kill = (rnd(0) > prob) & (dep <= 0)
                gi_alive = shadeable & ~kill & (dep > -mc.rr_floor)
                rr_scale = torch.where(dep <= 0, 1.0 / prob, 1.0)
            else:
                gi_alive = shadeable & (dep > 0)
                rr_scale = ones[idx]
            r1, r2 = rnd(1), rnd(2)
            phi = TWO_PI * r1
            if mc.pt_importance:
                sin_t = torch.sqrt(r2)  # theta = asin(sqrt(r2))
                cos_t = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
            else:
                cos_t = r2  # theta = acos(r2)
                sin_t = torch.sqrt(torch.clamp(1.0 - r2 * r2, min=0.0))
            (ubx, uby, ubz), (vbx, vby, vbz) = _onb(nx, ny, nz)
            sc = sin_t * torch.cos(phi)
            ss = sin_t * torch.sin(phi)
            gdx, gdy, gdz = _norm3(ubx * sc + nx * cos_t + vbx * ss,
                                   uby * sc + ny * cos_t + vby * ss,
                                   ubz * sc + nz * cos_t + vbz * ss)
            # the reference's hard-coded GI epsilon (raytracer.cpp:174)
            gox, goy, goz = px + nx * 1e-4, py + ny * 1e-4, pz + nz * 1e-4
            gi = gi_alive.nonzero().squeeze(1)
            count("gi_traces", gi.numel())
            g_hit = torch.zeros_like(hit)
            g_ml = torch.full_like(px, -1.0)
            _, _, _, _, _, ml_i, hit_i = geo.trace(
                gox[gi], goy[gi], goz[gi], gdx[gi], gdy[gi], gdz[gi],
                None if tau is None else tau[gi])
            g_hit[gi] = hit_i
            g_ml[gi] = ml_i
            skip_ml = torch.where(g_hit & (g_ml >= 0.0), g_ml, -1.0)

        if sample_direct and any(a != 0.0 for a in mc.ambient):
            lr = lr + torch.where(lit, cwx * (mc.ambient[0] * mat_field(mi, 1)), 0.0)
            lg = lg + torch.where(lit, cwy * (mc.ambient[1] * mat_field(mi, 2)), 0.0)
            lb = lb + torch.where(lit, cwz * (mc.ambient[2] * mat_field(mi, 3)), 0.0)
        kd = [mat_field(mi, c) for c in (4, 5, 6)]
        ks = [mat_field(mi, c) for c in (7, 8, 9)]
        phong = mat_field(mi, 13)
        sox, soy, soz = px + nx * eps, py + ny * eps, pz + nz * eps

        mxr = mc.mat_ext[mi] if mc.has_brdf else None

        def shade_unit(wix, wiy, wiz):
            cos_t = torch.clamp(wix * nx + wiy * ny + wiz * nz, min=0.0)
            hx, hy, hz = _norm3(wix + wox, wiy + woy, wiz + woz)
            cos_hm = torch.clamp(hx * nx + hy * ny + hz * nz, min=0.0)
            spec = _powmax(cos_hm, phong)
            v = [kd[c] * cos_t + ks[c] * spec for c in range(3)]
            if mxr is not None:
                v = _brdf_unit(mxr, ks, (nx, ny, nz), (wox, woy, woz),
                               (wix, wiy, wiz), (hx, hy, hz), v)
            return v

        def add_light(lrgb, wi, irr, gate):
            v = shade_unit(*wi)
            return [lrgb[c] + torch.where(gate, cw3[c] * irr[c] * v[c], 0.0)
                    for c in range(3)]

        def shadow_of(gate, wi, limit):
            """Shadow rays of the rays in ``gate`` (the kernel casts no
            others)."""
            sel = gate.nonzero().squeeze(1)
            count("shadow_rays", sel.numel())
            blocked = torch.zeros_like(gate)
            blocked[sel] = geo.shadow(sox[sel], soy[sel], soz[sel], wi[0][sel],
                                      wi[1][sel], wi[2][sel], limit[sel],
                                      None if tau is None else tau[sel])
            return blocked

        cw3 = (cwx, cwy, cwz)
        lrgb = [lr, lg, lb]
        for lp in (mc.point_lights.tolist() if sample_direct else ()):
            tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
            d2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
            dist = torch.sqrt(d2)
            inv = 1.0 / dist
            wi = (tlx * inv, tly * inv, tlz * inv)
            blocked = shadow_of(lit, wi, dist)
            lrgb = add_light(lrgb, wi, [lp[3 + c] / d2 for c in range(3)],
                             lit & ~blocked)
        for ld in (mc.dir_lights.tolist() if sample_direct else ()):
            wi = tuple(torch.full_like(px, ld[c]) for c in range(3))
            blocked = shadow_of(lit, wi, torch.full_like(px, BIG))
            lrgb = add_light(lrgb, wi,
                             [torch.full_like(px, ld[3 + c]) for c in range(3)],
                             lit & ~blocked)
        # spot lights (raytracer.cpp:767-776, spotLight.h:33-57): the cone
        # tests in cosine space, falloff ((cos a - cos(cov/2)) /
        # (cos(fall/2) - cos(cov/2)))^4
        for sl in (mc.spot_lights.tolist() if sample_direct else ()):
            tlx, tly, tlz = sl[0] - px, sl[1] - py, sl[2] - pz
            d2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
            dist = torch.sqrt(d2)
            inv = 1.0 / dist
            wi = (tlx * inv, tly * inv, tlz * inv)
            cos_a = torch.clamp(-(sl[3] * wi[0] + sl[4] * wi[1] + sl[5] * wi[2]),
                                -1.0, 1.0)
            irr = 1.0 / d2
            frac = torch.clamp((cos_a - sl[9]) / sl[11], min=0.0)
            scale = torch.where(cos_a < sl[10], frac * frac * frac * frac, 1.0)
            scale = torch.where((cos_a >= 1.0) | (cos_a < sl[9]), 0.0, scale)
            blocked = shadow_of(lit, wi, dist)
            lrgb = add_light(lrgb, wi, [sl[6 + c] * irr * scale for c in range(3)],
                             lit & ~blocked)
        # area lights (raytracer.cpp:720-740, areaLight.h:34-41): one
        # uniform point on the square, a two-sided cosine
        for ai, al in enumerate(mc.area_lights.tolist() if sample_direct else ()):
            o1 = rnd(base_area + 2 * ai) - 0.5
            o2 = rnd(base_area + 2 * ai + 1) - 0.5
            ext = al[9]
            tlx, tly, tlz = (al[c] + al[11 + c] * (ext * o1)
                             + al[14 + c] * (ext * o2) - p
                             for c, p in enumerate((px, py, pz)))
            d2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
            dist = torch.sqrt(d2)
            inv = 1.0 / dist
            wi = (tlx * inv, tly * inv, tlz * inv)
            irr = al[10] * torch.abs(al[3] * wi[0] + al[4] * wi[1]
                                     + al[5] * wi[2]) / d2
            blocked = shadow_of(lit, wi, dist)
            lrgb = add_light(lrgb, wi, [al[6 + c] * irr for c in range(3)],
                             lit & ~blocked)
        # mesh lights (raytracer.cpp:778-803, meshLight.h:27-50): a face
        # picked uniformly, a sqrt-warped barycentric point, irradiance =
        # radiance * (faceArea / surfaceArea) * 2pi; the ray whose GI ray
        # hit this light skips it
        for li, (rad_r, rad_g, rad_b, first, n_f) in enumerate(
                ml_lights if sample_direct else ()):
            fsel = torch.clamp((rnd(3 + 3 * li) * float(n_f)).to(torch.int64),
                               max=int(n_f) - 1)
            face = mc.ml_faces[int(first) + fsel]
            b1, b2 = rnd(4 + 3 * li), rnd(5 + 3 * li)
            sq = torch.sqrt(b1)
            q = [face[:, 3 + c] * (1.0 - b2) + face[:, 6 + c] * b2
                 for c in range(3)]
            tx, ty, tz = (face[:, c] * (1.0 - sq) + q[c] * sq - p
                          for c, p in enumerate((px, py, pz)))
            d2 = torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-20)
            dist = torch.sqrt(d2)
            inv = 1.0 / dist
            wi = (tx * inv, ty * inv, tz * inv)
            gate_in = lit if skip_ml is None else lit & (skip_ml != float(li))
            blocked = shadow_of(gate_in, wi, dist)
            wgt = face[:, 9]
            lrgb = add_light(lrgb, wi, [rad * wgt * TWO_PI for rad in
                                        (rad_r, rad_g, rad_b)],
                             gate_in & ~blocked)
        lr, lg, lb = lrgb

        # ---- children: reflection continues in place, refraction pushes
        new_act = torch.zeros_like(hit)
        nox, noy, noz = px, py, pz
        ndx, ndy, ndz = wox, woy, woz
        nwx, nwy, nwz = cwx, cwy, cwz
        nax = nay = naz = torch.zeros_like(px)
        nmed = torch.ones_like(px)
        sp_i = sp[idx]

        if mc.pt:
            # GI child weight: Shade(w_i = gi, unit Li) * 2pi * rr_scale
            # (raytracer.cpp:188, 202); it exists only where the GI ray hit
            gv = shade_unit(gdx, gdy, gdz)
            fac = TWO_PI * rr_scale
            gi_w = [c * v * fac for c, v in zip(cw3, gv)]
            if not any_spec:  # diffuse PT: the GI sample is the continuation
                new_act = g_hit
                nox, noy, noz = gox, goy, goz
                ndx, ndy, ndz = gdx, gdy, gdz
                nwx, nwy, nwz = gi_w
                nmed = med

        if any_spec:
            can = dep > 0
            ndotwo = nx * wox + ny * woy + nz * woz
            rx, ry, rz = _norm3(2.0 * nx * ndotwo - wox, 2.0 * ny * ndotwo - woy,
                                2.0 * nz * ndotwo - woz)
            if mc.has_rough:
                # one psi pair per node for the mirror, conductor and
                # dielectric reflection, a second for the refraction leg
                rough = mc.mat_ext[:, 0][mi]
                is_rough = rough > ROUGH_MIN
                rp1 = rnd(base_rough) - 0.5
                rp2 = rnd(base_rough + 1) - 0.5
                rx, ry, rz = _perturb(rx, ry, rz, rp1, rp2, rough, is_rough)
            mir = [mat_field(mi, c) for c in (10, 11, 12)]
            if mc.has_mirror:
                mm = shadeable & mask_of(matf, _MIRROR) & can
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
                cm = shadeable & mask_of(matf, _CONDUCTOR) & can & (ratio > 1e-4)
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
                is_diel = mask_of(matf, _DIELECTRIC)
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
                if mc.has_rough:
                    rdx, rdy, rdz = _perturb(rdx, rdy, rdz, rp1, rp2, rough,
                                             is_rough)
                # TIR: reflect only, weight kept, medium kept (292-311)
                is_tir = shadeable & is_diel & tir & can
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
                is_rl = shadeable & is_diel & ~tir & can
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
                # refraction leg -> push
                f0x = (cdx + nmx * cos_i) * ratio_n - nmx * cos_p
                f0y = (cdy + nmy * cos_i) * ratio_n - nmy * cos_p
                f0z = (cdz + nmz * cos_i) * ratio_n - nmz * cos_p
                if mc.has_rough:  # perturbed on the raw vector (366-375)
                    fdx, fdy, fdz = _perturb(
                        f0x, f0y, f0z, rnd(base_rough + 2) - 0.5,
                        rnd(base_rough + 3) - 0.5, rough, is_rough)
                else:
                    fdx, fdy, fdz = _norm3(f0x, f0y, f0z)
                fin = obj_n > 1.001
                sp_i = push(sp_i, idx, is_rl, (
                    px - nmx * eps, py - nmy * eps, pz - nmz * eps,
                    fdx, fdy, fdz, cwx * r_refr, cwy * r_refr, cwz * r_refr,
                    torch.where(fin, ab[0], 0.0), torch.where(fin, ab[1], 0.0),
                    torch.where(fin, ab[2], 0.0), obj_n), dep - 1)

            if mc.pt:
                # the GI child continues where no specular chain does, and
                # is pushed after the refraction leg where one does
                gi_cont = g_hit & ~new_act
                gi_push = g_hit & new_act
                nox = torch.where(gi_cont, gox, nox)
                noy = torch.where(gi_cont, goy, noy)
                noz = torch.where(gi_cont, goz, noz)
                ndx = torch.where(gi_cont, gdx, ndx)
                ndy = torch.where(gi_cont, gdy, ndy)
                ndz = torch.where(gi_cont, gdz, ndz)
                nwx = torch.where(gi_cont, gi_w[0], nwx)
                nwy = torch.where(gi_cont, gi_w[1], nwy)
                nwz = torch.where(gi_cont, gi_w[2], nwz)
                nax = torch.where(gi_cont, 0.0, nax)
                nay = torch.where(gi_cont, 0.0, nay)
                naz = torch.where(gi_cont, 0.0, naz)
                nmed = torch.where(gi_cont, med, nmed)
                zero = torch.zeros_like(px)
                sp_i = push(sp_i, idx, gi_push, (
                    gox, goy, goz, gdx, gdy, gdz, *gi_w, zero, zero, zero, med),
                    dep - 1)
                new_act = new_act | gi_cont

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
# kernel wrappers
# ---------------------------------------------------------------------------

# kernel launches per variant; only the launches of the CUDA kernels count
LAUNCHES = {"mega_whitted": 0, "mega_pt": 0, "mega_ext": 0}
# the csrc/<library>.cu that holds each variant
LIBRARY = {"mega_whitted": "mega_whitted", "mega_pt": "mega_pt",
           "mega_ext": "mega_pt"}
# flags of the K1c variant, beside the K1a/K1b ones (csrc/mega_pt.cu)
FLAG_ROUGH, FLAG_MOTION = 256, 512


def _check(name, x, shape=None):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"{name}: needs a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def mega_trace(mc: MegaConsts, tri_tab, chunk_tab, o, d, draws=None,
               seed: int = 0, sample: int = 0):
    """Radiance (R,3) f32 for rays o/d (R,3) f32.

    CPU tensors run the plain version (``mega_trace_ref``); CUDA tensors
    launch the scene's CUDA kernel (``mc.kernel``) or raise.  A scene that
    draws randoms (``mc.n_draws > 0``) takes them from ``draws`` (the
    ``ops/rng.py`` table) when given, else from Philox keyed by (``seed``,
    ``sample``) — on the CPU through the table that ``philox_table`` makes
    for the same key, so both devices draw the same numbers.  ``LAUNCHES``
    counts the kernel launches."""
    r = o.shape[0]
    if o.device.type == "cpu":
        if mc.n_draws and draws is None:
            draws = rng.philox_table(seed, sample, r, mc.max_iters, mc.n_draws)
        return mega_trace_ref(mc, tri_tab, chunk_tab, o, d, draws=draws)
    from advanced_cpu_raytracing_tpu_torch.ops import _build

    _check("o", o, (r, 3))
    _check("d", d, (r, 3))
    _check("tri_tab", tri_tab, (max(mc.n_tri, 1), TRI_COLS))
    _check("chunk_tab", chunk_tab, (mc.n_chunks, 8))
    tables = ["spheres", "materials", "point_lights", "dir_lights"]
    name = mc.kernel
    if name != "mega_whitted":
        tables += ["ml_faces", "ml_lights"]
        if draws is not None:
            _check("draws", draws, (mc.max_iters * mc.n_draws, r))
    if name == "mega_ext":
        tables += ["spot_lights", "area_lights", "mat_ext", "tri_motion",
                   "sph_motion"]
        _check("tri_motion", mc.tri_motion, (max(mc.n_tri, 1), MOTION_COLS))
        _check("mat_ext", mc.mat_ext, (mc.materials.shape[0], MATX_COLS))
    for t in tables:
        _check(t, getattr(mc, t))
    if tri_tab.data_ptr() % 16 or chunk_tab.data_ptr() % 16:
        raise ValueError("tri_tab and chunk_tab must be 16-byte aligned")
    max_k = MAX_K_WHITTED if name == "mega_whitted" else MAX_K_PT
    if mc.stack_k > max_k:
        raise ValueError(f"stack_k {mc.stack_k} > {max_k}")
    devs = {t.device for t in (o, d, tri_tab, chunk_tab,
                               *(getattr(mc, t) for t in tables))}
    if draws is not None:
        devs.add(draws.device)
    if len(devs) != 1:
        raise ValueError(f"mega_trace: tensors on several devices {devs}")
    out = torch.empty((r, 3), dtype=torch.float32, device=o.device)
    if r == 0:
        return out
    lib = _build.load(LIBRARY[name])
    consts = (ctypes.c_float * 7)(mc.eps, *mc.ambient, *mc.bg)
    flags = ((1 if mc.has_mirror else 0) | (2 if mc.has_dielectric else 0)
             | (4 if mc.has_conductor else 0))
    geo = (_ptr(o), _ptr(d), _ptr(out), r,
           _ptr(tri_tab), mc.n_tri, _ptr(chunk_tab), mc.n_chunks,
           _ptr(mc.spheres), mc.spheres.shape[0],
           _ptr(mc.materials), mc.materials.shape[0],
           _ptr(mc.point_lights), mc.point_lights.shape[0],
           _ptr(mc.dir_lights), mc.dir_lights.shape[0], consts)
    with torch.cuda.device(o.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream)
        if name == "mega_whitted":
            rc = lib.mega_whitted_launch(*geo, mc.max_depth, mc.stack_k,
                                         mc.max_iters, flags, stream)
        else:
            flags |= ((8 if mc.pt else 0) | (16 if mc.pt_importance else 0)
                      | (32 if mc.pt_nee else 0) | (64 if mc.pt_rr else 0)
                      | (128 if mc.has_emissive else 0)
                      | (FLAG_ROUGH if mc.has_rough else 0)
                      | (FLAG_MOTION if mc.has_motion else 0))
            ints = (ctypes.c_int * 6)(mc.max_depth, mc.stack_k, mc.max_iters,
                                      flags, mc.n_draws, mc.rr_floor)
            pt_args = (*geo, _ptr(mc.ml_faces), mc.ml_faces.shape[0],
                       _ptr(mc.ml_lights), mc.ml_lights.shape[0], ints,
                       ctypes.c_void_p(None if draws is None
                                       else draws.data_ptr()),
                       ctypes.c_uint32(seed & 0xFFFFFFFF),
                       ctypes.c_uint32(sample & 0xFFFFFFFF))
            ext = None
            if name == "mega_ext":
                # a motion table that moves nothing goes as null: its tests
                # skip the move
                ext = ctypes.byref(_build.ExtParams(
                    mc.spot_lights.data_ptr(), mc.spot_lights.shape[0],
                    mc.area_lights.data_ptr(), mc.area_lights.shape[0],
                    mc.mat_ext.data_ptr(),
                    mc.tri_motion.data_ptr() if mc.faces_move else None,
                    mc.sph_motion.data_ptr() if mc.spheres_move else None))
            rc = lib.mega_pt_launch(*pt_args, ext, stream)
    if rc != 0:
        err = getattr(lib, LIBRARY[name] + "_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({err})")
    LAUNCHES[name] += 1
    return out
