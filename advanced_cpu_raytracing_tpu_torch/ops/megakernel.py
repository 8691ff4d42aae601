"""The megakernel: host tables, the plain torch version and the wrappers
of its four CUDA variants.

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
same ``csrc/mega_pt.cu`` — and that tree with image and Perlin textures in
every decal mode, normal and bump maps, sphere textures, the background
texture and the spherical environment light (raytracer.cpp:49-62, 87-89,
741-755; mesh.cpp:264-357; sphere.cpp:116-169) — K1d, its ``mega_tex``
instantiation with ``csrc/mega_tex.cuh``, over one texel pool.  Past
``FLAT_MAX_FACES`` work items each of them walks a BVH of 4-wide nodes over
leaves of consecutive rows of the triangle table (``_tree_table``) in place
of the 128-face chunk sweep — K1e, the ``*_tree`` instantiations, in place
of the TPU kernel's HBM-streamed two-level sweep; the forward route
(``render_camera``) takes them past one chunk (``FWD_FLAT_MAX_FACES``), over
leaves of ``LEAF_ROWS`` rows.

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

from advanced_cpu_raytracing_tpu_torch.accel.bvh import build_bvh
from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops import texture as _texture
from advanced_cpu_raytracing_tpu_torch.scene.pack import (
    SLOT_BUMP,
    SLOT_DIFFUSE,
    SLOT_NORMAL,
    SLOT_REPLACE_ALL,
    SLOT_SPECULAR,
    STREAM_MAX_FACES,
)
from advanced_cpu_raytracing_tpu_torch.scene.types import (
    BrdfType,
    DecalMode,
    MaterialType,
)
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device
# a / b rounded once, as the kernels' IEEE division (see math3d.div)
from advanced_cpu_raytracing_tpu_torch.utils.math3d import div as _div
from advanced_cpu_raytracing_tpu_torch.utils.profiling import span

BIG = 3.0e37  # "no hit" distance
CHUNK = 128  # faces per culling chunk (BVH depth-first order)
# past this many work items build_mega adds the tree and the kernels walk it
# (K1e) unless its caller names another threshold: the JAX kernel's
# _VMEM_MAX_FACES, past which it streams geometry
FLAT_MAX_FACES = 98304
# the threshold of the forward route (render_camera, through
# render/renderer.py::_mega_build_cached) and of K2's build
# (ops/megabwd.py::build_bwd_consts): a scene of more than one chunk walks
# the tree, whose culls the flat sweep's table-order chunks lack; a scene
# of one chunk keeps the flat instantiation's brute loop.  K2 refits the
# tree's boxes from each call's vertices (ops/megabwd.py::refit)
FWD_FLAT_MAX_FACES = CHUNK
# consecutive tri_tab rows per tree leaf (at most 31), build_mega's default:
# 4 ran the forward main paths fastest on the card, of 4, 8 and 16
# (tools/tree_design.py)
LEAF_ROWS = 4
TREE_WIDTH = 4  # children per tree node (csrc/mega_common.cuh NODE_W)
# the walk's stack in entries (csrc/mega_common.cuh TREE_STACK), 8 bytes
# each in local memory; _tree_table raises for a tree that needs more (the
# 2,097,152-face terrain needs 39)
TREE_STACK = 64
# rows per step of the plain version's brute force over a scene with a tree
# (the same closest hit as 128 at a time, in fewer, larger steps)
TREE_GROUP = 1024
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
# textures and the environment light (K1d; mirrored in csrc/mega_tex.cuh)
TEXF_COLS = 29  # per face: texture slots diffuse 0, specular 1, bump 2,
#                 replace_all 3, normal 4 (texture index or -1); vertex UVs
#                 5:11; tangent 11:14, bitangent 14:17 (world, or object
#                 space with tbn_obj), object normal 17:20, M^-T 20:29
#                 (tbn_obj only)
TEXS_COLS = 7  # per sphere: slots diffuse 0, specular 1, replace_all 2,
#                bump 3, the bump texture's normaliser 4, -radius * pi 5,
#                3 / normaliser 6 (the last two folded in double, as the
#                JAX kernel folds them)
TEXI_COLS = 7  # per texture (int32): kind 0 (0 image, 1 Perlin), interp 1
#                (0 nearest, 1 bilinear), blend_kd 2, Perlin absval 3,
#                width 4, height 5, first texel in the pool 6
TEXR_COLS = 2  # per texture (f32): bump factor 0, noise scale 1
# per tree node, its TREE_WIDTH children's boxes SoA, one 128-byte line:
# min x, y, z, max x, y, z (each TREE_WIDTH f32), then two int32 bit views
# per child: its code, which the kernels read (a node's row; ~(first
# tri_tab row << 5 | row count) for a leaf; 0: no child, as the root is
# no one's child), and its row count (0: a node; 1..31, at most the
# build's leaf rows: a leaf; -1: no child)
NODE_COLS = 8 * TREE_WIDTH
ENV_DRAWS = 48  # env rejection candidates: 16 x 3 draws per node


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
    # ---- textures and the environment light (K1d) ----
    tex_face: torch.Tensor | None = None  # (max(W,1), TEXF_COLS)
    tex_sph: torch.Tensor | None = None  # (S, TEXS_COLS)
    tex_int: torch.Tensor | None = None  # (T, TEXI_COLS) int32
    tex_flt: torch.Tensor | None = None  # (T, TEXR_COLS)
    texels: torch.Tensor | None = None  # (N, 3) the texel pool, native RGB
    perm: torch.Tensor | None = None  # (512,) int32 Perlin permutation
    n_textures: int = 0
    tbn_obj: bool = False  # the TBN columns are in object space
    bg_tex: int = -1  # the replace_background texture, or -1
    env: tuple = ()  # (width, height, first texel) of the env map, or ()
    tex_images: tuple = ()  # ((image, height, width), ...) in the pool's order
    # ---- the tree over the work items (K1e; build_mega's flat_max) ----
    tree: torch.Tensor | None = None  # (N, NODE_COLS), depth-first
    tree_depth: int = 0  # levels of nodes
    tree_stack: int = 0  # the most stack entries its walk can hold
    tree_leaf_rows: int = 0  # rows per leaf, at most (0: no tree)

    @property
    def kernel(self) -> str:
        """The CUDA variant that renders this scene: the K1d one for
        textures or an environment light; else the K1c one for spot or
        area lights, BRDFs, roughness or motion; else the K1b one for path
        tracing, emissive surfaces and mesh lights; else the Whitted one."""
        if self.n_textures or self.env:
            return "mega_tex"
        if (self.spot_lights.shape[0] or self.area_lights.shape[0]
                or self.has_brdf or self.has_rough or self.has_motion):
            return "mega_ext"
        if self.pt or self.has_emissive or self.ml_lights.shape[0]:
            return "mega_pt"
        return "mega_whitted"

    @property
    def variant(self) -> str:
        """The instantiation that ``mega_trace`` launches (its ``LAUNCHES``
        key): ``kernel`` over the 128-face chunks, or its K1e twin over the
        tree."""
        return self.kernel + ("_tree" if self.tree is not None else "")


def mega_missing(static, opts, pack=None) -> list[str]:
    """Features of a scene/render outside the kernels' envelope (empty
    list = eligible).  Mirrors the JAX ``mega_eligible`` and its
    ``_textures_eligible`` without their TPU caps (the count of spot and
    area lights, of textures, of texels and the size of the env map); the
    only face limit is the pack's, ``STREAM_MAX_FACES`` work items.  A
    textured scene needs its ``pack`` for the per-texture gates."""
    missing = []
    if static.n_env > 1:
        missing.append("more than one environment light")
    if static.n_textures:
        missing += _texture_missing(static, pack)
    if static.n_mesh_lights > MAX_MESH_LIGHTS:
        missing.append(f"more than {MAX_MESH_LIGHTS} mesh lights")
    if static.n_faces and not static.n_work_items:
        missing.append(f"more than {STREAM_MAX_FACES:,} faces")
    if not (static.n_work_items or static.n_spheres):
        missing.append("empty scene")
    if static.n_spheres > MAX_SPHERES:
        missing.append(f"more than {MAX_SPHERES} spheres")
    if static.n_materials > MAX_MATERIALS:
        missing.append(f"more than {MAX_MATERIALS} materials")
    if opts.max_depth > MAX_DEPTH:
        missing.append(f"depth above {MAX_DEPTH}")
    return missing


# decals of the Perlin textures the kernel shades (an image texture may
# have any of the seven)
_PERLIN_DECALS = {int(DecalMode.REPLACE_KD), int(DecalMode.BLEND_KD),
                  int(DecalMode.REPLACE_KS), int(DecalMode.BUMP_NORMAL)}


def _texture_missing(static, pack) -> list[str]:
    """The semantic gates of the JAX ``_textures_eligible``
    (megakernel.py:319-397), each worded by what to remove."""
    if pack is None:
        raise TypeError("mega_missing: a textured scene needs its pack")
    missing = []
    if static.n_brdfs:
        missing.append("textures together with a pluggable BRDF (remove "
                       "the BRDFs or the textures)")
    if static.has_motion:
        missing.append("textures together with motion blur (remove the "
                       "MotionBlur or the textures)")
    kind = _np(pack.tex_kind)[:static.n_textures]
    decal = _np(pack.tex_decal)[:static.n_textures]
    timg = _np(pack.tex_img)[:static.n_textures]
    for i in range(static.n_textures):
        if kind[i] == 1 and int(decal[i]) not in _PERLIN_DECALS:
            missing.append(f"a Perlin texture with decal "
                           f"{DecalMode(int(decal[i])).name.lower()}")
        if kind[i] == 0 and timg[i] < 0:
            missing.append("an image texture without an image")
    # a Perlin bump on a mesh is a world-space gradient projected off the
    # world normal: only right where object and world space agree
    pb = _np(pack.ent_tex)[:, SLOT_BUMP]
    mapped = np.where((pb >= 0) & (kind[np.maximum(pb, 0)] == 1))[0]
    if len(mapped) and not np.allclose(_np(pack.ent_nrm)[mapped],
                                       np.eye(3, dtype=np.float32), atol=1e-6):
        missing.append("a Perlin bump_normal on a rotated or scaled mesh")
    return missing


def mega_eligible(static, opts, pack=None) -> bool:
    """Static feature gate for the kernels (see ``mega_missing``)."""
    return not mega_missing(static, opts, pack)


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


@span("tables.mega")
def build_mega(pack, opts, device=None, flat_max=None):
    """(MegaConsts, tri_tab (max(W,1), 16) f32, chunk_tab (n_chunks, 8) f32)
    on ``device`` (default ``cuda``), as the JAX ``build_mega`` builds them
    for a scene inside the envelope: tri table columns 0:16, one AABB
    (min 0:3, max 3:6) per CHUNK consecutive faces, swept over both ends
    of the motion in motion scenes, and in tables of their own what the
    TPU kernel bakes in as constants or keeps in wider tri-table columns:
    mesh-light faces, spot and area lights, the materials' roughness and
    BRDF, per-face and per-sphere motion.  Past ``flat_max`` work items
    (``FLAT_MAX_FACES`` if None) ``mc.tree`` holds the tree over leaves of
    ``LEAF_ROWS`` rows (``_tree_table``) that
    replaces the JAX kernel's streamed fine and coarse boxes and the chunk
    sweep."""
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
    tx = _texture_tables(pack, tab)
    if flat_max is None:
        flat_max = FLAT_MAX_FACES
    tree, tree_depth, tree_stack = (
        _tree_table(tab, tmo if st.has_motion else None, w, LEAF_ROWS)
        if w > flat_max else (None, 0, 0))

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
        tex_face=tens(tx["face"]), tex_sph=tens(tx["sph"]),
        tex_int=tens(tx["int"]), tex_flt=tens(tx["flt"]),
        texels=tens(tx["texels"]), perm=tens(tx["perm"]),
        n_textures=st.n_textures, tbn_obj=tx["tbn_obj"],
        bg_tex=int(st.bg_tex) if st.n_textures else -1, env=tx["env"],
        tex_images=tx["images"],
        tree=None if tree is None else tens(tree), tree_depth=tree_depth,
        tree_stack=tree_stack,
        tree_leaf_rows=0 if tree is None else LEAF_ROWS,
    )
    return mc, tens(tab), tens(ctab)


def _tree_table(tab, tmo, w, leaf_rows):
    """(nodes (N, NODE_COLS) f32, depth, stack): the K1e tree over the first
    ``w`` rows of ``tab``.  Its leaves are runs of at most ``leaf_rows``
    consecutive rows (the row order does not change), their boxes swept
    over both ends of the motion ``tmo`` as the chunk boxes are.  A binary
    BVH over the leaf boxes by the midpoint builder (``accel/bvh.py``),
    where a builder leaf of several runs becomes a balanced subtree of
    them, is collapsed into nodes of up to TREE_WIDTH children, each node
    taking in turn its largest child's two children in place of it;
    flattened depth-first from the root, row 0.  ``depth`` counts the
    levels of nodes, ``stack`` the most entries the walk can hold: the
    largest sum over a path from the root of each node's children less
    one.  Raises where that exceeds the kernels' stack."""
    if not 0 < leaf_rows < 32:
        raise ValueError(f"leaf_rows {leaf_rows}: a leaf holds 1..31 rows")
    vs = tab[:w, 0:9].reshape(w, 3, 3)
    fmin, fmax = vs.min(axis=1), vs.max(axis=1)
    if tmo is not None:
        moved = vs - tmo[:w, None]
        fmin = np.minimum(fmin, moved.min(axis=1))
        fmax = np.maximum(fmax, moved.max(axis=1))
    starts = np.arange(0, w, leaf_rows)
    lmin = np.minimum.reduceat(fmin, starts, axis=0)
    lmax = np.maximum.reduceat(fmax, starts, axis=0)
    bvh = build_bvh(lmin, lmax, (lmin + lmax) * np.float32(0.5))
    order = bvh.order.tolist()
    b_left, b_right = bvh.node_left.tolist(), bvh.node_right.tolist()
    b_first, b_count = bvh.node_first.tolist(), bvh.node_count.tolist()
    # the binary tree: each node's children (or None) and run (-1), and
    # where its box comes from: a builder node, a run, or boxes of its own
    kids, run, from_node, from_run, own = [], [], [], [], []

    def binary(bn, runs):
        at = len(kids)
        kids.append(None)
        run.append(-1)
        if runs is None and b_count[bn] == 0:
            from_node.append((at, bn))
            kids[at] = (binary(b_left[bn], None), binary(b_right[bn], None))
            return at
        if runs is None:
            runs = order[b_first[bn]:b_first[bn] + b_count[bn]]
        if len(runs) == 1:
            from_run.append((at, runs[0]))
            run[at] = runs[0]
            return at
        own.append((at, lmin[runs].min(axis=0), lmax[runs].max(axis=0)))
        half = len(runs) // 2
        kids[at] = (binary(None, runs[:half]), binary(None, runs[half:]))
        return at

    root = binary(0, None)
    bmin = np.empty((len(kids), 3), np.float32)
    bmax = np.empty((len(kids), 3), np.float32)
    for src, tab_min, tab_max in ((from_node, bvh.node_min, bvh.node_max),
                                  (from_run, lmin, lmax)):
        if src:
            at, i = np.asarray(src).T
            bmin[at], bmax[at] = tab_min[i], tab_max[i]
    for at, lo, hi in own:
        bmin[at], bmax[at] = lo, hi
    ext = bmax.astype(np.float64) - bmin
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0]).tolist()
    # per node, its children: (slot, binary node, reference, row count)
    slots = []

    def wide(b):
        """Emit the node whose children collapse binary node ``b``: (its
        row, its depth, its stack need)."""
        ch = list(kids[b]) if kids[b] is not None else [b]
        while len(ch) < TREE_WIDTH:
            inner = [i for i, c in enumerate(ch) if kids[c] is not None]
            if not inner:
                break
            i = max(inner, key=lambda i: area[ch[i]])
            ch[i:i + 1] = kids[ch[i]]
        at = len(slots)
        slots.append(None)
        ents, depth, need = [], 1, 0
        for c in ch:
            if kids[c] is None:
                first = run[c] * leaf_rows
                n = min(leaf_rows, w - first)
                ents.append((c, ~(first << 5 | n), n))
            else:
                row, dep, nd = wide(c)
                ents.append((c, row, 0))
                depth, need = max(depth, dep + 1), max(need, nd)
        slots[at] = ents
        return at, depth, need + len(ch) - 1

    _, depth, stack = wide(root)
    if stack > TREE_STACK:
        raise ValueError(f"the tree over {w:,} faces needs {stack} stack "
                         f"entries ({depth} levels); the kernels' stack "
                         f"holds {TREE_STACK}")
    wd = TREE_WIDTH
    nodes = np.zeros((len(slots), NODE_COLS), np.float32)
    ints = nodes.view(np.int32)
    ints[:, 7 * wd:8 * wd] = -1
    at, k, c, code, cnt = np.asarray(
        [(i, k, *e) for i, ents in enumerate(slots)
         for k, e in enumerate(ents)], np.int64).T
    for comp in range(3):
        nodes[at, comp * wd + k] = bmin[c, comp]
        nodes[at, (3 + comp) * wd + k] = bmax[c, comp]
    ints[at, 6 * wd + k] = code
    ints[at, 7 * wd + k] = cnt
    return nodes, depth, stack


def _unit_rows(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _tile_np(u):
    frac = u - np.floor(u)
    frac = np.where(frac < 0.0001, 1.0, frac)
    return np.where(u > 1.0001, frac, u)


def _texture_tables(pack, tab) -> dict:
    """The K1d tables of a scene, as the JAX ``build_mega`` computes them
    (megakernel.py:418-529, 681-814, 888-897) but in tables of their own:
    per face the texture slots, vertex UVs and tangent frame (JAX tri
    columns 19:48), per sphere its slots, per texture its parameters, and
    every image texture's and the env map's texels in one plain f32 RGB
    pool at native size (no packed texels, no tiles, no small/big split)."""
    st = pack.static
    w = st.n_work_items
    n_tex = st.n_textures
    face = np.zeros((max(w, 1), TEXF_COLS), np.float32)
    face[:, 0:5] = -1.0
    sph = np.zeros((st.n_spheres, TEXS_COLS), np.float32)
    sph[:, 0:4] = -1.0
    tint = np.zeros((max(n_tex, 1), TEXI_COLS), np.int32)
    tflt = np.zeros((max(n_tex, 1), TEXR_COLS), np.float32)
    pool: list = []
    first: dict = {}  # image index -> first texel, in the pool's order
    atlas, img_w, img_h = (_np(pack.img_atlas), _np(pack.img_w),
                           _np(pack.img_h))

    def pooled(img: int) -> int:
        if img not in first:
            first[img] = sum(len(p) for p in pool)
            pool.append(atlas[img, :img_h[img], :img_w[img]].reshape(-1, 3))
        return first[img]

    tbn_obj = False
    if n_tex:
        kind = _np(pack.tex_kind)[:n_tex]
        et = _np(pack.ent_tex)
        has_img = bool((kind == 0).any())
        tbn_ents = (et[:, SLOT_NORMAL] >= 0) | (
            (et[:, SLOT_BUMP] >= 0) & (kind[np.maximum(et[:, SLOT_BUMP], 0)] == 0))
        has_tbn = has_img and bool(tbn_ents.any())
        tbn_obj = has_tbn and not np.allclose(
            _np(pack.ent_nrm)[np.where(tbn_ents)[0]],
            np.eye(3, dtype=np.float32), atol=1e-6)
        decal, interp = _np(pack.tex_decal), _np(pack.tex_interp)
        for i in range(n_tex):
            img = int(_np(pack.tex_img)[i])
            tint[i, 0:4] = (kind[i], interp[i],
                            int(decal[i]) == int(DecalMode.BLEND_KD),
                            _np(pack.tex_noise_conv)[i])
            if kind[i] == 0 and img >= 0:
                tint[i, 4:7] = (img_w[img], img_h[img], pooled(img))
            tflt[i] = (_np(pack.tex_bump_factor)[i],
                       _np(pack.tex_noise_scale)[i])
        if w:
            wi_ent = _np(pack.wi_ent)[:w]
            wi_face = _np(pack.wi_face)[:w]
            face[:w, 0:5] = et[wi_ent][:, [SLOT_DIFFUSE, SLOT_SPECULAR,
                                           SLOT_BUMP, SLOT_REPLACE_ALL,
                                           SLOT_NORMAL]]
            # vertex UVs (uvidx -1: uv 0), for barycentric interpolation
            uvi = _np(pack.tri_uvidx)[wi_face]
            uvv = _np(pack.uvs)[np.maximum(uvi, 0)]
            uvv[uvi[:, 0] < 0] = 0.0
            face[:w, 5:11] = uvv.reshape(w, 6)
        if has_tbn and w:
            # tangent and bitangent from the UV edges
            # (Mesh::GetTangentAndBitangentForTriangle, mesh.cpp:390-422):
            # from the world corners, or the object ones with tbn_obj
            if tbn_obj:
                vo = _np(pack.verts)[_np(pack.tri_vidx)[wi_face]]
                e1, e2 = _unit_rows(vo[:, 1] - vo[:, 0]), _unit_rows(vo[:, 2] - vo[:, 1])
            else:
                e1 = _unit_rows(tab[:w, 3:6] - tab[:w, 0:3])
                e2 = _unit_rows(tab[:w, 6:9] - tab[:w, 3:6])
            uvt = _tile_np(face[:w, 5:11].reshape(w, 3, 2))
            u1 = uvt[:, 1, 0] - uvt[:, 0, 0]
            w1 = uvt[:, 1, 1] - uvt[:, 0, 1]
            u2 = uvt[:, 2, 0] - uvt[:, 1, 0]
            w2 = uvt[:, 2, 1] - uvt[:, 1, 1]
            det = u1 * w2 - w1 * u2
            det = 1.0 / np.where(det == 0, 1e-20, det)
            face[:w, 11:14] = _unit_rows((w2[:, None] * e1 - w1[:, None] * e2)
                                         * det[:, None])
            face[:w, 14:17] = _unit_rows((-u2[:, None] * e1 + u1[:, None] * e2)
                                         * det[:, None])
            if tbn_obj:
                face[:w, 17:20] = _np(pack.tri_normal)[wi_face]
                face[:w, 20:29] = _np(pack.ent_nrm)[wi_ent].reshape(w, 9)
        stx = _np(pack.sph_tex)
        norm = _np(pack.tex_normalizer)
        radius = _np(pack.sph_radius)
        for i in range(st.n_spheres):
            bump = int(stx[i, SLOT_BUMP])
            sph[i] = (stx[i, SLOT_DIFFUSE], stx[i, SLOT_SPECULAR],
                      stx[i, SLOT_REPLACE_ALL], bump, norm[max(bump, 0)],
                      -float(radius[i]) * math.pi,
                      3.0 / float(norm[max(bump, 0)]))
    env = ()
    if st.n_env:
        img = int(_np(pack.env_img)[0])
        env = (int(img_w[img]), int(img_h[img]), pooled(img))
    texels = (np.concatenate(pool).astype(np.float32) if pool
              else np.zeros((1, 3), np.float32))
    if len(texels) >= 2 ** 31:
        raise ValueError("texel pool past 2^31 texels")
    return {"face": face, "sph": sph, "int": tint, "flt": tflt,
            "texels": np.ascontiguousarray(texels), "env": env,
            "images": tuple((img, int(img_h[img]), int(img_w[img]))
                            for img in first),
            "perm": _texture.PERM512.astype(np.int32), "tbn_obj": bool(tbn_obj)}


# ---------------------------------------------------------------------------
# plain torch version (vectorised over rays)
# ---------------------------------------------------------------------------


def _norm3(x, y, z):
    # the kernels' norm3: IEEE sqrt, then IEEE division (torch.rsqrt rounds
    # otherwise, on the card in a few ulp)
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
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


def _gi_direction(nx, ny, nz, r1, r2, importance: bool):
    """The GI direction of the uniforms (r1, r2) about the unit normal n
    (ComputeGlobalIllumination, raytracer.cpp:143-173): phi = 2 pi r1, and
    theta = asin(sqrt(r2)) with importance sampling, else acos(r2), as
    ``gi_direction`` of csrc/mega_common.cuh computes it."""
    phi = TWO_PI * r1
    if importance:
        sin_t = torch.sqrt(r2)  # theta = asin(sqrt(r2))
        cos_t = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    else:
        cos_t = r2  # theta = acos(r2)
        sin_t = torch.sqrt(torch.clamp(1.0 - r2 * r2, min=0.0))
    (ux, uy, uz), (vx, vy, vz) = _onb(nx, ny, nz)
    sc = sin_t * torch.cos(phi)
    ss = sin_t * torch.sin(phi)
    return _norm3(ux * sc + nx * cos_t + vx * ss, uy * sc + ny * cos_t + vy * ss,
                  uz * sc + nz * cos_t + vz * ss)


def _tri_hit(v0, v1, v2, px, py, pz, vx, vy, vz, bary=False):
    """Cramer's-rule test (Mesh::IntersectFace, src/mesh.cpp:201-236) of
    rays (R,1) against faces (1,F): returns (t, valid), each (R,F), and
    with ``bary`` the barycentrics (beta, gamma) too."""
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
    if bary:
        return t, valid, beta, gamma
    return t, valid


def _sphere_hit(s, px, py, pz, vx, vy, vz, mo=None, tau=None):
    """Quadratic sphere test in object space (Sphere::Intersect,
    src/sphere.cpp:31-72).  ``s`` is one row of the sphere table as Python
    floats; with motion ``mo`` (object space, Python floats) the local
    origin moves by ``mo * tau``.  Returns (t, valid, unnormalised world
    normal xyz, local hit point minus the center xyz)."""
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
    return t, valid, nwx, nwy, nwz, prx, pry, prz


def _slab_axis(lo, hi, p, iv):
    """``slab_axis`` of csrc/mega_common.cuh: the distances at which rays
    enter and leave [lo, hi] along one axis.  A ray parallel to the axis
    that lies on one of the planes makes 0 * inf = NaN there; that plane
    then does not limit the ray."""
    t1 = (lo - p) * iv
    t2 = (hi - p) * iv
    inf = torch.copysign(torch.full_like(iv, float("inf")), iv)
    t1 = torch.where(torch.isnan(t1), -inf, t1)
    t2 = torch.where(torch.isnan(t2), inf, t2)
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _slab_enter(box, px, py, pz, ivx, ivy, ivz, t_b):
    """Chunk AABB slab test (shape.hpp:78-100) — the kernel's cull, which
    keeps a box whose face plane the ray runs in (JAX's ``chunk_sweep``
    drops it).  The plain version does not skip on it; it only counts the
    kernel's work."""
    tmin, tmax = _slab_axis(box[0], box[3], px, ivx)
    t_in, t_out = _slab_axis(box[1], box[4], py, ivy)
    tmin, tmax = torch.maximum(tmin, t_in), torch.minimum(tmax, t_out)
    t_in, t_out = _slab_axis(box[2], box[5], pz, ivz)
    tmin, tmax = torch.maximum(tmin, t_in), torch.minimum(tmax, t_out)
    return (tmax > 0) & (tmax >= tmin) & (tmin < t_b)


class TreeWalker:
    """The kernels' tree walk (``ChunkTree``, csrc/mega_common.cuh) over the
    same tables, on their device, the rays of a query in lockstep: a node's
    children in reach visited nearest first (a stable sort on their entry
    distances; the others pushed, the farthest deepest), a child kept while
    its entry is <= t_best (< the limit in a shadow query), a face taken at
    t < t_best or at t == t_best from a lower row.  It counts each ray's
    child box and face tests, and marks in ``reads`` what the kernels read,
    across its calls: the nodes (``nodes``, a 128-byte line each), the rows
    whose vertices they test (``rows``) and the closest hits' rows
    (``won``).  Tests hold its hits to the brute force, and the plain
    version's ``stats`` count a tree scene's kernel work with it.  The
    render path never calls it."""

    def __init__(self, mc: MegaConsts, tri_tab, reads: dict | None = None):
        dev = tri_tab.device
        nodes = mc.tree.to(dev)
        wd = nodes.shape[1] // 8
        # (N, W, 6) child boxes: min xyz, max xyz
        self.box = nodes[:, :6 * wd].reshape(-1, 6, wd).transpose(1, 2).contiguous()
        ints = nodes.view(torch.int32)
        code = ints[:, 6 * wd:7 * wd].long()
        self.cnt = ints[:, 7 * wd:8 * wd].long()
        # a node's row, or a leaf's first row
        self.ref = torch.where(code < 0, (~code) >> 5, code)
        self.width = max(int(self.cnt.max()), 1)  # rows per leaf, at most
        self.stack_size = mc.tree_stack
        self.tri = tri_tab
        self.motion = mc.tri_motion.to(dev) if mc.faces_move else None
        self.moving = (None if self.motion is None
                       else (self.motion != 0).any(dim=1))
        self.reads = {} if reads is None else reads
        for key, n in (("nodes", nodes.shape[0]), ("rows", tri_tab.shape[0]),
                       ("won", tri_tab.shape[0])):
            self.reads.setdefault(key, torch.zeros(n, dtype=torch.bool,
                                                   device=dev))

    def _entry(self, node, p, iv):
        """``slab_entry`` of the children's boxes of ``node`` (R,) for rays
        (R,3): (R, W) entry distances, +inf on a miss; a NaN (a ray in a
        face plane of the box) does not limit the ray."""
        box = self.box[node]
        t_in, t_out = _slab_axis(box[..., 0:3], box[..., 3:6], p[:, None],
                                 iv[:, None])
        tmin, tmax = t_in.amax(dim=2), t_out.amin(dim=2)
        return torch.where((tmax > 0) & (tmax >= tmin), tmin,
                           torch.full_like(tmin, float("inf")))

    def walk(self, o, d, limit=None, tau=None, skip_emissive=False) -> dict:
        """Rays ``o``, ``d`` (R,3) f32, at motion times ``tau`` (R,): the
        closest hits (``t``, ``row``; BIG and -1 on a miss), or with
        ``limit`` (R,) shadow queries (``blocked``), each with the rays'
        counts ``slab_tests``, ``tri_tests`` and ``tri_motion_tests``
        (R,), and ``stack_peak`` (R,), the most entries each ray's stack
        held."""
        dev, f32 = self.tri.device, torch.float32
        p = torch.as_tensor(o, dtype=f32, device=dev).reshape(-1, 3)
        v = torch.as_tensor(d, dtype=f32, device=dev).reshape(-1, 3)
        r = p.shape[0]
        iv = 1.0 / v
        shadow = limit is not None
        tb = (torch.as_tensor(limit, dtype=f32, device=dev).reshape(-1).clone()
              if shadow else torch.full((r,), BIG, dtype=f32, device=dev))
        if tau is not None:
            tau = torch.as_tensor(tau, dtype=f32, device=dev).reshape(-1)
        best = torch.full((r,), -1, dtype=torch.long, device=dev)
        blocked = torch.zeros(r, dtype=torch.bool, device=dev)
        n = {k: torch.zeros(r, dtype=torch.long, device=dev)
             for k in ("slab_tests", "tri_tests", "tri_motion_tests")}
        size = max(self.stack_size, 1)
        stack_ref = torch.zeros((r, size), dtype=torch.long, device=dev)
        stack_cnt = torch.zeros((r, size), dtype=torch.long, device=dev)
        stack_t = torch.zeros((r, size), dtype=f32, device=dev)
        sp = torch.zeros(r, dtype=torch.long, device=dev)
        peak = torch.zeros(r, dtype=torch.long, device=dev)
        cols = torch.arange(self.width, device=dev)

        def reach(t_in, lim):
            return t_in < lim if shadow else t_in <= lim

        # in hand: node ref (cnt 0) or the leaf of rows ref .. ref + cnt - 1;
        # cnt -1 pops the ray's stack, -2 is done
        ref = torch.zeros(r, dtype=torch.long, device=dev)
        cnt = torch.zeros(r, dtype=torch.long, device=dev)
        while bool((cnt != -2).any()):
            pop = torch.nonzero(cnt == -1).squeeze(1)
            if len(pop):
                empty = sp[pop] == 0
                cnt[pop[empty]] = -2
                pop = pop[~empty]
                sp[pop] -= 1
                back = pop[reach(stack_t[pop, sp[pop]], tb[pop])]
                ref[back] = stack_ref[back, sp[back]]
                cnt[back] = stack_cnt[back, sp[back]]
            lv = torch.nonzero(cnt > 0).squeeze(1)
            if len(lv):  # leaves: rows a .. a + c - 1
                a_l, cnt_l = ref[lv], cnt[lv]
                inside = cols < cnt_l[:, None]
                rows = torch.where(inside, a_l[:, None] + cols, a_l[:, None])
                tri = self.tri[rows]
                pos = [p[lv, k:k + 1] for k in range(3)]
                if self.motion is not None:
                    pos = [c + self.motion[rows, k] * tau[lv][:, None]
                           for k, c in enumerate(pos)]
                t, valid = _tri_hit([tri[..., k] for k in range(3)],
                                    [tri[..., k] for k in range(3, 6)],
                                    [tri[..., k] for k in range(6, 9)], *pos,
                                    *(v[lv, k:k + 1] for k in range(3)))
                t = torch.where(valid & inside, t, torch.full_like(t, np.inf))
                if shadow:
                    hits = t < tb[lv][:, None]
                    if skip_emissive:
                        hits &= tri[..., 14] < 0.5
                    stop = hits.any(dim=1)
                    # the kernel stops at the first blocker
                    k = torch.where(stop, hits.to(torch.int8).argmax(dim=1) + 1,
                                    cnt_l)
                    blocked[lv] = stop
                    cnt[lv] = torch.where(stop, -2, -1)
                else:
                    k = cnt_l
                    t_c, i_c = t.min(dim=1)  # the lowest row on a tie
                    row = a_l + i_c
                    better = (t_c < tb[lv]) | ((t_c == tb[lv]) & (row < best[lv]))
                    tb[lv] = torch.where(better, t_c, tb[lv])
                    best[lv] = torch.where(better, row, best[lv])
                    cnt[lv] = -1
                tested = cols < k[:, None]
                n["tri_tests"][lv] += k
                self.reads["rows"][rows[tested]] = True
                if self.moving is not None:
                    n["tri_motion_tests"][lv] += (self.moving[rows]
                                                  & tested).sum(dim=1)
            inner = torch.nonzero(cnt == 0).squeeze(1)
            if len(inner):  # nodes: the children in reach, nearest first
                at = ref[inner]
                self.reads["nodes"][at] = True
                c_ref, c_cnt = self.ref[at], self.cnt[at]
                real = c_cnt >= 0
                n["slab_tests"][inner] += real.sum(dim=1)
                t = self._entry(at, p[inner], iv[inner])
                t = torch.where(real & reach(t, tb[inner][:, None]), t,
                                torch.full_like(t, float("inf")))
                t, order = torch.sort(t, dim=1, stable=True)
                c_ref = torch.gather(c_ref, 1, order)
                c_cnt = torch.gather(c_cnt, 1, order)
                kept = t < float("inf")
                # push all but the nearest, the farthest first
                for k in range(t.shape[1] - 1, 0, -1):
                    push = inner[kept[:, k]]
                    if len(push):
                        sel = kept[:, k]
                        stack_ref[push, sp[push]] = c_ref[sel, k]
                        stack_cnt[push, sp[push]] = c_cnt[sel, k]
                        stack_t[push, sp[push]] = t[sel, k]
                        sp[push] += 1
                peak[inner] = torch.maximum(peak[inner], sp[inner])
                ref[inner] = torch.where(kept[:, 0], c_ref[:, 0], ref[inner])
                cnt[inner] = torch.where(kept[:, 0], c_cnt[:, 0], -1)
        if shadow:
            return {"blocked": blocked, "stack_peak": peak, **n}
        self.reads["won"][best[best >= 0]] = True
        return {"t": tb, "row": best, "stack_peak": peak, **n}


class _Geometry:
    """The scene tables split into per-chunk face columns for the brute
    force sweeps of the plain version: 128 rows at a time, each with its
    chunk's box, or TREE_GROUP rows at a time in a scene with a tree, whose
    kernel work ``stats`` counts with ``TreeWalker`` (the brute force never
    reads the tree)."""

    def __init__(self, mc: MegaConsts, tri_tab, chunk_tab, stats):
        self.mc = mc
        self.stats = stats
        self.chunks = []
        self.group = group = CHUNK if mc.tree is None else TREE_GROUP
        self.walker = (TreeWalker(mc, tri_tab, stats.setdefault("reads", {}))
                       if mc.tree is not None and stats is not None else None)
        for ci in range(-(-mc.n_tri // group)):
            lo, hi = ci * group, min((ci + 1) * group, mc.n_tri)
            cols = [tri_tab[lo:hi, k][None, :] for k in range(15)]
            # tests of moving faces among the chunk's first n: moving[n]
            moving = torch.zeros(hi - lo + 1, dtype=torch.int64)
            if mc.has_motion:  # columns 15:18: the faces' motion
                cols += [mc.tri_motion[lo:hi, k][None, :] for k in range(3)]
                moving[1:] = torch.cumsum(
                    (mc.tri_motion[lo:hi] != 0).any(dim=1).cpu(), 0)
            self.chunks.append((cols, chunk_tab[ci].tolist()
                                if mc.tree is None else None,
                                moving.to(tri_tab.device)))
        self.spheres = mc.spheres.tolist()
        self.sph_motion = (mc.sph_motion.tolist() if mc.has_motion
                           else [None] * len(self.spheres))

    def _count(self, key, n):
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + int(n)

    def _walk(self, rays, tau, limit=None):
        """Count the node and face tests of the kernel's tree walk for the
        rays (R,1) of one query (``limit``: a shadow query)."""
        w = self.walker.walk(torch.cat(rays[:3], 1), torch.cat(rays[3:], 1),
                             None if limit is None else limit, tau,
                             self.mc.has_emissive)
        for key in ("slab_tests", "tri_tests", "tri_motion_tests"):
            self._count(key, w[key].sum())

    def _tri_rays(self, cols, rays, tau):
        """The rays as (R,1) columns against the faces of ``cols``; with
        motion the origin moves by +motion * tau first (mesh.cpp:167-170),
        (R,F) each."""
        if tau is None:
            return rays
        px, py, pz = (p + m * tau[:, None] for p, m in zip(rays[:3], cols[15:18]))
        return [px, py, pz, *rays[3:]]

    def trace(self, px, py, pz, vx, vy, vz, tau=None, want_win=False):
        """Closest hit for rays (R,): (t, nx, ny, nz (unit), matf, mesh
        light id (-1 for none), hit), and with ``want_win`` the winner:
        the face index, -2 - s for sphere s, -1 for none.  Faces in table
        order, strict ``t < t_best``: the first index wins a tie, as in
        the kernel's sequential sweep; a sphere hit resets the mesh-light
        id.  ``tau`` (R,) is each ray's motion time in a motion scene."""
        r = px.shape[0]
        t_b = torch.full((r,), BIG, dtype=px.dtype, device=px.device)
        nx = torch.zeros_like(px)
        ny = torch.zeros_like(px)
        nz = torch.ones_like(px)
        mf = torch.zeros_like(px)
        ml = torch.full_like(px, -1.0)
        win = torch.full((r,), -1, dtype=torch.int64, device=px.device)
        rays = [c[:, None] for c in (px, py, pz, vx, vy, vz)]
        culled = self.mc.n_chunks > 1 and self.mc.tree is None
        if culled:
            ivx, ivy, ivz = 1.0 / vx, 1.0 / vy, 1.0 / vz
        if self.walker is not None:
            self._walk(rays, tau)
        for ci, (cols, box, moving) in enumerate(self.chunks):
            if self.mc.tree is None:
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
            if want_win:
                win = torch.where(better, ci * self.group + i_c, win)
        for si, (s, mo) in enumerate(zip(self.spheres, self.sph_motion)):
            self._count("sphere_tests", r)
            if mo is not None and any(mo):
                self._count("sphere_motion_tests", r)
            t, valid, nwx, nwy, nwz = _sphere_hit(s, px, py, pz, vx, vy, vz,
                                                  mo, tau)[:5]
            better = valid & (t < t_b)
            t_b = torch.where(better, t, t_b)
            nx = torch.where(better, nwx, nx)
            ny = torch.where(better, nwy, ny)
            nz = torch.where(better, nwz, nz)
            mf = torch.where(better, torch.full_like(mf, s[25]), mf)
            ml = torch.where(better, -1.0, ml)
            if want_win:
                win = torch.where(better, -2 - si, win)
        hit = t_b < BIG * 0.5
        nx, ny, nz = _norm3(nx, ny, nz)
        if want_win:
            return t_b, nx, ny, nz, mf, ml, hit, win
        return t_b, nx, ny, nz, mf, ml, hit

    def shadow(self, px, py, pz, vx, vy, vz, limit, tau=None):
        """Any hit closer than ``limit`` along unit v (IsInShadow,
        src/raytracer.cpp:567-583) for rays (R,), at motion time ``tau``.
        Emissive faces cast no shadow (CastShadowRay,
        raytracer.cpp:590-593)."""
        r = px.shape[0]
        blocked = torch.zeros(r, dtype=torch.bool, device=px.device)
        rays = [c[:, None] for c in (px, py, pz, vx, vy, vz)]
        tree = self.mc.tree is not None
        culled = self.mc.n_chunks > 1 and not tree
        if culled:
            ivx, ivy, ivz = 1.0 / vx, 1.0 / vy, 1.0 / vz
        if self.walker is not None:
            self._walk(rays, tau, limit)
        for cols, box, moving in self.chunks:
            t, valid = _tri_hit(cols[0:3], cols[3:6], cols[6:9],
                                *self._tri_rays(cols, rays, tau))
            if self.mc.has_emissive:
                valid = valid & (cols[14] < 0.5)
            hits = valid & (t < limit[:, None])
            if not tree:
                if culled:
                    live = torch.where(blocked, torch.zeros_like(limit), limit)
                    enter = _slab_enter(box, px, py, pz, ivx, ivy, ivz, live)
                    self._count("slab_tests", (~blocked).sum())
                else:
                    enter = ~blocked
                # the kernel stops at the first blocking face
                first = torch.where(hits.any(dim=1),
                                    hits.to(torch.int8).argmax(dim=1) + 1,
                                    cols[0].shape[1])
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


# f32 constants of the JAX kernel (Python doubles rounded once)
_PI = math.pi
_INV255 = 1.0 / 255.0
_BUMP_EPS = 1e-3


class _Tex:
    """The texture and env lookups of the plain version (the JAX kernel's
    perlin_unit, img_sample, img_grey_at and env_radiance,
    megakernel.py:1019-1142, 1323-1360), each counting its Perlin
    evaluations and texel taps into ``count``."""

    def __init__(self, mc: MegaConsts, count):
        self.mc = mc
        self.count = count
        self.tint = mc.tex_int.tolist()
        self.tflt = mc.tex_flt.tolist()
        self.perm = mc.perm.to(torch.int64)

    def kind(self, ti: int) -> int:
        return self.tint[ti][0]

    def ids(self, kind: int) -> list:
        return [i for i in range(self.mc.n_textures) if self.tint[i][0] == kind]

    def perlin(self, ti, px, py, pz):
        """Converted Perlin sample in [0, 1] at world positions (R,)."""
        self.count("perlin_evals", px.numel())
        return _texture.perlin_sample(
            torch.stack((px, py, pz), -1), torch.full_like(px, self.tflt[ti][1]),
            torch.full_like(px, self.tint[ti][3], dtype=torch.int32), self.perm)

    def _fetch(self, first, w):
        pool = self.mc.texels
        return lambda i, j: pool[first + j * w + i]

    def sample(self, ti, u, v, raw=False):
        """(R,3) RGB of image texture ``ti`` at tiled (u, v), scaled by
        1/255 unless ``raw``."""
        _, interp, _, _, w, h, first = self.tint[ti]
        fetch = self._fetch(first, w)
        if interp == 0:
            rgb = fetch(*_texture.nearest_ij(u, v, w, h))
        else:
            rgb = _texture.bilinear(fetch, u, v, w, h)
        self.count("texel_taps", u.numel() * (1 if interp == 0 else 4))
        return rgb if raw else rgb * _INV255

    def grey(self, ti, i, j):
        """Mean-channel grey at integer texels (the bump taps)."""
        _, _, _, _, w, _, first = self.tint[ti]
        rgb = self._fetch(first, w)(i, j)
        self.count("texel_taps", i.numel())
        return (rgb[:, 0] + rgb[:, 1] + rgb[:, 2]) * (1.0 / 3.0)

    def env(self, vx, vy, vz):
        """Lat-long radiance * 2pi along (unnormalised) directions
        (GetSample, sphericalEnvironmentLight.h:22-35)."""
        w, h, first = self.mc.env
        u = (1.0 + _div(torch.atan2(vx, -vz), _PI)) / 2.0
        v = _div(torch.acos(torch.clamp(vy, -1.0, 1.0)), _PI)
        self.count("texel_taps", vx.numel())
        return self._fetch(first, w)(*_texture.nearest_ij(u, v, w, h)) * (
            2.0 * _PI)

    def surface(self, geo, tri_tab, win, hit, p, v, nrm):
        """The winner's texture slots (R,5: diffuse, specular, bump,
        replace_all, normal), untiled UV and tangent frame (R,18), and the
        normal with a sphere's bump applied (megakernel.py:1548-1719)."""
        mc = self.mc
        r = win.shape[0]
        nx, ny, nz = nrm
        is_face = hit & (win >= 0)
        fi = win.clamp(min=0)
        row = mc.tex_face[fi]
        slots = torch.where(is_face[:, None], row[:, 0:5], -1.0)
        tbn = torch.where(is_face[:, None], row[:, 11:29], 0.0)
        uu = torch.zeros(r, dtype=torch.float32, device=win.device)
        vv = torch.zeros_like(uu)
        sel = is_face.nonzero().squeeze(1)
        if sel.numel():
            f = tri_tab[fi[sel]]
            _, _, beta, gamma = _tri_hit(
                (f[:, 0], f[:, 1], f[:, 2]), (f[:, 3], f[:, 4], f[:, 5]),
                (f[:, 6], f[:, 7], f[:, 8]), *(c[sel] for c in (*p, *v)),
                bary=True)
            q = row[sel]
            uu[sel] = q[:, 5] + beta * (q[:, 7] - q[:, 5]) + gamma * (q[:, 9] - q[:, 5])
            vv[sel] = q[:, 6] + beta * (q[:, 8] - q[:, 6]) + gamma * (q[:, 10] - q[:, 6])
        for si, st in enumerate(mc.tex_sph.tolist()):
            sel = (hit & (win == -2 - si)).nonzero().squeeze(1)
            if not sel.numel():
                continue
            slots[sel] = torch.tensor([st[0], st[1], -1.0, st[2], -1.0],
                                      device=win.device)
            if not any(x >= 0 for x in st[0:4]):
                continue
            s = geo.spheres[si]
            prx, pry, prz = _sphere_hit(s, *(c[sel] for c in (*p, *v)))[5:8]
            # spherical UV of the local hit (sphere.cpp:138-167)
            phi = torch.atan2(prz, prx)
            th = torch.acos(torch.clamp(_div(pry, s[24]), -0.999999, 0.999999))
            uu[sel] = _div(-phi + _PI, 2.0 * _PI)
            vv[sel] = _div(th, _PI)
            bti = int(st[3])
            if bti < 0:
                continue
            # bump at intersect time in object space (sphere.cpp:116-169):
            # analytic tangents, n = unit(bitangent x tangent), M^-T to world
            tx_, ty_, tz_ = _norm3((2.0 * _PI) * prz, torch.zeros_like(prz),
                                   -(2.0 * _PI) * prx)
            bx_, by_, bz_ = _norm3(_PI * pry * torch.cos(phi),
                                   st[5] * torch.sin(th),
                                   _PI * pry * torch.sin(phi))
            nbx, nby, nbz = _norm3(by_ * tz_ - bz_ * ty_, bz_ * tx_ - bx_ * tz_,
                                   bx_ * ty_ - by_ * tx_)
            if self.kind(bti) == 1:
                # Perlin: local-frame gradient, no bump factor
                h0 = self.perlin(bti, prx, pry, prz)
                gx = _div(self.perlin(bti, prx + _BUMP_EPS, pry, prz) - h0, _BUMP_EPS)
                gy = _div(self.perlin(bti, prx, pry + _BUMP_EPS, prz) - h0, _BUMP_EPS)
                gz = _div(self.perlin(bti, prx, pry, prz + _BUMP_EPS) - h0, _BUMP_EPS)
                gpar = gx * nbx + gy * nby + gz * nbz
                obx, oby, obz = _norm3(nbx - (gx - gpar * nbx),
                                       nby - (gy - gpar * nby),
                                       nbz - (gz - gpar * nbz))
            else:
                # image: taps scale by w (not w - 1), the grey divides by
                # the texture's normaliser (not 3)
                w, h, bf = self.tint[bti][4], self.tint[bti][5], self.tflt[bti][0]
                rescale = st[6]
                i0 = torch.clamp((uu[sel] * float(w)).to(torch.int64), 0, w - 1)
                j0 = torch.clamp((vv[sel] * float(h)).to(torch.int64), 0, h - 1)
                i1 = torch.clamp(i0 + 1, max=w - 1)
                j1 = torch.clamp(j0 + 1, max=h - 1)
                h_uv = self.grey(bti, i0, j0) * rescale
                h_du = self.grey(bti, i1, j0) * rescale
                h_dv = self.grey(bti, i0, j1) * rescale
                qux = tx_ + nbx * ((h_du - h_uv) * bf)
                quy = ty_ + nby * ((h_du - h_uv) * bf)
                quz = tz_ + nbz * ((h_du - h_uv) * bf)
                qvx = bx_ + nbx * ((h_dv - h_uv) * bf)
                qvy = by_ + nby * ((h_dv - h_uv) * bf)
                qvz = bz_ + nbz * ((h_dv - h_uv) * bf)
                obx, oby, obz = _norm3(qvy * quz - qvz * quy, qvz * qux - qvx * quz,
                                       qvx * quy - qvy * qux)
                flip = (obx * nbx <= 0) & (oby * nby <= 0) & (obz * nbz <= 0)
                obx = torch.where(flip, -obx, obx)
                oby = torch.where(flip, -oby, oby)
                obz = torch.where(flip, -obz, obz)
            m = s[12:21]
            bnx, bny, bnz = _norm3(m[0] * obx + m[1] * oby + m[2] * obz,
                                   m[3] * obx + m[4] * oby + m[5] * obz,
                                   m[6] * obx + m[7] * oby + m[8] * obz)
            nx, ny, nz = nx.clone(), ny.clone(), nz.clone()
            nx[sel], ny[sel], nz[sel] = bnx, bny, bnz
        return slots, (uu, vv), tbn, (nx, ny, nz)


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
    kd_c = torch.where(mx[:, 4] > 0.5, _div(1.0 - f_t, math.pi), 1.0 / math.pi)
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
                   stats=None, pix_uv=None):
    """Plain torch version of the kernels: radiance (R,3) for rays o/d (R,3).

    The shading tree runs as a loop over iterations, one node per active
    ray each, with the kernel's stack discipline: the reflection leg
    continues in place, a dielectric's refraction leg is pushed, in path
    tracing the GI child continues (diffuse scenes) or is pushed after the
    refraction leg (where a specular chain continues), and a ray without a
    continuation pops.  Closest hits are brute force over all faces, 128 at
    a time (TREE_GROUP at a time in a scene with a tree, which the brute
    force never reads); in a motion scene every ray of a primary ray's tree
    sees the scene at the time drawn once for it.  ``draws`` is the draw table
    ``(max_iters * n_draws, R)`` of ``ops/rng.py``, needed when
    ``mc.n_draws > 0``; ``pix_uv`` (R,2), each ray's pixel position over
    the image size, is needed when the scene has a replace_background
    texture.  ``stats`` (a dict),
    when given, receives the slab, triangle and sphere tests the culled
    kernel performs on these rays (in a scene with a tree, the node and
    face tests of its walk, counted by ``TreeWalker``, and under ``reads``
    its masks of the node boxes, rows and winners read), how many of the
    triangle and sphere
    tests are of a face or sphere that moves (``tri_motion_tests``,
    ``sphere_motion_tests``), the numbers of traced nodes, GI rays and
    shadow rays, and the Perlin evaluations, texel taps and env
    candidates (``perlin_evals``, ``texel_taps``, ``env_candidates``; the
    lit nodes whose 16 candidates all failed, ``env_exhausted``), and
    in a scene that draws, the kernel's draws (``draws``: one Philox4x32-10
    each before its per-node cursor) and the Philox blocks that cursor
    computes for them in counter mode (``philox_blocks``)."""
    dev, f32 = o.device, torch.float32
    r = o.shape[0]
    if mc.n_draws and (draws is None or tuple(draws.shape) != (
            mc.max_iters * mc.n_draws, r)):
        raise ValueError(f"this scene draws randoms: needs a draw table "
                         f"({mc.max_iters * mc.n_draws}, {r})")
    if mc.bg_tex >= 0 and (pix_uv is None or tuple(pix_uv.shape) != (r, 2)):
        raise ValueError(f"this scene has a background texture: needs "
                         f"pix_uv ({r}, 2)")
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
    tex, env = mc.n_textures > 0, bool(mc.env)
    tex_ops = _Tex(mc, count) if (tex or env) else None
    # env scenes: the env-on-miss flag of each ray, carried through
    # children and the stack (megakernel.py:1790-1824)
    cenv = zeros.clone()
    k = mc.stack_k
    # stack: (K, R) planes for o3 d3 w3 a3 med (env scenes: + the flag),
    # plus depth
    n_planes = 14 if env else 13
    s_f = torch.zeros((n_planes, max(k, 1), r), dtype=f32, device=dev)
    s_dep = torch.zeros((max(k, 1), r), dtype=torch.int32, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    diel = mc.has_dielectric
    any_spec = ((mc.has_mirror or mc.has_conductor or diel)
                and mc.max_depth > 0)
    eps = mc.eps
    types = [int(m[0]) for m in mats]
    sample_direct = (not mc.pt) or mc.pt_nee
    ml_lights = mc.ml_lights.tolist()
    # draw slots of the area lights, the env candidates and the roughness
    # pairs (rng.py)
    base_area = 3 + 3 * len(ml_lights)
    base_env = base_area + 2 * mc.area_lights.shape[0]
    base_rough = base_env + (ENV_DRAWS if env else 0)
    # the motion time: one draw per primary ray, at iteration 0, from the
    # last slot (megakernel.py:1776-1779)
    tau_all = (rng.rnd(draws, 0, mc.n_draws - 1, mc.max_iters, mc.n_draws)
               if mc.has_motion else None)
    if tau_all is not None:  # drawn once per primary ray, a block of its own
        count("draws", r)
        count("philox_blocks", r)

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

        # the kernel's Philox block of this node per ray (-1: none yet)
        blk = torch.full(idx.shape, -1, dtype=torch.int64, device=dev)

        def drawn(gate, *slots):
            """Count the draws ``slots`` that the kernel makes, in that
            order, on the rays ``gate`` of this node."""
            nonlocal blk
            if stats is None:
                return
            for slot in slots:
                count("draws", gate.sum())
                count("philox_blocks", (gate & (blk != slot >> 2)).sum())
                blk = torch.where(gate, slot >> 2, blk)

        g = [x[idx] for x in (*co, *cd, *cw, *ca, cmed)]
        cox, coy, coz, cdx, cdy, cdz, cwx, cwy, cwz, cax, cay, caz, med = g
        dep = cdep[idx]
        env_i = cenv[idx]
        tau = None if tau_all is None else tau_all[idx]
        if tex:
            t, nx, ny, nz, matf, _, hit, win = geo.trace(
                cox, coy, coz, cdx, cdy, cdz, tau, want_win=True)
            slots, (hu, hv), tbn, (nx, ny, nz) = tex_ops.surface(
                geo, tri_tab, win, hit, (cox, coy, coz), (cdx, cdy, cdz),
                (nx, ny, nz))
        else:
            t, nx, ny, nz, matf, _, hit = geo.trace(cox, coy, coz, cdx, cdy,
                                                    cdz, tau)
        t_safe = torch.where(hit, t, torch.zeros_like(t))
        if diel:
            cwx = cwx * torch.exp(-cax * t_safe)
            cwy = cwy * torch.exp(-cay * t_safe)
            cwz = cwz * torch.exp(-caz * t_safe)
        lr, lg, lb = (x[idx] for x in L)

        def add_on(lrgb, gate, rgb_of):
            """Radiance ``rgb_of(sel)`` (n,3) on the rays ``gate``."""
            sel = gate.nonzero().squeeze(1)
            add = torch.zeros((gate.shape[0], 3), dtype=f32, device=dev)
            if sel.numel():
                add[sel] = rgb_of(sel)
            return [lrgb[c] + torch.where(gate, (cwx, cwy, cwz)[c] * add[:, c],
                                          0.0) for c in range(3)]

        # miss resolution (raytracer.cpp:49-62; megakernel.py:1837-1872):
        # primary misses see the background texture at the pixel UV, else
        # the env map, else the flat colour; later misses see the env map
        # where their branch is flagged
        miss = ~hit
        if mc.bg_tex >= 0 and it == 0:
            puv = pix_uv[idx]
            lr, lg, lb = add_on((lr, lg, lb), miss, lambda sel: tex_ops.sample(
                mc.bg_tex, puv[sel, 0], puv[sel, 1], raw=True))
        elif env and (mc.bg_tex < 0 or it > 0):
            gate = miss & ((env_i > 0.5) | (it == 0 and mc.bg_tex < 0))
            lr, lg, lb = add_on((lr, lg, lb), gate, lambda sel: tex_ops.env(
                cdx[sel], cdy[sel], cdz[sel]))
        elif it == 0:
            lr = lr + torch.where(miss, cwx * mc.bg[0], 0.0)
            lg = lg + torch.where(miss, cwy * mc.bg[1], 0.0)
            lb = lb + torch.where(miss, cwz * mc.bg[2], 0.0)
        px, py, pz = cox + t_safe * cdx, coy + t_safe * cdy, coz + t_safe * cdz
        wox, woy, woz = -cdx, -cdy, -cdz
        if tex:
            nx, ny, nz, uu, vv = _tex_normal(tex_ops, slots, (hu, hv), tbn,
                                             (px, py, pz), (nx, ny, nz))
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
        if tex:
            # replace_all: the raw sample, no lighting and no children
            # (raytracer.cpp:87-89)
            for ti in tex_ops.ids(0):
                gate = shadeable & (slots[:, 3] == float(ti))
                lr, lg, lb = add_on((lr, lg, lb), gate, lambda sel: tex_ops.sample(
                    ti, uu[sel], vv[sel], raw=True))
            shadeable = shadeable & (slots[:, 3] < 0.0)
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
                drawn(dep <= 0, 0)
                gi_alive = shadeable & ~kill & (dep > -mc.rr_floor)
                rr_scale = torch.where(dep <= 0, 1.0 / prob, 1.0)
            else:
                gi_alive = shadeable & (dep > 0)
                rr_scale = ones[idx]
            gdx, gdy, gdz = _gi_direction(nx, ny, nz, rnd(1), rnd(2),
                                          mc.pt_importance)
            drawn(gi_alive, 1, 2)
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
        if tex:
            kd = _tex_reflectance(tex_ops, slots[:, 0], kd, (px, py, pz), (uu, vv))
            ks = _tex_reflectance(tex_ops, slots[:, 1], ks, (px, py, pz), (uu, vv))
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
            lrgb = add_light(lrgb, wi, [_div(lp[3 + c], d2) for c in range(3)],
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
            frac = torch.clamp(_div(cos_a - sl[9], sl[11]), min=0.0)
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
            drawn(lit, base_area + 2 * ai, base_area + 2 * ai + 1)
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
            drawn(gate_in, 3 + 3 * li, 4 + 3 * li, 5 + 3 * li)
            blocked = shadow_of(gate_in, wi, dist)
            wgt = face[:, 9]
            lrgb = add_light(lrgb, wi, [rad * wgt * TWO_PI for rad in
                                        (rad_r, rad_g, rad_b)],
                             gate_in & ~blocked)
        # the env light's direct term (raytracer.cpp:741-755): the first of
        # 16 rejection candidates in the unit ball above the surface (the
        # normal if none), its radiance shaded with the normal as w_i and
        # no shadow ray — reference quirks, kept
        if env and sample_direct:
            ex, ey, ez = nx, ny, nz
            accepted = torch.zeros_like(lit)
            n_cand = torch.zeros(idx.shape[0], dtype=torch.int64, device=dev)
            for ci in range(16):
                n_cand = n_cand + (~accepted).to(torch.int64)
                drawn(lit & ~accepted, *range(base_env + 3 * ci,
                                              base_env + 3 * ci + 3))
                cx_ = 2.0 * rnd(base_env + 3 * ci) - 1.0
                cy_ = 2.0 * rnd(base_env + 3 * ci + 1) - 1.0
                cz_ = 2.0 * rnd(base_env + 3 * ci + 2) - 1.0
                ok = ((cx_ * cx_ + cy_ * cy_ + cz_ * cz_ <= 1.0)
                      & (cx_ * nx + cy_ * ny + cz_ * nz > 0.0))
                take = ok & ~accepted
                ex = torch.where(take, cx_, ex)
                ey = torch.where(take, cy_, ey)
                ez = torch.where(take, cz_, ez)
                accepted = accepted | ok
            count("env_candidates", n_cand[lit].sum())
            count("env_exhausted", (lit & ~accepted).sum())
            sel = lit.nonzero().squeeze(1)
            erad = torch.zeros((idx.shape[0], 3), dtype=f32, device=dev)
            if sel.numel():
                erad[sel] = tex_ops.env(ex[sel], ey[sel], ez[sel])
            lrgb = add_light(lrgb, (nx, ny, nz), [erad[:, c] for c in range(3)],
                             lit)
        lr, lg, lb = lrgb

        # ---- children: reflection continues in place, refraction pushes
        new_act = torch.zeros_like(hit)
        nox, noy, noz = px, py, pz
        ndx, ndy, ndz = wox, woy, woz
        nwx, nwy, nwz = cwx, cwy, cwz
        nax = nay = naz = torch.zeros_like(px)
        nmed = torch.ones_like(px)
        ncenv = torch.zeros_like(px)
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
                # every mirror, conductor and dielectric child draws the
                # reflection's pair, a dielectric's refraction leg the next
                spec = (mask_of(matf, _MIRROR) | mask_of(matf, _CONDUCTOR)
                        | mask_of(matf, _DIELECTRIC))
                drawn(shadeable & can & spec, base_rough, base_rough + 1)
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
                # a mirror child's miss sees the env (raytracer.cpp:461-469)
                ncenv = torch.where(mm, 1.0, ncenv)
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
                # the reflection and refraction legs' misses see the env;
                # total internal reflection's does not
                ncenv = torch.where(is_rl, 1.0, ncenv)
                # refraction leg -> push
                f0x = (cdx + nmx * cos_i) * ratio_n - nmx * cos_p
                f0y = (cdy + nmy * cos_i) * ratio_n - nmy * cos_p
                f0z = (cdz + nmz * cos_i) * ratio_n - nmz * cos_p
                if mc.has_rough:  # perturbed on the raw vector (366-375)
                    drawn(is_rl & (sp_i < k), base_rough + 2, base_rough + 3)
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
                    torch.where(fin, ab[2], 0.0), obj_n)
                    + ((torch.ones_like(px),) if env else ()), dep - 1)

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
                ncenv = torch.where(gi_cont, 0.0, ncenv)
                zero = torch.zeros_like(px)
                sp_i = push(sp_i, idx, gi_push, (
                    gox, goy, goz, gdx, gdy, gdz, *gi_w, zero, zero, zero, med)
                    + ((zero,) if env else ()), dep - 1)
                new_act = new_act | gi_cont

        # ---- pop for rays without a continuation
        ndep = dep - 1
        if k:
            need = ~new_act & (sp_i > 0)
            top = sp_i - 1
            pop_ok = need & (top < k)
            pi = idx[pop_ok]
            slot = top[pop_ok]
            outs = [nox, noy, noz, ndx, ndy, ndz, nwx, nwy, nwz, nax, nay, naz,
                    nmed, ncenv][:n_planes]
            for f in range(n_planes):
                v = torch.where(need, torch.zeros_like(outs[f]), outs[f])
                v[pop_ok] = s_f[f, slot, pi]
                outs[f] = v
            nox, noy, noz, ndx, ndy, ndz, nwx, nwy, nwz, nax, nay, naz, nmed = outs[:13]
            if env:
                ncenv = outs[13]
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
        cenv[idx] = ncenv
        act[idx] = new_act
    return torch.stack(L, dim=-1)


def _tex_normal(tx: _Tex, slots, uv, tbn, p, nrm):
    """The normal after the Perlin bump, the normal map and the image bump
    (megakernel.py:1880-2007), in that order, and the tiled UV."""
    nx, ny, nz = nrm
    tb, tn = slots[:, 2], slots[:, 4]
    for ti in tx.ids(1):  # Perlin bump: the world-space gradient
        sel = (tb == float(ti)).nonzero().squeeze(1)
        if not sel.numel():
            continue
        bf = tx.tflt[ti][0]
        qx, qy, qz = (c[sel] for c in p)
        mx_, my_, mz_ = nx[sel], ny[sel], nz[sel]
        h0 = tx.perlin(ti, qx, qy, qz) * bf
        gx = _div(tx.perlin(ti, qx + _BUMP_EPS, qy, qz) * bf - h0, _BUMP_EPS)
        gy = _div(tx.perlin(ti, qx, qy + _BUMP_EPS, qz) * bf - h0, _BUMP_EPS)
        gz = _div(tx.perlin(ti, qx, qy, qz + _BUMP_EPS) * bf - h0, _BUMP_EPS)
        gpar = gx * mx_ + gy * my_ + gz * mz_
        nx, ny, nz = nx.clone(), ny.clone(), nz.clone()
        nx[sel], ny[sel], nz[sel] = _norm3(mx_ - (gx - gpar * mx_),
                                           my_ - (gy - gpar * my_),
                                           mz_ - (gz - gpar * mz_))
    uu, vv = _texture.tile_uv(uv[0]), _texture.tile_uv(uv[1])
    # the tangent frame: world (identity scenes, against the current
    # normal) or object space with the entity's M^-T (tbn_obj)
    obj = tx.mc.tbn_obj
    on = (tbn[:, 6], tbn[:, 7], tbn[:, 8]) if obj else (nx, ny, nz)

    def to_world(sel, ax, ay, az):
        if not obj:
            return _norm3(ax, ay, az)
        m = tbn[sel, 9:18]
        return _norm3(m[:, 0] * ax + m[:, 1] * ay + m[:, 2] * az,
                      m[:, 3] * ax + m[:, 4] * ay + m[:, 5] * az,
                      m[:, 6] * ax + m[:, 7] * ay + m[:, 8] * az)

    out = [nx.clone(), ny.clone(), nz.clone()]
    for ti in tx.ids(0):
        # tangent-space normal map (mesh.cpp:264-275): rgb / 127.5 - 1
        sel = (tn == float(ti)).nonzero().squeeze(1)
        if sel.numel():
            rgb = tx.sample(ti, uu[sel], vv[sel], raw=True)
            sx, sy, sz = (_div(rgb[:, c], 127.5) - 1.0 for c in range(3))
            sx, sy, sz = _norm3(sx, sy, sz)
            t3, b3 = tbn[sel, 0:3], tbn[sel, 3:6]
            o3 = [c[sel] for c in on]
            mapped = to_world(sel, *(t3[:, c] * sx + b3[:, c] * sy + o3[c] * sz
                                     for c in range(3)))
            for c in range(3):
                out[c][sel] = mapped[c]
        # height-field bump (mesh.cpp:310-357): forward differences of the
        # mean-channel grey at integer texels, where no normal map fired
        sel = ((tb == float(ti)) & (tn < 0.0)).nonzero().squeeze(1)
        if sel.numel():
            w, h, bf = tx.tint[ti][4], tx.tint[ti][5], tx.tflt[ti][0]
            i0 = torch.clamp((uu[sel] * float(w - 1)).to(torch.int64), 0, w - 1)
            j0 = torch.clamp((vv[sel] * float(h - 1)).to(torch.int64), 0, h - 1)
            i1 = torch.clamp(i0 + 1, max=w - 1)
            j1 = torch.clamp(j0 + 1, max=h - 1)
            h_uv, h_du, h_dv = (tx.grey(ti, i0, j0), tx.grey(ti, i1, j0),
                                tx.grey(ti, i0, j1))
            t3, b3 = tbn[sel, 0:3], tbn[sel, 3:6]
            ox, oy, oz = (c[sel] for c in on)
            qu = [t3[:, c] + o * ((h_du - h_uv) * bf)
                  for c, o in enumerate((ox, oy, oz))]
            qv = [b3[:, c] + o * ((h_dv - h_uv) * bf)
                  for c, o in enumerate((ox, oy, oz))]
            nix, niy, niz = _norm3(qv[1] * qu[2] - qv[2] * qu[1],
                                   qv[2] * qu[0] - qv[0] * qu[2],
                                   qv[0] * qu[1] - qv[1] * qu[0])
            flip = (((nix * ox <= 0) & (niy * oy <= 0) & (niz * oz <= 0))
                    | ((nix - ox).abs() > 0.9) | ((niy - oy).abs() > 0.9)
                    | ((niz - oz).abs() > 0.9))
            mapped = to_world(sel, torch.where(flip, -nix, nix),
                              torch.where(flip, -niy, niy),
                              torch.where(flip, -niz, niz))
            for c in range(3):
                out[c][sel] = mapped[c]
    return (*out, uu, vv)


def _tex_reflectance(tx: _Tex, slot, k3, p, uv):
    """A diffuse or specular reflectance (three (R,) channels) with the
    texture of ``slot`` applied: a Perlin grey or an image RGB / 255
    replaces it, or with blend_kd averages with it
    (megakernel.py:2100-2137)."""
    k3 = list(k3)
    for ti in range(tx.mc.n_textures):
        sel = (slot == float(ti)).nonzero().squeeze(1)
        if not sel.numel():
            continue
        if tx.kind(ti) == 1:
            val = tx.perlin(ti, *(c[sel] for c in p))
            rgb = (val, val, val)
        else:
            s = tx.sample(ti, uv[0][sel], uv[1][sel])
            rgb = (s[:, 0], s[:, 1], s[:, 2])
        blend = tx.tint[ti][2]
        for c in range(3):
            k3[c] = k3[c].clone()
            k3[c][sel] = (rgb[c] + k3[c][sel]) * 0.5 if blend else rgb[c]
    return k3


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# the csrc/<library>.cu that holds each variant, and each variant's K1e
# instantiation over the tree (MegaConsts.variant)
LIBRARY = {"mega_whitted": "mega_whitted", "mega_pt": "mega_pt",
           "mega_ext": "mega_pt", "mega_tex": "mega_pt"}
LIBRARY.update({f"{k}_tree": v for k, v in LIBRARY.items()})
# kernel launches per instantiation; only the launches of the CUDA kernels
# count
LAUNCHES = {k: 0 for k in LIBRARY}
# flags of the K1c variant, beside the K1a/K1b ones (csrc/mega_pt.cu)
FLAG_ROUGH, FLAG_MOTION = 256, 512


def _check(name, x, shape=None, dtype=torch.float32):
    if x.dtype != dtype or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"{name}: needs a contiguous {dtype} CUDA tensor, got "
                         f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def mega_trace(mc: MegaConsts, tri_tab, chunk_tab, o, d, draws=None,
               seed: int = 0, sample: int = 0, pix_uv=None):
    """Radiance (R,3) f32 for rays o/d (R,3) f32.

    CPU tensors run the plain version (``mega_trace_ref``); CUDA tensors
    launch the scene's CUDA kernel (``mc.kernel``) or raise.  A scene that
    draws randoms (``mc.n_draws > 0``) takes them from ``draws`` (the
    ``ops/rng.py`` table) when given, else from Philox keyed by (``seed``,
    ``sample``) — on the CPU through the table that ``philox_table`` makes
    for the same key, so both devices draw the same numbers.  A scene with
    a background texture needs ``pix_uv`` (R,2).  A scene with a tree
    (``mc.tree``) launches the K1e instantiation.  ``LAUNCHES`` counts the
    kernel launches by ``mc.variant``."""
    r = o.shape[0]
    if o.device.type == "cpu":
        if mc.n_draws and draws is None:
            draws = rng.philox_table(seed, sample, r, mc.max_iters, mc.n_draws)
        return mega_trace_ref(mc, tri_tab, chunk_tab, o, d, draws=draws,
                              pix_uv=pix_uv)
    return _mega_trace_cuda(mc, tri_tab, chunk_tab, o, d, draws, seed, sample,
                            pix_uv)


@span("k1.launch")
def _mega_trace_cuda(mc: MegaConsts, tri_tab, chunk_tab, o, d, draws,
                     seed: int, sample: int, pix_uv):
    """``mega_trace`` on the card: the checks, the arguments and the
    launch."""
    from advanced_cpu_raytracing_tpu_torch.ops import _build

    r = o.shape[0]
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
    if name in ("mega_ext", "mega_tex"):
        tables += ["spot_lights", "area_lights", "mat_ext", "tri_motion",
                   "sph_motion"]
        _check("tri_motion", mc.tri_motion, (max(mc.n_tri, 1), MOTION_COLS))
        _check("mat_ext", mc.mat_ext, (mc.materials.shape[0], MATX_COLS))
    if name == "mega_tex":
        tables += ["tex_face", "tex_sph", "tex_flt", "texels"]
        _check("tex_face", mc.tex_face, (max(mc.n_tri, 1), TEXF_COLS))
        _check("tex_sph", mc.tex_sph, (mc.spheres.shape[0], TEXS_COLS))
        _check("tex_int", mc.tex_int, (max(mc.n_textures, 1), TEXI_COLS),
               torch.int32)
        _check("perm", mc.perm, (512,), torch.int32)
        if mc.bg_tex >= 0:
            if pix_uv is None:
                raise ValueError("this scene has a background texture: "
                                 "needs pix_uv")
            _check("pix_uv", pix_uv, (r, 2))
    if mc.tree is not None:
        tables.append("tree")
        if mc.tree_stack > TREE_STACK:
            raise ValueError(f"tree stack {mc.tree_stack} > {TREE_STACK}")
    for t in tables:
        _check(t, getattr(mc, t))
    if mc.tree is not None and mc.tree.shape[1] != NODE_COLS:
        raise ValueError(f"tree: shape {tuple(mc.tree.shape)}")
    if any(t.data_ptr() % 16 for t in (tri_tab, chunk_tab, *(
            [] if mc.tree is None else [mc.tree]))):
        raise ValueError("tri_tab, chunk_tab and the tree must be 16-byte "
                         "aligned")
    max_k = MAX_K_WHITTED if name == "mega_whitted" else MAX_K_PT
    if mc.stack_k > max_k:
        raise ValueError(f"stack_k {mc.stack_k} > {max_k}")
    devs = {t.device for t in (o, d, tri_tab, chunk_tab,
                               *(getattr(mc, t) for t in tables))}
    if draws is not None:
        devs.add(draws.device)
    if name == "mega_tex":
        devs |= {mc.tex_int.device, mc.perm.device}
        if mc.bg_tex >= 0:
            devs.add(pix_uv.device)
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
           ctypes.c_void_p(None if mc.tree is None else mc.tree.data_ptr()),
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
            ext = tex = None
            if name in ("mega_ext", "mega_tex"):
                # a motion table that moves nothing goes as null: its tests
                # skip the move
                ext = ctypes.byref(_build.ExtParams(
                    mc.spot_lights.data_ptr(), mc.spot_lights.shape[0],
                    mc.area_lights.data_ptr(), mc.area_lights.shape[0],
                    mc.mat_ext.data_ptr(),
                    mc.tri_motion.data_ptr() if mc.faces_move else None,
                    mc.sph_motion.data_ptr() if mc.spheres_move else None))
            if name == "mega_tex":
                env_w, env_h, env_first = mc.env or (0, 0, 0)
                tex = ctypes.byref(_build.TexParams(
                    mc.tex_face.data_ptr(), mc.tex_sph.data_ptr(),
                    mc.tex_int.data_ptr(), mc.tex_flt.data_ptr(),
                    mc.texels.data_ptr(), mc.perm.data_ptr(),
                    pix_uv.data_ptr() if mc.bg_tex >= 0 else None,
                    mc.n_textures, int(mc.tbn_obj), mc.bg_tex, env_w, env_h,
                    env_first))
            rc = lib.mega_pt_launch(*pt_args, ext, tex, stream)
    if rc != 0:
        err = getattr(lib, LIBRARY[name] + "_error_string")(rc).decode()
        raise RuntimeError(f"{mc.variant} launch failed: CUDA error {rc} "
                           f"({err})")
    LAUNCHES[mc.variant] += 1
    return out
