"""ScenePack — the SoA scene representation, as torch tensors.

Geometry + BVH nodes, entity (mesh/instance) tables with packed inverse
transforms, sphere tables, material/BRDF/light/texture tables and the image
atlas.  The packing itself is numpy, field for field the JAX package's
``scene/pack.py``; ``pack_from_arrays`` turns the numpy fields (or a JAX
``ScenePack`` read out as numpy) into tensors on one device.

Mapping to the reference:
  - entities unify Mesh / LightMesh / Triangle / MeshInstance: each entry is
    a (BVH root, inverse transform, material, textures, motion) tuple — the
    per-shape state of src/shape.hpp:22-35 in SoA form.
  - materials are indexed by ``xml_id - 1`` exactly like the reference's
    ``scene.materials[matId-1]`` (src/raytracer.cpp:73).
  - BVHs of all base meshes are concatenated into one node pool; entity
    traversal starts at ``ent_root``.
"""

from __future__ import annotations

from dataclasses import dataclass

import dataclasses

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.accel.bvh import build_bvh
from advanced_cpu_raytracing_tpu_torch.scene.types import (
    DecalMode,
    MaterialType,
    MeshCfg,
    SceneConfig,
)
from advanced_cpu_raytracing_tpu_torch.utils import transforms as tf
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

# Texture slot layout in ent_tex / sph_tex (mirrors shape.hpp:31-35).
SLOT_DIFFUSE, SLOT_SPECULAR, SLOT_NORMAL, SLOT_BUMP, SLOT_REPLACE_ALL = range(5)

_DECAL_TO_SLOT = {
    DecalMode.REPLACE_KD: SLOT_DIFFUSE,
    DecalMode.BLEND_KD: SLOT_DIFFUSE,
    DecalMode.REPLACE_KS: SLOT_SPECULAR,
    DecalMode.REPLACE_NORMAL: SLOT_NORMAL,
    DecalMode.BUMP_NORMAL: SLOT_BUMP,
    DecalMode.REPLACE_ALL: SLOT_REPLACE_ALL,
}


@dataclass(frozen=True)
class StaticInfo:
    """Hashable per-scene compile-time facts (shapes / feature gating)."""

    n_entities: int
    n_spheres: int
    n_faces: int
    n_nodes: int
    n_materials: int
    n_brdfs: int
    n_point: int
    n_directional: int
    n_spot: int
    n_area: int
    n_mesh_lights: int
    n_env: int
    n_textures: int
    n_images: int
    max_recursion_depth: int
    use_bvh: bool
    bvh_max_depth: int
    has_motion: bool
    has_uv: bool
    bg_tex: int  # dense texture index of replace_background texture, or -1
    # material classes present — static gates that elide whole integrator
    # branches (and shrink the per-lane stack) at compile time
    has_mirror: bool = True
    has_dielectric: bool = True
    has_conductor: bool = True
    # any material with roughness > 0.001 (perturbed reflections need RNG,
    # which the fused megakernel does not carry)
    has_rough: bool = False
    # any emissive material (LightMesh) present
    has_emissive_mat: bool = False
    # number of world-space brute-force work items packed into wi_* (0 when
    # the scene exceeds STREAM_MAX_FACES and no megakernel can run it)
    n_work_items: int = 0

    @property
    def has_env(self) -> bool:
        return self.n_env > 0


@dataclass
class ScenePack:
    static: StaticInfo

    # geometry (object space, faces permuted per-mesh by BVH build)
    verts: torch.Tensor  # (V,3) f32
    tri_vidx: torch.Tensor  # (F,3) i32 absolute
    tri_normal: torch.Tensor  # (F,3) f32
    tri_uvidx: torch.Tensor  # (F,3) i32, -1 if none
    tri_area: torch.Tensor  # (F,) f32
    uvs: torch.Tensor  # (U,2) f32 (>=1 row)

    # BVH pool
    node_min: torch.Tensor
    node_max: torch.Tensor
    node_left: torch.Tensor
    node_right: torch.Tensor
    node_first: torch.Tensor
    node_count: torch.Tensor

    # entities
    ent_root: torch.Tensor  # (E,) i32
    ent_face_start: torch.Tensor
    ent_face_count: torch.Tensor
    ent_minv: torch.Tensor  # (E,3,4) world->object
    ent_nrm: torch.Tensor  # (E,3,3) inverse-transpose (normal matrix)
    ent_fwd: torch.Tensor  # (E,3,4) object->world
    ent_wbb_min: torch.Tensor  # (E,3) world bbox
    ent_wbb_max: torch.Tensor
    ent_motion: torch.Tensor  # (E,3)
    ent_material: torch.Tensor  # (E,) i32 dense material index
    ent_emissive: torch.Tensor  # (E,) bool
    ent_mlight: torch.Tensor  # (E,) i32 mesh-light index or -1
    ent_tex: torch.Tensor  # (E,5) i32 dense texture index or -1

    # brute-force work items (world-space pre-transformed triangles; only
    # populated when static.use_bvh is False, else 1-row dummies)
    wi_ent: torch.Tensor  # (W,) i32 entity index
    wi_face: torch.Tensor  # (W,) i32 global face index
    wi_v0: torch.Tensor  # (W,3) f32 world-space vertices
    wi_v1: torch.Tensor
    wi_v2: torch.Tensor
    wi_motion: torch.Tensor  # (W,3) world-space motion offset direction
    wi_normal: torch.Tensor  # (W,3) world-space shading normal (M⁻ᵀ · n, unit)
    wi_mat: torch.Tensor  # (W,) i32 dense material index
    # shadow-query variant: emissive (light-mesh) entities excluded
    # (CastShadowRay skips them, src/raytracer.cpp:590-593)
    ws_v0: torch.Tensor  # (Ws,3)
    ws_v1: torch.Tensor
    ws_v2: torch.Tensor
    ws_motion: torch.Tensor

    # spheres
    sph_center: torch.Tensor  # (S,3)
    sph_radius: torch.Tensor  # (S,)
    sph_minv: torch.Tensor  # (S,3,4)
    sph_nrm: torch.Tensor  # (S,3,3)
    sph_motion: torch.Tensor  # (S,3)
    sph_material: torch.Tensor  # (S,)
    sph_tex: torch.Tensor  # (S,5)

    # materials
    mat_type: torch.Tensor
    mat_ambient: torch.Tensor
    mat_diffuse: torch.Tensor
    mat_specular: torch.Tensor
    mat_mirror: torch.Tensor
    mat_absorption: torch.Tensor
    mat_radiance: torch.Tensor
    mat_phong: torch.Tensor
    mat_ior: torch.Tensor
    mat_cond_k: torch.Tensor
    mat_roughness: torch.Tensor
    mat_brdf: torch.Tensor  # (M,) i32 dense brdf index or -1

    # brdfs
    brdf_kind: torch.Tensor
    brdf_exponent: torch.Tensor
    brdf_normalized: torch.Tensor
    brdf_kdfresnel: torch.Tensor

    # lights
    ambient_light: torch.Tensor  # (3,)
    pl_pos: torch.Tensor
    pl_intensity: torch.Tensor
    dl_dir: torch.Tensor
    dl_radiance: torch.Tensor
    sl_pos: torch.Tensor
    sl_dir: torch.Tensor
    sl_intensity: torch.Tensor
    sl_coverage_deg: torch.Tensor
    sl_falloff_deg: torch.Tensor
    sl_cos_half_cov: torch.Tensor
    sl_cos_half_fall: torch.Tensor
    al_pos: torch.Tensor
    al_normal: torch.Tensor
    al_radiance: torch.Tensor
    al_extent: torch.Tensor
    al_area: torch.Tensor
    al_u: torch.Tensor
    al_v: torch.Tensor
    ml_ent: torch.Tensor  # (L,) entity index
    ml_radiance: torch.Tensor
    ml_face_start: torch.Tensor
    ml_face_count: torch.Tensor
    ml_area: torch.Tensor
    env_img: torch.Tensor  # (Ne,) i32 dense image index

    # textures / images
    img_atlas: torch.Tensor  # (I,Hmax,Wmax,3) f32
    img_w: torch.Tensor
    img_h: torch.Tensor
    tex_kind: torch.Tensor  # 0=image 1=perlin
    tex_decal: torch.Tensor
    tex_interp: torch.Tensor  # 0=nearest 1=bilinear
    tex_normalizer: torch.Tensor
    tex_bump_factor: torch.Tensor
    tex_img: torch.Tensor
    tex_noise_scale: torch.Tensor
    tex_noise_conv: torch.Tensor  # 0=linear 1=absval

    # scalars
    bg_color: torch.Tensor  # (3,)
    shadow_eps: torch.Tensor  # ()


FIELD_NAMES = tuple(f.name for f in dataclasses.fields(ScenePack)
                    if f.name != "static")


def pack_from_arrays(fields: dict, static: StaticInfo,
                     device=None) -> ScenePack:
    """Build a ScenePack from numpy arrays, one per field name — the output
    of ``pack_scene``'s numpy stage, or a JAX ``ScenePack`` read out field
    by field with ``np.asarray``.  Dtypes are kept (f32, i32, bool)."""
    dev = resolve_device(device)
    missing = set(FIELD_NAMES) - set(fields)
    if missing:
        raise KeyError(f"pack_from_arrays: missing fields {sorted(missing)}")
    return ScenePack(static=static, **{
        n: torch.as_tensor(np.array(fields[n]), device=dev)
        for n in FIELD_NAMES})


def _f32(x):
    return np.asarray(x, np.float32)


def _i32(x):
    return np.asarray(x, np.int32)


def _face_props(verts: np.ndarray, tris: np.ndarray):
    a = verts[tris[:, 0]].astype(np.float64)
    b = verts[tris[:, 1]].astype(np.float64)
    c = verts[tris[:, 2]].astype(np.float64)
    n = np.cross(b - a, c - a)
    nl = np.linalg.norm(n, axis=-1, keepdims=True)
    normal = n / np.maximum(nl, 1e-30)
    center = (a + b + c) / 3.0
    # area via cross product == Heron's formula (parser.cpp:600-607)
    area = 0.5 * nl[:, 0]
    bb_min = np.minimum(np.minimum(a, b), c)
    bb_max = np.maximum(np.maximum(a, b), c)
    return normal, center, area, bb_min, bb_max


# Sets StaticInfo.use_bvh exactly as the JAX package does (its wavefront
# integrator brute-forces scenes up to this many work items).
BRUTE_FORCE_MAX_ITEMS = 2048

# Work items (world-space triangles) are packed for every scene up to
# STREAM_MAX_FACES, as in the JAX package; the CUDA megakernels take all of
# them (past ops/megakernel.py::FLAT_MAX_FACES through a tree).
STREAM_MAX_FACES = 1 << 21


def pack_scene(cfg: SceneConfig, device=None) -> ScenePack:
    """Pack a parsed scene into tensors on ``device`` (default ``cuda``)."""
    fields, static = pack_arrays(cfg)
    return pack_from_arrays(fields, static, device=device)


def pack_arrays(cfg: SceneConfig) -> tuple[dict, StaticInfo]:
    """The numpy stage of ``pack_scene``: ({field: ndarray}, StaticInfo)."""
    # ---------------- geometry: concatenate base meshes ----------------
    vert_chunks: list[np.ndarray] = []
    vert_offsets: dict[int, int] = {}  # id(verts array) -> base offset
    v_total = 0

    def vert_base(verts: np.ndarray) -> int:
        nonlocal v_total
        key = id(verts)
        if key not in vert_offsets:
            vert_offsets[key] = v_total
            vert_chunks.append(np.asarray(verts, np.float32))
            v_total += len(verts)
        return vert_offsets[key]

    uv_chunks: list[np.ndarray] = []
    uv_offsets: dict[int, int] = {}
    u_total = 0

    def uv_base(uvs: np.ndarray) -> int:
        nonlocal u_total
        key = id(uvs)
        if key not in uv_offsets:
            uv_offsets[key] = u_total
            uv_chunks.append(np.asarray(uvs, np.float32))
            u_total += len(uvs)
        return uv_offsets[key]

    tri_vidx_chunks, tri_nrm_chunks, tri_uv_chunks, tri_area_chunks = [], [], [], []
    node_chunks = {k: [] for k in ("min", "max", "left", "right", "first", "count")}
    f_total = 0
    n_total = 0
    bvh_max_depth = 1

    # per base mesh (cfg.meshes order): bookkeeping for entities
    mesh_face_start: dict[int, int] = {}
    mesh_face_count: dict[int, int] = {}
    mesh_root: dict[int, int] = {}
    mesh_bbox: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    mesh_area: dict[int, float] = {}

    for mi, mesh in enumerate(cfg.meshes):
        vb = vert_base(mesh.vertices)
        tris = np.asarray(mesh.faces, np.int64)
        normal, center, area, bb_min, bb_max = _face_props(
            np.asarray(mesh.vertices, np.float64), tris
        )
        bvh = build_bvh(bb_min, bb_max, center)
        order = bvh.order
        bvh_max_depth = max(bvh_max_depth, bvh.max_depth)

        tri_vidx_chunks.append((tris[order] + vb).astype(np.int32))
        tri_nrm_chunks.append(normal[order].astype(np.float32))
        tri_area_chunks.append(area[order].astype(np.float32))
        if mesh.uv_indices is not None and mesh.uvs is not None and len(mesh.uvs):
            ub = uv_base(mesh.uvs)
            tri_uv_chunks.append(
                (np.asarray(mesh.uv_indices, np.int64)[order] + ub).astype(np.int32)
            )
        else:
            tri_uv_chunks.append(np.full((len(tris), 3), -1, np.int32))

        node_chunks["min"].append(bvh.node_min)
        node_chunks["max"].append(bvh.node_max)
        # rebase child indices and face ranges into the global pools
        left = np.where(bvh.node_left >= 0, bvh.node_left + n_total, -1)
        right = np.where(bvh.node_right >= 0, bvh.node_right + n_total, -1)
        node_chunks["left"].append(left.astype(np.int32))
        node_chunks["right"].append(right.astype(np.int32))
        node_chunks["first"].append((bvh.node_first + f_total).astype(np.int32))
        node_chunks["count"].append(bvh.node_count.astype(np.int32))

        mesh_face_start[mi] = f_total
        mesh_face_count[mi] = len(tris)
        mesh_root[mi] = n_total
        if len(tris):
            mesh_bbox[mi] = (bb_min.min(axis=0), bb_max.max(axis=0))
        else:
            mesh_bbox[mi] = (np.full(3, np.inf), np.full(3, -np.inf))
        mesh_area[mi] = float(area.sum())
        f_total += len(tris)
        n_total += bvh.num_nodes

    verts = (
        np.concatenate(vert_chunks, axis=0) if vert_chunks else np.zeros((1, 3), np.float32)
    )
    uvs = (
        np.concatenate(uv_chunks, axis=0) if uv_chunks else np.zeros((1, 2), np.float32)
    )
    if f_total:
        tri_vidx = np.concatenate(tri_vidx_chunks)
        tri_normal = np.concatenate(tri_nrm_chunks)
        tri_uvidx = np.concatenate(tri_uv_chunks)
        tri_area = np.concatenate(tri_area_chunks)
        node_min = np.concatenate(node_chunks["min"])
        node_max = np.concatenate(node_chunks["max"])
        node_left = np.concatenate(node_chunks["left"])
        node_right = np.concatenate(node_chunks["right"])
        node_first = np.concatenate(node_chunks["first"])
        node_count = np.concatenate(node_chunks["count"])
    else:
        tri_vidx = np.zeros((1, 3), np.int32)
        tri_normal = np.zeros((1, 3), np.float32)
        tri_uvidx = np.full((1, 3), -1, np.int32)
        tri_area = np.zeros((1,), np.float32)
        node_min = np.full((1, 3), np.inf, np.float32)
        node_max = np.full((1, 3), -np.inf, np.float32)
        node_left = np.full(1, -1, np.int32)
        node_right = np.full(1, -1, np.int32)
        node_first = np.zeros(1, np.int32)
        node_count = np.zeros(1, np.int32)
        n_total = 1

    # ---------------- materials (indexed by xml_id - 1) ----------------
    mats = cfg.materials
    n_mat = max(len(mats), 1)
    mat_type = np.zeros(n_mat, np.int32)
    mat_amb = np.zeros((n_mat, 3), np.float32)
    mat_dif = np.zeros((n_mat, 3), np.float32)
    mat_spe = np.zeros((n_mat, 3), np.float32)
    mat_mir = np.zeros((n_mat, 3), np.float32)
    mat_abs = np.zeros((n_mat, 3), np.float32)
    mat_rad = np.zeros((n_mat, 3), np.float32)
    mat_phong = np.ones(n_mat, np.float32)
    mat_ior = np.ones(n_mat, np.float32)
    mat_k = np.zeros(n_mat, np.float32)
    mat_rough = np.zeros(n_mat, np.float32)
    mat_brdf = np.full(n_mat, -1, np.int32)

    brdf_index = {b.id: i for i, b in enumerate(cfg.brdfs)}
    for i, m in enumerate(mats):
        mat_type[i] = int(m.type)
        mat_amb[i] = m.ambient
        mat_dif[i] = m.diffuse
        mat_spe[i] = m.specular
        mat_mir[i] = m.mirror
        mat_abs[i] = m.absorption_coefficient
        mat_rad[i] = m.radiance
        mat_phong[i] = m.phong_exponent
        mat_ior[i] = m.refractive_index
        mat_k[i] = m.conductor_absorption_index
        mat_rough[i] = m.roughness
        if m.brdf_id is not None and m.brdf_id in brdf_index:
            mat_brdf[i] = brdf_index[m.brdf_id]

    n_brdf = max(len(cfg.brdfs), 1)
    brdf_kind = np.zeros(n_brdf, np.int32)
    brdf_exp = np.zeros(n_brdf, np.float32)
    brdf_norm = np.zeros(n_brdf, np.bool_)
    brdf_kdf = np.zeros(n_brdf, np.bool_)
    for i, b in enumerate(cfg.brdfs):
        brdf_kind[i] = int(b.kind)
        brdf_exp[i] = b.exponent
        brdf_norm[i] = b.normalized
        brdf_kdf[i] = b.kd_fresnel

    # ---------------- textures / images ----------------
    imgs = cfg.images
    n_img = max(len(imgs), 1)
    img_index = {im.id: i for i, im in enumerate(imgs)}
    if imgs:
        h_max = max(im.data.shape[0] for im in imgs)
        w_max = max(im.data.shape[1] for im in imgs)
        atlas = np.zeros((len(imgs), h_max, w_max, 3), np.float32)
        img_w = np.zeros(len(imgs), np.int32)
        img_h = np.zeros(len(imgs), np.int32)
        for i, im in enumerate(imgs):
            h, w = im.data.shape[:2]
            atlas[i, :h, :w] = im.data
            img_w[i], img_h[i] = w, h
    else:
        atlas = np.zeros((1, 1, 1, 3), np.float32)
        img_w = np.ones(1, np.int32)
        img_h = np.ones(1, np.int32)

    texs = cfg.textures
    n_tex = max(len(texs), 1)
    tex_index = {t.id: i for i, t in enumerate(texs)}
    tex_kind = np.zeros(n_tex, np.int32)
    tex_decal = np.zeros(n_tex, np.int32)
    tex_interp = np.zeros(n_tex, np.int32)
    tex_norm = np.full(n_tex, 255.0, np.float32)
    tex_bump = np.ones(n_tex, np.float32)
    tex_img = np.full(n_tex, -1, np.int32)
    tex_nscale = np.ones(n_tex, np.float32)
    tex_nconv = np.zeros(n_tex, np.int32)
    for i, t in enumerate(texs):
        tex_kind[i] = 0 if t.kind == "image" else 1
        tex_decal[i] = int(t.decal)
        # reference defaults to Bilinear unless explicitly "nearest"
        # (imageTexture.h:24-27)
        tex_interp[i] = 0 if t.interpolation == "nearest" else 1
        tex_norm[i] = t.normalizer
        tex_bump[i] = t.bump_factor
        if t.image_id is not None and t.image_id in img_index:
            tex_img[i] = img_index[t.image_id]
        tex_nscale[i] = t.noise_scale
        tex_nconv[i] = 0 if t.noise_conversion == "linear" else 1

    bg_tex = tex_index.get(cfg.background_texture_id, -1) if cfg.background_texture_id else -1

    def tex_slots(tex_ids: list[int], has_uv: bool = True) -> np.ndarray:
        slots = np.full(5, -1, np.int32)
        for tid in tex_ids:
            if tid in tex_index:
                t = texs[tex_index[tid]]
                slot = _DECAL_TO_SLOT.get(t.decal)
                if slot is not None:
                    slots[slot] = tex_index[tid]
        if not has_uv:
            # the reference's whole mesh normal/bump block sits inside
            # `if (uv.size() > 0)` (mesh.cpp:245-309): without TexCoordData
            # even PERLIN bump — which needs no UVs — silently no-ops.
            # Spheres are not gated (sphere.cpp derives its own phi/theta UV).
            slots[SLOT_NORMAL] = -1
            slots[SLOT_BUMP] = -1
        return slots

    def mesh_has_uv(mesh) -> bool:
        return (mesh.uv_indices is not None and mesh.uvs is not None
                and len(mesh.uvs) > 0)

    # ---------------- entities: meshes then instances ----------------
    mesh_by_id: dict[int, int] = {}
    for mi, mesh in enumerate(cfg.meshes):
        mesh_by_id.setdefault(mesh.id, mi)

    ent_rows = []  # dicts
    ml_rows = []
    for mi, mesh in enumerate(cfg.meshes):
        m, m_inv = tf.compose(mesh.transform_ops)
        bb_min, bb_max = mesh_bbox[mi]
        wbb_min, wbb_max = tf.transform_aabb(m, bb_min, bb_max)
        mat_idx = mesh.material_id - 1
        is_emissive = mat_type[mat_idx] == int(MaterialType.EMISSIVE)
        mlight = -1
        if mesh.is_light:
            mlight = len(ml_rows)
            ml_rows.append(dict(
                ent=len(ent_rows), radiance=mesh.radiance,
                face_start=mesh_face_start[mi], face_count=mesh_face_count[mi],
                area=mesh_area[mi],
            ))
        ent_rows.append(dict(
            root=mesh_root[mi], face_start=mesh_face_start[mi],
            face_count=mesh_face_count[mi],
            minv=m_inv, nrm=m_inv.T, fwd=m,
            wbb_min=wbb_min, wbb_max=wbb_max,
            motion=(mesh.motion_blur if mesh.motion_blur is not None else np.zeros(3)),
            material=mat_idx, emissive=bool(is_emissive), mlight=mlight,
            tex=tex_slots(mesh.textures, has_uv=mesh_has_uv(mesh)),
        ))

    # instances: resolve chains; parser.cpp:374-386 follows to the root base
    # mesh for geometry but composes transforms with the immediate parent.
    inst_transform: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    inst_base: dict[int, int] = {}  # instance id -> base mesh index (cfg.meshes)
    for inst in cfg.instances:
        parent_id = inst.base_mesh_id
        if parent_id in inst_base:  # parent is an earlier instance
            base_mi = inst_base[parent_id]
            parent_m, parent_minv = inst_transform[parent_id]
        else:
            base_mi = mesh_by_id[parent_id]
            pm, pminv = tf.compose(cfg.meshes[base_mi].transform_ops)
            parent_m, parent_minv = pm, pminv
        m_own, minv_own = tf.compose(inst.transform_ops)
        if inst.transform_ops and not inst.reset_transform:
            # compose with parent (parser.cpp:439-447)
            m = m_own @ parent_m
            m_inv = parent_minv @ minv_own
        else:
            m, m_inv = m_own, minv_own
        inst_transform[inst.id] = (m, m_inv)
        inst_base[inst.id] = base_mi

        base_mesh: MeshCfg = cfg.meshes[base_mi]
        bb_min, bb_max = mesh_bbox[base_mi]
        wbb_min, wbb_max = tf.transform_aabb(m, bb_min, bb_max)
        if inst.material_id is not None:
            mat_idx = inst.material_id - 1
        else:
            mat_idx = base_mesh.material_id - 1
        is_emissive = mat_type[mat_idx] == int(MaterialType.EMISSIVE)
        ent_rows.append(dict(
            root=mesh_root[base_mi], face_start=mesh_face_start[base_mi],
            face_count=mesh_face_count[base_mi],
            minv=m_inv, nrm=m_inv.T, fwd=m,
            wbb_min=wbb_min, wbb_max=wbb_max,
            motion=(inst.motion_blur if inst.motion_blur is not None else np.zeros(3)),
            material=mat_idx, emissive=bool(is_emissive), mlight=-1,
            tex=tex_slots(inst.textures, has_uv=mesh_has_uv(base_mesh)),
        ))

    n_ent = max(len(ent_rows), 1)
    ent = {
        "root": np.zeros(n_ent, np.int32),
        "face_start": np.zeros(n_ent, np.int32),
        "face_count": np.zeros(n_ent, np.int32),
        "minv": np.tile(np.eye(3, 4, dtype=np.float32), (n_ent, 1, 1)),
        "nrm": np.tile(np.eye(3, dtype=np.float32), (n_ent, 1, 1)),
        "fwd": np.tile(np.eye(3, 4, dtype=np.float32), (n_ent, 1, 1)),
        "wbb_min": np.full((n_ent, 3), np.inf, np.float32),
        "wbb_max": np.full((n_ent, 3), -np.inf, np.float32),
        "motion": np.zeros((n_ent, 3), np.float32),
        "material": np.zeros(n_ent, np.int32),
        "emissive": np.zeros(n_ent, np.bool_),
        "mlight": np.full(n_ent, -1, np.int32),
        "tex": np.full((n_ent, 5), -1, np.int32),
    }
    for i, row in enumerate(ent_rows):
        ent["root"][i] = row["root"]
        ent["face_start"][i] = row["face_start"]
        ent["face_count"][i] = row["face_count"]
        ent["minv"][i] = np.asarray(row["minv"], np.float32)[:3, :4]
        ent["nrm"][i] = np.asarray(row["nrm"], np.float32)[:3, :3]
        ent["fwd"][i] = np.asarray(row["fwd"], np.float32)[:3, :4]
        ent["wbb_min"][i] = row["wbb_min"]
        ent["wbb_max"][i] = row["wbb_max"]
        ent["motion"][i] = row["motion"]
        ent["material"][i] = row["material"]
        ent["emissive"][i] = row["emissive"]
        ent["mlight"][i] = row["mlight"]
        ent["tex"][i] = row["tex"]

    # ---------------- spheres ----------------
    n_sph = max(len(cfg.spheres), 1)
    sph_center = np.zeros((n_sph, 3), np.float32)
    sph_radius = np.ones(n_sph, np.float32)
    sph_minv = np.tile(np.eye(3, 4, dtype=np.float32), (n_sph, 1, 1))
    sph_nrm = np.tile(np.eye(3, dtype=np.float32), (n_sph, 1, 1))
    sph_motion = np.zeros((n_sph, 3), np.float32)
    sph_material = np.zeros(n_sph, np.int32)
    sph_tex = np.full((n_sph, 5), -1, np.int32)
    for i, s in enumerate(cfg.spheres):
        m, m_inv = tf.compose(s.transform_ops)
        sph_center[i] = s.center
        sph_radius[i] = s.radius
        sph_minv[i] = m_inv[:3, :4].astype(np.float32)
        sph_nrm[i] = m_inv.T[:3, :3].astype(np.float32)
        if s.motion_blur is not None:
            sph_motion[i] = s.motion_blur
        sph_material[i] = s.material_id - 1
        sph_tex[i] = tex_slots(s.textures)

    # ---------------- lights ----------------
    def stack3(items, attr):
        if not items:
            return np.zeros((0, 3), np.float32)
        return np.stack([np.asarray(getattr(x, attr), np.float32) for x in items])

    pl_pos = stack3(cfg.point_lights, "position")
    pl_int = stack3(cfg.point_lights, "intensity")
    dl_dir = stack3(cfg.directional_lights, "direction")
    dl_rad = stack3(cfg.directional_lights, "radiance")
    sl_pos = stack3(cfg.spot_lights, "position")
    sl_dir = stack3(cfg.spot_lights, "direction")
    sl_int = stack3(cfg.spot_lights, "intensity")
    sl_cov = np.array([s.coverage_angle_deg for s in cfg.spot_lights], np.float32)
    sl_fall = np.array([s.falloff_angle_deg for s in cfg.spot_lights], np.float32)
    sl_chc = np.cos(np.deg2rad(sl_cov / 2.0)).astype(np.float32)
    sl_chf = np.cos(np.deg2rad(sl_fall / 2.0)).astype(np.float32)
    al_pos = stack3(cfg.area_lights, "position")
    al_nrm = stack3(cfg.area_lights, "normal")
    al_rad = stack3(cfg.area_lights, "radiance")
    al_ext = np.array([a.extent for a in cfg.area_lights], np.float32)
    al_area = al_ext * al_ext
    if len(cfg.area_lights):
        from advanced_cpu_raytracing_tpu_torch.utils.math3d import orthonormal_basis

        u, v = orthonormal_basis(torch.as_tensor(al_nrm))
        al_u, al_v = u.numpy(), v.numpy()
    else:
        al_u = np.zeros((0, 3), np.float32)
        al_v = np.zeros((0, 3), np.float32)

    ml_ent = np.array([r["ent"] for r in ml_rows], np.int32)
    ml_rad = (
        np.stack([np.asarray(r["radiance"], np.float32) for r in ml_rows])
        if ml_rows else np.zeros((0, 3), np.float32)
    )
    ml_fs = np.array([r["face_start"] for r in ml_rows], np.int32)
    ml_fc = np.array([r["face_count"] for r in ml_rows], np.int32)
    ml_area = np.array([r["area"] for r in ml_rows], np.float32)

    env_img = np.array(
        [img_index.get(e.image_id, 0) for e in cfg.environment_lights], np.int32
    )

    has_motion = any(m.motion_blur is not None for m in cfg.meshes) or any(
        i.motion_blur is not None for i in cfg.instances
    ) or any(s.motion_blur is not None for s in cfg.spheres)
    has_uv = bool(np.any(tri_uvidx >= 0))

    work_items = int(sum(r["face_count"] for r in ent_rows))
    use_bvh = work_items > BRUTE_FORCE_MAX_ITEMS

    # Brute-force work items: every (entity, face) pair with the triangle
    # pre-transformed to world space (the JAX package's ops/traverse.py gives
    # the equivalence argument vs the reference's ray-to-object-space
    # transform).  Packed for every scene up to STREAM_MAX_FACES.
    if work_items <= STREAM_MAX_FACES and work_items > 0:
        wi_ent = np.concatenate([
            np.full(r["face_count"], i, np.int32) for i, r in enumerate(ent_rows)
        ])
        wi_face = np.concatenate([
            np.arange(r["face_start"], r["face_start"] + r["face_count"], dtype=np.int32)
            for r in ent_rows
        ])
        fwd = np.stack([np.asarray(r["fwd"], np.float64)[:3, :4] for r in ent_rows])
        rot = fwd[wi_ent][:, :, :3]  # (W,3,3)
        trn = fwd[wi_ent][:, :, 3]  # (W,3)
        tv = tri_vidx[wi_face]  # (W,3)
        wv = []
        for k in range(3):
            v = verts[tv[:, k]].astype(np.float64)
            wv.append((np.einsum("wij,wj->wi", rot, v) + trn).astype(np.float32))
        wi_v0, wi_v1, wi_v2 = wv
        motion = np.stack([np.asarray(r["motion"], np.float64) for r in ent_rows])
        wi_motion = np.einsum(
            "wij,wj->wi", rot, motion[wi_ent]
        ).astype(np.float32)
        # world shading normal: M⁻ᵀ · n_obj, normalized — exactly the
        # surface_at path (Mesh::Intersect normal transform, mesh.cpp:184-187)
        nrm = np.stack([np.asarray(r["nrm"], np.float64)[:3, :3] for r in ent_rows])
        wn = np.einsum("wij,wj->wi", nrm[wi_ent], tri_normal[wi_face].astype(np.float64))
        wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-30)
        wi_normal = wn.astype(np.float32)
        wi_mat = np.array([ent_rows[e]["material"] for e in wi_ent], np.int32)
        n_work_items = work_items
    else:
        wi_ent = np.zeros(1, np.int32)
        wi_face = np.zeros(1, np.int32)
        wi_v0 = wi_v1 = wi_v2 = np.zeros((1, 3), np.float32)
        wi_motion = np.zeros((1, 3), np.float32)
        wi_normal = np.zeros((1, 3), np.float32)
        wi_mat = np.zeros(1, np.int32)
        n_work_items = 0

    emissive_flags = np.array([bool(r["emissive"]) for r in ent_rows], bool)
    shadow_keep = (~emissive_flags[wi_ent]) if len(ent_rows) else np.zeros(1, bool)
    if shadow_keep.any():
        ws_v0 = wi_v0[shadow_keep]
        ws_v1 = wi_v1[shadow_keep]
        ws_v2 = wi_v2[shadow_keep]
        ws_motion = wi_motion[shadow_keep]
    else:
        ws_v0 = ws_v1 = ws_v2 = np.zeros((1, 3), np.float32)
        ws_motion = np.zeros((1, 3), np.float32)

    static = StaticInfo(
        n_entities=len(ent_rows), n_spheres=len(cfg.spheres), n_faces=f_total,
        n_nodes=n_total, n_materials=len(mats), n_brdfs=len(cfg.brdfs),
        n_point=len(cfg.point_lights), n_directional=len(cfg.directional_lights),
        n_spot=len(cfg.spot_lights), n_area=len(cfg.area_lights),
        n_mesh_lights=len(ml_rows), n_env=len(cfg.environment_lights),
        n_textures=len(texs), n_images=len(imgs),
        max_recursion_depth=cfg.max_recursion_depth,
        use_bvh=use_bvh, bvh_max_depth=bvh_max_depth,
        has_motion=has_motion, has_uv=has_uv, bg_tex=bg_tex,
        has_mirror=bool((mat_type == int(MaterialType.MIRROR)).any()),
        has_dielectric=bool((mat_type == int(MaterialType.DIELECTRIC)).any()),
        has_conductor=bool((mat_type == int(MaterialType.CONDUCTOR)).any()),
        has_rough=bool((mat_rough > 0.001).any()),
        has_emissive_mat=bool((mat_type == int(MaterialType.EMISSIVE)).any()),
        n_work_items=n_work_items,
    )

    fields = dict(
        verts=_f32(verts), tri_vidx=_i32(tri_vidx), tri_normal=_f32(tri_normal),
        tri_uvidx=_i32(tri_uvidx), tri_area=_f32(tri_area), uvs=_f32(uvs),
        node_min=_f32(node_min), node_max=_f32(node_max),
        node_left=_i32(node_left), node_right=_i32(node_right),
        node_first=_i32(node_first), node_count=_i32(node_count),
        ent_root=_i32(ent["root"]), ent_face_start=_i32(ent["face_start"]),
        ent_face_count=_i32(ent["face_count"]), ent_minv=_f32(ent["minv"]),
        ent_nrm=_f32(ent["nrm"]), ent_fwd=_f32(ent["fwd"]),
        ent_wbb_min=_f32(ent["wbb_min"]), ent_wbb_max=_f32(ent["wbb_max"]),
        ent_motion=_f32(ent["motion"]), ent_material=_i32(ent["material"]),
        ent_emissive=np.asarray(ent["emissive"], np.bool_), ent_mlight=_i32(ent["mlight"]),
        ent_tex=_i32(ent["tex"]),
        wi_ent=_i32(wi_ent), wi_face=_i32(wi_face),
        wi_v0=_f32(wi_v0), wi_v1=_f32(wi_v1), wi_v2=_f32(wi_v2),
        wi_motion=_f32(wi_motion), wi_normal=_f32(wi_normal),
        wi_mat=_i32(wi_mat),
        ws_v0=_f32(ws_v0), ws_v1=_f32(ws_v1), ws_v2=_f32(ws_v2),
        ws_motion=_f32(ws_motion),
        sph_center=_f32(sph_center), sph_radius=_f32(sph_radius),
        sph_minv=_f32(sph_minv), sph_nrm=_f32(sph_nrm),
        sph_motion=_f32(sph_motion), sph_material=_i32(sph_material),
        sph_tex=_i32(sph_tex),
        mat_type=_i32(mat_type), mat_ambient=_f32(mat_amb), mat_diffuse=_f32(mat_dif),
        mat_specular=_f32(mat_spe), mat_mirror=_f32(mat_mir),
        mat_absorption=_f32(mat_abs), mat_radiance=_f32(mat_rad),
        mat_phong=_f32(mat_phong), mat_ior=_f32(mat_ior), mat_cond_k=_f32(mat_k),
        mat_roughness=_f32(mat_rough), mat_brdf=_i32(mat_brdf),
        brdf_kind=_i32(brdf_kind), brdf_exponent=_f32(brdf_exp),
        brdf_normalized=np.asarray(brdf_norm, np.bool_),
        brdf_kdfresnel=np.asarray(brdf_kdf, np.bool_),
        ambient_light=_f32(cfg.ambient_light),
        pl_pos=_f32(pl_pos), pl_intensity=_f32(pl_int),
        dl_dir=_f32(dl_dir), dl_radiance=_f32(dl_rad),
        sl_pos=_f32(sl_pos), sl_dir=_f32(sl_dir), sl_intensity=_f32(sl_int),
        sl_coverage_deg=_f32(sl_cov), sl_falloff_deg=_f32(sl_fall),
        sl_cos_half_cov=_f32(sl_chc), sl_cos_half_fall=_f32(sl_chf),
        al_pos=_f32(al_pos), al_normal=_f32(al_nrm), al_radiance=_f32(al_rad),
        al_extent=_f32(al_ext), al_area=_f32(al_area), al_u=_f32(al_u), al_v=_f32(al_v),
        ml_ent=_i32(ml_ent), ml_radiance=_f32(ml_rad), ml_face_start=_i32(ml_fs),
        ml_face_count=_i32(ml_fc), ml_area=_f32(ml_area), env_img=_i32(env_img),
        img_atlas=_f32(atlas), img_w=_i32(img_w), img_h=_i32(img_h),
        tex_kind=_i32(tex_kind), tex_decal=_i32(tex_decal), tex_interp=_i32(tex_interp),
        tex_normalizer=_f32(tex_norm), tex_bump_factor=_f32(tex_bump),
        tex_img=_i32(tex_img), tex_noise_scale=_f32(tex_nscale),
        tex_noise_conv=_i32(tex_nconv),
        bg_color=_f32(cfg.background_color), shadow_eps=_f32(cfg.shadow_ray_epsilon),
    )
    return fields, static
