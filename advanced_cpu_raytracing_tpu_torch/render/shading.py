"""Surface reconstruction and local shading of the wavefront integrator
(the JAX package's ``render/shading.py``), batched and masked.

Derives the reference's per-hit state (HitInfo, src/ray.hpp:10-20) from
the compact ``Hit``: texture-modulated reflectances, normal and bump maps,
and the Shade() dispatch between the default Blinn-Phong split and the
pluggable BRDFs (Raytracer::Shade, src/raytracer.cpp:192-206).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from advanced_cpu_raytracing_tpu_torch.ops import texture as tex_ops
from advanced_cpu_raytracing_tpu_torch.ops.brdf import (
    default_diffuse,
    default_specular,
    eval_brdf,
)
from advanced_cpu_raytracing_tpu_torch.ops.intersect import (
    transform_ray,
    transform_vector,
)
from advanced_cpu_raytracing_tpu_torch.ops.traverse import KIND_TRI, Hit
from advanced_cpu_raytracing_tpu_torch.scene.pack import (
    SLOT_BUMP,
    SLOT_DIFFUSE,
    SLOT_NORMAL,
    SLOT_SPECULAR,
)
from advanced_cpu_raytracing_tpu_torch.scene.types import DecalMode
from advanced_cpu_raytracing_tpu_torch.utils.math3d import (
    clip,
    cross,
    div,
    dot,
    maximum,
    normalize,
)

PI = math.pi


class MaterialRows(NamedTuple):
    """Per-lane material fields."""

    type: torch.Tensor  # (R,)
    ambient: torch.Tensor  # (R,3)
    diffuse: torch.Tensor
    specular: torch.Tensor
    mirror: torch.Tensor
    absorption: torch.Tensor
    radiance: torch.Tensor
    phong: torch.Tensor  # (R,)
    ior: torch.Tensor
    cond_k: torch.Tensor
    rough: torch.Tensor
    brdf: torch.Tensor  # (R,) int


def gather_materials(pack, m) -> MaterialRows:
    """Each material field of each lane's material ``m`` (the JAX package
    fuses them into one table gather for the TPU; the values are the
    same)."""
    return MaterialRows(
        type=pack.mat_type[m].long(), ambient=pack.mat_ambient[m],
        diffuse=pack.mat_diffuse[m], specular=pack.mat_specular[m],
        mirror=pack.mat_mirror[m], absorption=pack.mat_absorption[m],
        radiance=pack.mat_radiance[m], phong=pack.mat_phong[m],
        ior=pack.mat_ior[m], cond_k=pack.mat_cond_k[m],
        rough=pack.mat_roughness[m], brdf=pack.mat_brdf[m].long())


class Surface(NamedTuple):
    point: torch.Tensor  # (R,3) world hit point
    normal: torch.Tensor  # (R,3) world shading normal (after maps)
    uv: torch.Tensor  # (R,2)
    mat: torch.Tensor  # (R,) dense material index
    tex: torch.Tensor  # (R,5) texture slots of the hit shape
    mlight: torch.Tensor  # (R,) mesh-light index of the hit entity or -1
    valid: torch.Tensor  # (R,)


def _gather_tri_uv(pack, face, beta, gamma):
    uvi = pack.tri_uvidx[face].long()
    has = uvi[:, 0] >= 0
    uvi = uvi.clamp(min=0)
    uv0, uv1, uv2 = pack.uvs[uvi[:, 0]], pack.uvs[uvi[:, 1]], pack.uvs[uvi[:, 2]]
    uv = uv0 + beta[:, None] * (uv1 - uv0) + gamma[:, None] * (uv2 - uv0)
    uv = tex_ops.tile_uv(uv)  # (mesh.cpp:256-258)
    return torch.where(has[:, None], uv, 0.0), has, (uv0, uv1, uv2)


def _tri_tangents(pack, face, uv012):
    """Tangent and bitangent from the UV edges
    (Mesh::GetTangentAndBitangentForTriangle, src/mesh.cpp:390-422)."""
    vi = pack.tri_vidx[face].long()
    v0, v1, v2 = (pack.verts[vi[:, k]] for k in range(3))
    e1 = normalize(v1 - v0, eps=1e-20)
    e2 = normalize(v2 - v1, eps=1e-20)
    uv0, uv1, uv2 = (tex_ops.tile_uv(u) for u in uv012)
    u1 = uv1[:, 0] - uv0[:, 0]
    w1 = uv1[:, 1] - uv0[:, 1]
    u2 = uv2[:, 0] - uv1[:, 0]
    w2 = uv2[:, 1] - uv1[:, 1]
    det = u1 * w2 - w1 * u2
    det = 1.0 / torch.where(det == 0, 1e-20, det)
    tan = (w2[:, None] * e1 - w1[:, None] * e2) * det[:, None]
    bitan = (-u2[:, None] * e1 + u1[:, None] * e2) * det[:, None]
    return normalize(tan, eps=1e-20), normalize(bitan, eps=1e-20)


def _sphere_tangents(p_rel, radius, phi, theta):
    """Analytic sphere tangents (Sphere::GetTangentAndBitangentAroundPoint,
    src/sphere.cpp:181-193)."""
    tan = torch.stack([2 * PI * p_rel[:, 2], torch.zeros_like(phi),
                       -2 * PI * p_rel[:, 0]], dim=-1)
    bitan = torch.stack([PI * p_rel[:, 1] * torch.cos(phi),
                         -radius * PI * torch.sin(theta),
                         PI * p_rel[:, 1] * torch.sin(phi)], dim=-1)
    return normalize(tan, eps=1e-20), normalize(bitan, eps=1e-20)


def _sample_tex_rgb(pack, tex_idx, uv):
    """Raw GetRGBSample of image textures (0..255 for LDR images)."""
    ti = tex_idx.clamp(min=0)
    return tex_ops.sample_image(pack.img_atlas, pack.img_w, pack.img_h,
                                pack.tex_img[ti].long().clamp(min=0),
                                pack.tex_interp[ti], uv[:, 0], uv[:, 1])


def _sample_tex_world(pack, tex_idx, point):
    """GetSampleFromWorldPos of generated (Perlin) textures."""
    ti = tex_idx.clamp(min=0)
    return tex_ops.perlin_sample(point, pack.tex_noise_scale[ti],
                                 pack.tex_noise_conv[ti])


def _apply_bump_normal_maps(pack, kind, hit: Hit, point, uv, uv012, n_obj,
                            tex, p_rel, radius, phi, theta):
    """Normal mapping (TBN) and bump mapping, mesh path (mesh.cpp:264-357)
    and sphere path (sphere.cpp:116-169).  Returns the object-space normal;
    the caller transforms it by the inverse transpose."""
    n = n_obj
    is_tri = kind == KIND_TRI
    normal_slot = tex[:, SLOT_NORMAL]
    bump_slot = tex[:, SLOT_BUMP]

    # normal map (triangles only: the reference's sphere normal-map path is
    # commented out, sphere.cpp:95-115)
    has_nm = (normal_slot >= 0) & is_tri
    sampled = normalize(div(_sample_tex_rgb(pack, normal_slot, uv), 127.5)
                        - 1.0, eps=1e-20)
    tan, bitan = _tri_tangents(pack, hit.face, uv012)
    # TBN multiply (GetTransformedNormal, helperMath.cpp:86-108)
    n_mapped = (tan * sampled[:, 0:1] + bitan * sampled[:, 1:2]
                + n * sampled[:, 2:3])
    n = torch.where(has_nm[:, None], normalize(n_mapped, eps=1e-20), n)

    has_bump = bump_slot >= 0
    ti = bump_slot.clamp(min=0)
    is_perlin = pack.tex_kind[ti] == 1
    bf = pack.tex_bump_factor[ti]

    # generated (Perlin) bump: a world-space gradient of the scaled height
    # by forward differences (mesh.cpp:290-309 applies bumpFactor to the
    # height; sphere.cpp:123-137 does not)
    eps = 1e-3
    scale = torch.where(is_tri, bf, 1.0)
    p0 = torch.where(is_tri[:, None], point, p_rel)
    h0 = _sample_tex_world(pack, bump_slot, p0) * scale
    steps = torch.eye(3, dtype=torch.float32, device=point.device) * eps
    grad = torch.stack([
        div(_sample_tex_world(pack, bump_slot, p0 + steps[k]) * scale - h0,
            eps) for k in range(3)], dim=-1)
    # the sphere's base normal for bumps: cross(bitan, tan) (sphere.cpp:118-121)
    tan_s, bitan_s = _sphere_tangents(p_rel, radius, phi, theta)
    n_base = torch.where(is_tri[:, None], n,
                         normalize(cross(bitan_s, tan_s), eps=1e-20))
    g_par = n_base * dot(grad, n_base)[:, None]
    n_perlin = normalize(n_base - (grad - g_par), eps=1e-20)

    # image bump: forward differences on the height texture; mesh path
    # (mesh.cpp:310-357) grey = sum/3, sphere path (sphere.cpp:138-167)
    # sum / normalizer
    img_idx = pack.tex_img[ti].long().clamp(min=0)
    w_img = pack.img_w[img_idx].long()
    h_img = pack.img_h[img_idx].long()
    iw = (uv[:, 0] * torch.where(is_tri, w_img - 1, w_img).to(torch.float32)
          ).to(torch.int64)
    jh = (uv[:, 1] * torch.where(is_tri, h_img - 1, h_img).to(torch.float32)
          ).to(torch.int64)
    i1 = torch.minimum(iw + 1, w_img - 1)
    j1 = torch.minimum(jh + 1, h_img - 1)
    iw_c = torch.minimum(torch.maximum(iw, torch.zeros_like(iw)), w_img - 1)
    jh_c = torch.minimum(torch.maximum(jh, torch.zeros_like(jh)), h_img - 1)

    def grey(ii, jj):
        c = tex_ops.atlas_fetch(pack.img_atlas, img_idx, ii, jj)
        s = c[:, 0] + c[:, 1] + c[:, 2]
        return torch.where(is_tri, div(s, 3.0), s / pack.tex_normalizer[ti])

    h_uv = grey(iw_c, jh_c)
    h_du = grey(i1, jh_c)
    h_dv = grey(iw_c, j1)
    tan_i = torch.where(is_tri[:, None], tan, tan_s)
    bitan_i = torch.where(is_tri[:, None], bitan, bitan_s)
    nb = torch.where(is_tri[:, None], n, n_base)
    q_u = tan_i + nb * ((h_du - h_uv) * bf)[:, None]
    q_v = bitan_i + nb * ((h_dv - h_uv) * bf)[:, None]
    n_img = normalize(cross(q_v, q_u), eps=1e-20)
    # orientation fixups (mesh.cpp:345-354): flip if opposing the geometric
    # normal on all axes, or wildly diverging on any
    flip1 = (n_img * nb <= 0).all(dim=-1)
    flip2 = ((n_img - nb).abs() > 0.9).any(dim=-1) & is_tri
    n_img = torch.where((flip1 | flip2)[:, None], -n_img, n_img)

    n_bumped = torch.where(is_perlin[:, None], n_perlin, n_img)
    return torch.where((has_bump & ~has_nm)[:, None], n_bumped, n)


def surface_at(pack, o, d, time, hit: Hit) -> Surface:
    """World-space surface state at each hit (HitInfo)."""
    st = pack.static
    r, dev = o.shape[0], o.device
    # miss lanes carry t = inf: zero it so no inf/NaN point exists (its
    # gradient would leak through the selects)
    t_eff = torch.where(hit.valid, hit.t, 0.0)
    point = o + d * t_eff[:, None]
    is_tri = hit.kind == KIND_TRI
    ent = hit.index.clamp(0, max(st.n_entities - 1, 0))
    sph = hit.index.clamp(0, max(st.n_spheres - 1, 0))
    zeros2 = torch.zeros((r, 2), dtype=torch.float32, device=dev)

    n_obj_tri = pack.tri_normal[hit.face]
    if st.has_uv or st.n_textures > 0:
        uv_tri, _, uv012 = _gather_tri_uv(pack, hit.face, hit.beta, hit.gamma)
    else:
        uv_tri = zeros2
        uv012 = (zeros2, zeros2, zeros2)
    nrm_ent = pack.ent_nrm[ent]
    ent_material = pack.ent_material[ent].long()
    ent_mlight = pack.ent_mlight[ent].long()
    ent_tex = pack.ent_tex[ent].long() if st.n_textures > 0 else None

    if st.n_spheres > 0:
        sph_minv = pack.sph_minv[sph]
        nrm_sph = pack.sph_nrm[sph]
        radius = pack.sph_radius[sph]
        sph_material = pack.sph_material[sph].long()
        sph_tex = pack.sph_tex[sph].long() if st.n_textures > 0 else None
        o_l, d_l = transform_ray(sph_minv, o, d)
        if st.has_motion:
            o_l = o_l + pack.sph_motion[sph] * time[:, None]
        p_rel = o_l + d_l * t_eff[:, None] - pack.sph_center[sph]
        if st.n_textures > 0:
            phi = torch.atan2(p_rel[:, 2], p_rel[:, 0])
            # strictly inside (-1, 1): acos' gradient is infinite at the
            # poles
            theta = torch.acos(clip(p_rel[:, 1] / radius, -0.999999, 0.999999))
            uv_sph = torch.stack([div(-phi + PI, 2 * PI), div(theta, PI)], -1)
        else:
            phi = theta = torch.zeros(r, device=dev)
            uv_sph = zeros2
        n_obj_sph = normalize(p_rel, eps=1e-20)
    else:
        p_rel = torch.zeros((r, 3), device=dev)
        radius = torch.ones(r, device=dev)
        phi = theta = torch.zeros(r, device=dev)
        uv_sph = zeros2
        n_obj_sph = torch.zeros((r, 3), device=dev)
        sph_material = torch.zeros(r, dtype=torch.int64, device=dev)
        sph_tex = None
        nrm_sph = torch.eye(3, device=dev).expand(r, 3, 3)

    n_obj = torch.where(is_tri[:, None], n_obj_tri, n_obj_sph)
    uv = torch.where(is_tri[:, None], uv_tri, uv_sph)
    if st.n_textures > 0 and sph_tex is not None:
        tex = torch.where(is_tri[:, None], ent_tex, sph_tex)
    elif st.n_textures > 0:
        tex = ent_tex
    else:
        tex = torch.full((r, 5), -1, dtype=torch.int64, device=dev)
    mat = torch.where(is_tri, ent_material, sph_material)
    if st.n_mesh_lights > 0:
        mlight = torch.where(is_tri, ent_mlight, -1)
    else:
        mlight = torch.full((r,), -1, dtype=torch.int64, device=dev)

    if st.n_textures > 0:
        n_obj = _apply_bump_normal_maps(pack, hit.kind, hit, point, uv, uv012,
                                        n_obj, tex, p_rel, radius, phi, theta)

    nrm_mat = torch.where(is_tri[:, None, None], nrm_ent, nrm_sph)
    normal = normalize(transform_vector(nrm_mat, n_obj), eps=1e-20)
    return Surface(point=point, normal=normal, uv=uv, mat=mat, tex=tex,
                   mlight=mlight, valid=hit.valid)


def _texture_reflectance(pack, surf: Surface, k, slot_col: int):
    """kd or ks with the texture of slot ``slot_col`` applied
    (GetDiffuseReflectanceCoeff, src/raytracer.cpp:478-508)."""
    if pack.static.n_textures == 0:
        return k
    slot = surf.tex[:, slot_col]
    has = slot >= 0
    ti = slot.clamp(min=0)
    is_perlin = pack.tex_kind[ti] == 1
    perlin = _sample_tex_world(pack, slot, surf.point)[:, None].expand(-1, 3)
    image = div(_sample_tex_rgb(pack, slot, surf.uv), 255.0)
    tex_k = torch.where(is_perlin[:, None], perlin, image)
    is_blend = pack.tex_decal[ti] == int(DecalMode.BLEND_KD)
    modulated = torch.where(is_blend[:, None], (tex_k + k) / 2.0, tex_k)
    return torch.where(has[:, None], modulated, k)


def diffuse_reflectance(pack, surf: Surface, base=None):
    """kd with texture modulation."""
    kd = pack.mat_diffuse[surf.mat] if base is None else base
    return _texture_reflectance(pack, surf, kd, SLOT_DIFFUSE)


def specular_reflectance(pack, surf: Surface, base=None):
    """ks with texture modulation.  The reference's
    GetSpecularReflectanceCoeff (src/raytracer.cpp:509-539) samples the
    diffuse texture pointer here, a null dereference when only a specular
    texture exists; this samples the specular texture and blends against
    mat.specular, as the JAX package does."""
    ks = pack.mat_specular[surf.mat] if base is None else base
    return _texture_reflectance(pack, surf, ks, SLOT_SPECULAR)


def shade(pack, surf: Surface, w_i, w_o, irradiance, kd=None, ks=None,
          mat_rows: MaterialRows | None = None):
    """Raytracer::Shade (src/raytracer.cpp:192-206): the material's BRDF
    if it has one, else the default diffuse + specular.  ``kd``, ``ks`` and
    ``mat_rows`` may come precomputed (they do not depend on w_i)."""
    st = pack.static
    if kd is None:
        kd = diffuse_reflectance(
            pack, surf, None if mat_rows is None else mat_rows.diffuse)
    if ks is None:
        ks = specular_reflectance(
            pack, surf, None if mat_rows is None else mat_rows.specular)
    phong = pack.mat_phong[surf.mat] if mat_rows is None else mat_rows.phong
    n = surf.normal
    base = default_diffuse(kd, w_i, n, irradiance) + default_specular(
        ks, phong, w_i, w_o, n, irradiance)
    if st.n_brdfs == 0:
        return base
    bidx = pack.mat_brdf[surf.mat].long() if mat_rows is None else mat_rows.brdf
    ior = pack.mat_ior[surf.mat] if mat_rows is None else mat_rows.ior
    bi = bidx.clamp(min=0)
    val = eval_brdf(pack.brdf_kind[bi], pack.brdf_exponent[bi],
                    pack.brdf_normalized[bi], pack.brdf_kdfresnel[bi], ior, kd,
                    ks, w_i, w_o, n)
    cos_i = maximum(0.0, dot(w_i, n))
    return torch.where((bidx >= 0)[:, None], val * irradiance * cos_i[:, None],
                       base)


def shade_weight(pack, surf: Surface, w_i, w_o, mat_rows=None):
    """Shade with unit irradiance: the path weight of a GI bounce
    (raytracer.cpp:188 applies Shade(..., Li) * 2pi with Li the child's
    radiance)."""
    return shade(pack, surf, w_i, w_o, torch.ones_like(w_i), mat_rows=mat_rows)
