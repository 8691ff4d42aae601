"""Direct lighting of the wavefront integrator: shadow rays and per-light
irradiance over the six light types (SampleDirectLighting,
src/raytracer.cpp:701-806; the JAX package's ``render/lights.py``).

Each light type is a Python loop over its lights, vectorized over the
rays.  The randoms (area-light offsets, the mesh-light face pick and its
barycentrics, the environment light's candidates) come from the
integrator's draw source (``ops/rng.py``), asked per (iteration, site,
light).
"""

from __future__ import annotations

import math

import torch

from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops.intersect import transform_point
from advanced_cpu_raytracing_tpu_torch.ops.texture import sample_nearest
from advanced_cpu_raytracing_tpu_torch.ops.traverse import occluded
from advanced_cpu_raytracing_tpu_torch.render.shading import (
    Surface,
    diffuse_reflectance,
    shade,
    specular_reflectance,
)
from advanced_cpu_raytracing_tpu_torch.utils.math3d import (
    clip,
    div,
    dot,
    length,
    maximum,
)

PI = math.pi


def env_sample_radiance(pack, d, light: int = 0):
    """Lat-long environment lookup of directions d times 2 pi
    (SphericalEnvironmentLight::GetSample, sphericalEnvironmentLight.h:
    22-35)."""
    u = (1.0 + div(torch.atan2(d[:, 0], -d[:, 2]), PI)) / 2.0
    v = div(torch.acos(clip(d[:, 1], -1.0, 1.0)), PI)
    idx = pack.env_img[light].long().expand(d.shape[0])
    return sample_nearest(pack.img_atlas, pack.img_w, pack.img_h, idx, u,
                          v) * (2.0 * PI)


def _hemisphere_rejection(cands, normal):
    """An upper-hemisphere direction by rejection sampling
    (SphericalEnvironmentLight::GetDirection, sphericalEnvironmentLight.h:
    37-64): of 16 candidates (16, R, 3) uniform in [-1, 1]^3, the first
    inside the unit ball and above the surface, unnormalized as the
    reference leaves it; the normal itself if none is."""
    ok = (length(cands) <= 1.0) & ((cands * normal[None]).sum(-1) > 0.0)
    first = torch.argmax(ok.to(torch.int8), dim=0)
    pick = cands.gather(0, first[None, :, None].expand(1, -1, 3))[0]
    return torch.where(ok.any(dim=0)[:, None], pick, normal)


def direct_lighting(pack, surf: Surface, w_o, time, draws, it: int,
                    skip_mlight=None, mat_rows=None,
                    differentiable: bool = False):
    """The sum of all direct-light contributions at the surface points.

    ``skip_mlight`` (R,) is a mesh-light index to skip for NEE
    double-count suppression (raytracer.cpp:778-781), or -1.  The shadow
    rays of all lights go as one occlusion query ((L*R,) rays, one K3
    launch in a brute-force scene); the reference scans the lights one by
    one per shading point."""
    st = pack.static
    r, dev = surf.point.shape[0], surf.point.device
    total = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    # texture-modulated reflectances do not depend on the light
    kd = diffuse_reflectance(
        pack, surf, None if mat_rows is None else mat_rows.diffuse)
    ks = specular_reflectance(
        pack, surf, None if mat_rows is None else mat_rows.specular)
    shadow_o = surf.point + surf.normal * pack.shadow_eps

    w_is, limits, irrs, gates = [], [], [], []

    def towards(target):
        v = target - surf.point
        dist = length(v)
        return v / maximum(dist, 1e-20)[:, None], dist

    def falloff(dist):
        return maximum(dist * dist, 1e-20)[:, None]

    ones = torch.ones(r, dtype=torch.bool, device=dev)
    # point lights (raytracer.cpp:706-718)
    for i in range(st.n_point):
        w_i, dist = towards(pack.pl_pos[i].expand(r, 3))
        w_is.append(w_i)
        limits.append(dist)
        irrs.append(pack.pl_intensity[i] / falloff(dist))
        gates.append(ones)

    # area lights (raytracer.cpp:720-740, areaLight.h:34-41)
    for i in range(st.n_area):
        offs = draws.uniform(it, rng.SITE_AREA, r, 2, light=i, lo=-0.5, hi=0.5)
        sample_pos = (pack.al_pos[i]
                      + pack.al_u[i] * (pack.al_extent[i] * offs[:, 0:1])
                      + pack.al_v[i] * (pack.al_extent[i] * offs[:, 1:2]))
        w_i, dist = towards(sample_pos)
        l_cos = dot(pack.al_normal[i].expand(r, 3), -w_i)
        l_cos = torch.where(l_cos < 0, -l_cos, l_cos)  # two-sided (733-736)
        w_is.append(w_i)
        limits.append(dist)
        irrs.append(pack.al_radiance[i] * (
            pack.al_area[i] * l_cos / maximum(dist * dist, 1e-20))[:, None])
        gates.append(ones)

    # directional lights (raytracer.cpp:757-765): shadow ray to infinity
    for i in range(st.n_directional):
        w_is.append((-pack.dl_dir[i]).expand(r, 3))
        limits.append(torch.full((r,), math.inf, device=dev))
        irrs.append(pack.dl_radiance[i].expand(r, 3))
        gates.append(ones)

    # spot lights (raytracer.cpp:767-776, spotLight.h:33-57)
    for i in range(st.n_spot):
        w_i, dist = towards(pack.sl_pos[i].expand(r, 3))
        cos_alpha = clip(dot(pack.sl_dir[i].expand(r, 3), -w_i), -1.0, 1.0)
        alpha_deg = torch.rad2deg(torch.acos(cos_alpha))
        irr = pack.sl_intensity[i] / falloff(dist)
        # falloff: ((cos a - cos(cov/2)) / (cos(fall/2) - cos(cov/2)))^4
        s = torch.pow(maximum(
            (cos_alpha - pack.sl_cos_half_cov[i])
            / maximum(pack.sl_cos_half_fall[i] - pack.sl_cos_half_cov[i], 1e-9),
            0.0), 4.0)
        in_falloff = alpha_deg > (pack.sl_falloff_deg[i] / 2.0)
        irr = torch.where(in_falloff[:, None], irr * s[:, None], irr)
        outside = (alpha_deg <= 0) | (alpha_deg > pack.sl_coverage_deg[i] / 2.0)
        irr = torch.where(outside[:, None], 0.0, irr)
        w_is.append(w_i)
        limits.append(dist)
        irrs.append(irr)
        gates.append(ones)

    # mesh lights (raytracer.cpp:778-803, meshLight.h:27-50)
    if st.n_mesh_lights:
        counts = pack.ml_face_count[:st.n_mesh_lights].tolist()
        starts = pack.ml_face_start[:st.n_mesh_lights].tolist()
        ml_ents = pack.ml_ent[:st.n_mesh_lights].tolist()
    for i in range(st.n_mesh_lights):
        fsel = draws.randint(it, rng.SITE_ML_FACE, r, max(counts[i], 1),
                             light=i) + starts[i]
        weight = pack.tri_area[fsel] / maximum(pack.ml_area[i], 1e-20)
        r12 = draws.uniform(it, rng.SITE_ML_BARY, r, 2, light=i)
        vi = pack.tri_vidx[fsel].long()
        a, b, c = (pack.verts[vi[:, k]] for k in range(3))
        sq = torch.sqrt(r12[:, 0:1])
        q = b * (1 - r12[:, 1:2]) + c * r12[:, 1:2]
        pos = transform_point(pack.ent_fwd[ml_ents[i]], a * (1 - sq) + q * sq)
        w_i, dist = towards(pos)
        # the reference computes but never applies the mesh light's cosine:
        # its irradiance is radiance * weight * 2 pi (raytracer.cpp:800)
        w_is.append(w_i)
        limits.append(dist)
        irrs.append(pack.ml_radiance[i] * (weight * 2.0 * PI)[:, None])
        gates.append(ones if skip_mlight is None else skip_mlight != i)

    # one occlusion query over every (light, ray) pair
    n_shadow = len(w_is)
    if n_shadow:
        blocked = occluded(
            pack, shadow_o.repeat(n_shadow, 1), torch.cat(w_is, 0),
            torch.cat(limits, 0), time.repeat(n_shadow),
            differentiable=differentiable).reshape(n_shadow, r)
    for li in range(n_shadow):
        contrib = shade(pack, surf, w_is[li], w_o, irrs[li], kd, ks, mat_rows)
        ok = gates[li] & ~blocked[li]
        total = total + torch.where(ok[:, None], contrib, 0.0)

    # environment lights (raytracer.cpp:741-755): a rejection-sampled
    # upper-hemisphere direction, no shadow ray (the reference leaves it
    # TODO), and Shade gets the surface normal as w_i (line 753)
    for i in range(st.n_env):
        cands = draws.uniform(it, rng.SITE_ENV, r, 48, light=i, lo=-1.0, hi=1.0)
        d = _hemisphere_rejection(cands.reshape(r, 16, 3).transpose(0, 1),
                                  surf.normal)
        irr = env_sample_radiance(pack, d, i)
        total = total + shade(pack, surf, surf.normal, w_o, irr, kd, ks,
                              mat_rows)
    return total
