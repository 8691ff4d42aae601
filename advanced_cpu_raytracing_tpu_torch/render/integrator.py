"""The wavefront integrator: the reference's recursive shading tree as a
per-ray stack of pending rays, iterated over the whole batch (the JAX
package's ``render/integrator.py``).

The reference recurses (PerformShading, src/raytracer.cpp:65-134): mirrors
and conductors spawn one child ray, dielectrics split into two
(raytracer.cpp:261-415), path tracing adds a sampled GI child
(raytracer.cpp:135-191).  Here every ray owns a LIFO stack of pending rays
{origin, direction, weight, absorption, medium, depth, env-on-miss,
primary}; each iteration pops one entry per ray, traces the whole batch
(``ops/traverse.py``: kernel K3 for scenes of at most 2,048 work items),
adds ``weight x local radiance`` and pushes the children.  A node's
contribution is its local radiance times the product of the branch weights
(mirror colour, Fresnel ratios, Beer attenuation) from the root, which the
stacked weight carries.  Beer's law (raytracer.cpp:416-423) is applied at
pop time: a child carries the absorption chosen at push and its hit
applies ``exp(-c t)``.  Russian roulette follows the reference's intent
(survive with probability max-throughput once the depth is spent, then
divide, raytracer.cpp:137-147) with real path throughput and a depth floor
(``RR_DEPTH_FLOOR``).

The randoms come from one draw source, asked per (iteration, site, light)
(``ops/rng.py``): Philox by default, or a table (the tests replay the JAX
wavefront's ``jax.random`` draws through one).  With
``differentiable=True`` the closest hits recompute the winner's t and
barycentrics differentiably (``ops/traverse.py``) and torch autograd
differentiates the rest; the loop stops once every stack is empty, where
the JAX package runs a fixed trip count (reverse mode cannot cross its
``lax.while_loop``): the iterations it adds are fully masked and add
nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from advanced_cpu_raytracing_tpu_torch.ops import rng
from advanced_cpu_raytracing_tpu_torch.ops.traverse import (
    KIND_TRI,
    Hit,
    closest_hit,
)
from advanced_cpu_raytracing_tpu_torch.render.camera import generate_rays
from advanced_cpu_raytracing_tpu_torch.render.lights import (
    direct_lighting,
    env_sample_radiance,
)
from advanced_cpu_raytracing_tpu_torch.render.shading import (
    _sample_tex_rgb,
    gather_materials,
    shade_weight,
    surface_at,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import SLOT_REPLACE_ALL
from advanced_cpu_raytracing_tpu_torch.scene.types import MaterialType
from advanced_cpu_raytracing_tpu_torch.utils.math3d import (
    clip,
    div,
    dot,
    maximum,
    normalize,
    orthonormal_basis,
)

PI = math.pi
RR_DEPTH_FLOOR = 8  # extra bounces allowed past depth 0 under Russian roulette
GI_EPS = 1e-4  # the reference's hard-coded GI epsilon (raytracer.cpp:174)
_EMISSIVE = int(MaterialType.EMISSIVE)
_MIRROR = int(MaterialType.MIRROR)
_CONDUCTOR = int(MaterialType.CONDUCTOR)
_DIELECTRIC = int(MaterialType.DIELECTRIC)


@dataclass(frozen=True)
class RenderOptions:
    """The render settings of one camera (RendererParams,
    src/rendererParams.h:6-26) and the integrator's switches."""

    path_tracing: bool = False
    importance_sampling: bool = False
    next_event_estimation: bool = False
    russian_roulette: bool = False
    max_depth: int = 5
    max_iters: int = 0  # 0: auto_iters
    # differentiate through the integrator (the closest hits recompute the
    # winner's t differentiably)
    differentiable: bool = False
    # a dielectric hit samples ONE child (reflect with probability r_refl,
    # else refract) with the parent's weight, an unbiased estimator of the
    # deterministic split with a flat ray population; path tracing's default
    stochastic_dielectric: bool = False
    # path tracing at a specular hit samples one of the GI and the specular
    # child by a fair coin, its weight doubled
    stochastic_spec_gi: bool = False

    def auto_iters(self, branching: int = 2) -> int:
        """An upper bound on the tree nodes per ray: ``branching`` children
        per node at most, a b-ary tree of depth d has at most
        (b^(d+1) - 1) / (b - 1) nodes."""
        if self.max_iters:
            return self.max_iters
        d = self.max_depth + (RR_DEPTH_FLOOR if self.russian_roulette else 0)
        if branching <= 1:
            return d + 2
        return min((branching ** (min(d, 9) + 1)) // (branching - 1) + 16, 4096)


def branches(static, opts: RenderOptions) -> int:
    """Children a node may push: the specular chain, GI under path tracing,
    the dielectric's second leg unless it is sampled; one under the
    spec-vs-GI coin."""
    if opts.path_tracing and opts.stochastic_spec_gi:
        return 1
    return 1 + (1 if opts.path_tracing else 0) + (
        1 if static.has_dielectric and not opts.stochastic_dielectric else 0)


def stack_size(static, opts: RenderOptions) -> int:
    """The stack's capacity K (JAX integrator.py:521-533): with P push
    branches per node the depth-first stack grows by at most P - 1 per
    level; a pure chain holds one pending child between pops."""
    b = branches(static, opts)
    if b == 1:
        return 2
    depth_total = opts.max_depth + (RR_DEPTH_FLOOR if opts.russian_roulette
                                    else 0)
    return (b - 1) * max(depth_total, 1) + 4


# --------------------------------------------------------------------------
# the per-ray stack
# --------------------------------------------------------------------------

_F = 13  # floats per entry: origin 0:3, direction 3:6, weight 6:9,
# absorption 9:12, medium 12


class _Stack(NamedTuple):
    f: torch.Tensor  # (R,K,13) f32
    depth: torch.Tensor  # (R,K) int64
    flags: torch.Tensor  # (R,K) int64: 1 env on miss, 2 primary
    sp: torch.Tensor  # (R,) int64


def _make_stack(r: int, k: int, device) -> _Stack:
    # directions start as +z, so popped empty entries (masked lanes) never
    # trace a degenerate d = 0 ray, whose NaNs would reach the gradient
    f = torch.zeros((r, k, _F), dtype=torch.float32, device=device)
    f[:, :, 5] = 1.0
    f[:, :, 12] = 1.0
    z = torch.zeros((r, k), dtype=torch.int64, device=device)
    return _Stack(f, z, z, torch.zeros(r, dtype=torch.int64, device=device))


def _push(stack: _Stack, mask, o, d, w, absorb, medium, depth, envmiss,
          primary=None) -> _Stack:
    """Push one entry on each masked ray's stack, at its stack pointer (a
    gather and a scatter there; the JAX package selects one-hot over the
    slots, which computes the same).  An entry past the capacity is
    dropped, as the one-hot select drops it."""
    k = stack.f.shape[1]
    ok = mask & (stack.sp < k)
    idx = stack.sp.clamp(max=k - 1)[:, None]
    vals = torch.cat([o, d, w, absorb, medium[:, None]], dim=1)
    idx3 = idx[:, :, None].expand(-1, 1, _F)
    cur = stack.f.gather(1, idx3)[:, 0]
    f = stack.f.scatter(1, idx3, torch.where(ok[:, None], vals, cur)[:, None])
    flag = envmiss.long() + (2 * primary.long() if primary is not None else 0)
    dep = stack.depth.scatter(1, idx, torch.where(
        ok, depth, stack.depth.gather(1, idx)[:, 0])[:, None])
    fl = stack.flags.scatter(1, idx, torch.where(
        ok, flag, stack.flags.gather(1, idx)[:, 0])[:, None])
    return _Stack(f, dep, fl, stack.sp + mask.long())


def _pop(stack: _Stack):
    """Pop the top entry of each ray's stack: (stack, active, (o, d, w,
    absorb, medium, depth, envmiss, primary)).  A ray with an empty stack
    reads its bottom slot and is inactive."""
    k = stack.f.shape[1]
    active = stack.sp > 0
    idx = (stack.sp - 1).clamp(min=0)
    inside = (idx < k)[:, None]
    idx = idx.clamp(max=k - 1)[:, None]
    e = stack.f.gather(1, idx[:, :, None].expand(-1, 1, _F))[:, 0]
    e = torch.where(inside, e, 0.0)
    depth = torch.where(inside[:, 0], stack.depth.gather(1, idx)[:, 0], 0)
    flags = torch.where(inside[:, 0], stack.flags.gather(1, idx)[:, 0], 0)
    entry = (e[:, 0:3], e[:, 3:6], e[:, 6:9], e[:, 9:12], e[:, 12], depth,
             (flags & 1) != 0, (flags & 2) != 0)
    return stack._replace(sp=torch.where(active, stack.sp - 1, stack.sp)), \
        active, entry


# --------------------------------------------------------------------------
# one node per ray
# --------------------------------------------------------------------------


def _reflect_rough(n, w_o, rough, psi):
    """Reflect, perturbed by roughness (Raytracer::Reflect,
    src/raytracer.cpp:424-440); ``psi`` (R,2) uniforms in [-0.5, 0.5)."""
    r = normalize(n * (2.0 * dot(n, w_o))[:, None] - w_o)
    u, v = orthonormal_basis(r)
    perturbed = normalize(r + (u * psi[:, 0:1] + v * psi[:, 1:2]) * rough[:, None])
    return torch.where((rough > 0.001)[:, None], perturbed, r)


def _perturb_dir(d, rough, psi):
    """Roughness perturbation of a refracted direction
    (raytracer.cpp:366-376)."""
    u, v = orthonormal_basis(d)
    perturbed = normalize(d + (u * psi[:, 0:1] + v * psi[:, 1:2]) * rough[:, None])
    return torch.where((rough > 0.001)[:, None], perturbed, normalize(d))


def _process_hit(pack, opts: RenderOptions, o, d, w_in, absorb, medium, depth,
                 time, draws, it: int, hit: Hit, L, stack: _Stack):
    """Shade one popped batch of rays and push their children
    (PerformShading, src/raytracer.cpp:65-134, with the branch weights
    applied at push time).  Returns (L, stack)."""
    st = pack.static
    r, dev = o.shape[0], o.device
    zeros3 = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    no = torch.zeros(r, dtype=torch.bool, device=dev)
    valid = hit.valid
    t_safe = torch.where(valid, hit.t, 0.0)
    w = w_in * torch.exp(-absorb * t_safe[:, None])

    surf = surface_at(pack, o, d, time, hit)
    w_o = -d
    mr = gather_materials(pack, surf.mat)
    mtype = mr.type
    eps = pack.shadow_eps
    n = surf.normal
    p = surf.point
    rough = mr.rough
    active = valid
    any_specular = st.has_mirror or st.has_dielectric or st.has_conductor

    def psi(site):
        return draws.uniform(it, site, r, 2) - 0.5

    # emissive: radiance * 2 pi, nothing else (raytracer.cpp:81-84)
    is_emissive = mtype == _EMISSIVE
    L = L + torch.where((active & is_emissive)[:, None],
                        w * mr.radiance * (2.0 * PI), 0.0)
    active = active & ~is_emissive

    # a replace_all texture short-circuits shading (raytracer.cpp:87-89)
    if st.n_textures > 0:
        ra_slot = surf.tex[:, SLOT_REPLACE_ALL]
        has_ra = ra_slot >= 0
        ra_col = _sample_tex_rgb(pack, ra_slot, surf.uv)
        L = L + torch.where((active & has_ra)[:, None], w * ra_col, 0.0)
        active = active & ~has_ra

    # travellingInsideAnObject (raytracer.cpp:77-78): only dielectrics
    # raise the medium above vacuum
    inside = medium > 1.00001 if st.has_dielectric else no

    # path tracing: the sampled GI bounce (raytracer.cpp:135-191)
    skip_ml = torch.full((r,), -1, dtype=torch.int64, device=dev)
    if opts.path_tracing:
        if opts.russian_roulette:
            # amax splits its gradient among ties as jnp.max does
            prob = clip(w.amax(dim=-1), 1e-4, 1.0)
            kill = (draws.uniform(it, rng.SITE_RR, r)[:, 0] > prob) & (depth <= 0)
            gi_alive = active & ~kill & (depth > -RR_DEPTH_FLOOR)
            rr_scale = torch.where(depth <= 0, 1.0 / prob, 1.0)
        else:
            gi_alive = active & (depth > 0)
            rr_scale = torch.ones(r, device=dev)
        r12 = draws.uniform(it, rng.SITE_GI, r, 2)
        phi = 2.0 * PI * r12[:, 0]
        if opts.importance_sampling:
            theta = torch.asin(torch.sqrt(r12[:, 1]))
        else:
            theta = torch.acos(r12[:, 1])
        u_b, v_b = orthonormal_basis(n)
        # eps guard: dead and miss lanes may carry a zero normal
        gi_dir = normalize(
            u_b * (torch.sin(theta) * torch.cos(phi))[:, None]
            + n * torch.cos(theta)[:, None]
            + v_b * (torch.sin(theta) * torch.sin(phi))[:, None], eps=1e-20)
        gi_o = p + n * GI_EPS
        gi_hit = closest_hit(pack, gi_o, gi_dir, time,
                             differentiable=opts.differentiable)
        # NEE double-count suppression: if the GI ray hits an emissive mesh
        # light, the parent's direct sampling skips it
        # (raytracer.cpp:180-188, 778-781)
        if st.n_mesh_lights > 0:
            gi_ent = gi_hit.index.clamp(0, max(st.n_entities - 1, 0))
            gi_em = (gi_hit.valid & (gi_hit.kind == KIND_TRI)
                     & pack.ent_emissive[gi_ent])
            skip_ml = torch.where(gi_alive & gi_em,
                                  pack.ent_mlight[gi_ent].long(), -1)
        gi_w = (w * shade_weight(pack, surf, gi_dir, w_o, mr) * (2.0 * PI)
                * rr_scale[:, None])
        if not opts.stochastic_spec_gi:
            stack = _push(stack, gi_alive & gi_hit.valid, gi_o, gi_dir, gi_w,
                          zeros3, medium, depth - 1, no)

    # ambient + direct lighting (raytracer.cpp:98-108)
    if (not opts.path_tracing) or opts.next_event_estimation:
        lit = active & ~inside
        contrib = pack.ambient_light * mr.ambient
        if (st.n_point + st.n_area + st.n_env + st.n_directional + st.n_spot
                + st.n_mesh_lights) > 0:
            contrib = contrib + direct_lighting(
                pack, surf, w_o, time, draws, it, skip_ml, mat_rows=mr,
                differentiable=opts.differentiable)
        L = L + torch.where(lit[:, None], w * contrib, 0.0)

    can_recurse = depth > 0

    # specular children: mirror, conductor and dielectric exclude each
    # other per material, so every reflection-like child (mirror
    # 442-472, conductor 208-254, dielectric TIR 292-311 and partial
    # reflection 326-356) is one masked push; the refraction leg
    # (358-410) the second
    any_reflect = no
    refl_o, refl_d, refl_w = p, w_o, w
    refl_absorb = zeros3
    refl_medium = torch.ones(r, device=dev)
    refl_env = no

    if st.has_mirror or st.has_conductor:
        w_rn = _reflect_rough(n, w_o, rough, psi(rng.SITE_ROUGH_M))

    if st.has_mirror:
        is_mirror = active & (mtype == _MIRROR) & can_recurse
        any_reflect = any_reflect | is_mirror
        mm = is_mirror[:, None]
        refl_o = torch.where(mm, p + n * eps, refl_o)
        refl_d = torch.where(mm, w_rn, refl_d)
        refl_w = torch.where(mm, w * mr.mirror, refl_w)
        # a mirror's miss samples the env light (461-469)
        if st.has_env:
            refl_env = refl_env | is_mirror

    if st.has_conductor:
        cos_t = dot(w_o, n)
        n2, k2 = mr.ior, mr.cond_k
        n2k2 = n2 * n2 + k2 * k2
        two_n2cos = 2.0 * n2 * cos_t
        cos2 = cos_t * cos_t
        rs = (n2k2 - two_n2cos + cos2) / maximum(n2k2 + two_n2cos + cos2, 1e-20)
        rp = (n2k2 * cos2 - two_n2cos + 1.0) / maximum(
            n2k2 * cos2 + two_n2cos + 1.0, 1e-20)
        ratio = 0.5 * (rs + rp)
        is_cond = (active & (mtype == _CONDUCTOR) & can_recurse
                   & (ratio > 1e-4))
        any_reflect = any_reflect | is_cond
        cm = is_cond[:, None]
        refl_o = torch.where(cm, p + n * eps, refl_o)
        refl_d = torch.where(cm, w_rn, refl_d)
        refl_w = torch.where(cm, w * mr.mirror * ratio[:, None], refl_w)
        # a conductor's miss adds nothing (242-247)

    if st.has_dielectric:
        is_diel = mtype == _DIELECTRIC
        cos0 = -dot(d, n)
        entering = cos0 > 0.0
        n_mod = torch.where(entering[:, None], n, -n)
        cos_i = cos0.abs()
        n1 = torch.where(entering, medium, mr.ior)
        n2d = torch.where(entering, mr.ior, 1.0)
        obj_n = torch.where(entering, mr.ior, 1.0)
        ratio_n = n1 / maximum(n2d, 1e-20)
        sin2 = 1.0 - cos_i * cos_i
        crit = ratio_n * ratio_n * sin2
        tir = crit > 1.0
        mat_abs = mr.absorption
        w_rd = _reflect_rough(n_mod, w_o, rough, psi(rng.SITE_ROUGH_T))

        # TIR: reflect only, weight 1, the medium kept (292-311)
        is_tir = active & is_diel & tir & can_recurse
        any_reflect = any_reflect | is_tir
        tm = is_tir[:, None]
        refl_o = torch.where(tm, p + n_mod * eps, refl_o)
        refl_d = torch.where(tm, w_rd, refl_d)
        refl_w = torch.where(tm, w, refl_w)
        refl_absorb = torch.where(tm & (medium > 1.0001)[:, None], mat_abs,
                                  refl_absorb)
        refl_medium = torch.where(is_tir, medium, refl_medium)

        # partial reflection (313-356); both children take objN as medium.
        # sqrt' is infinite at 0: TIR lanes get a safe argument, else
        # 0 * inf = NaN reaches the gradient through the masked selects
        cos_p = torch.sqrt(torch.where(tir, 1.0, maximum(1.0 - crit, 1e-20)))
        cos_p = torch.where(tir, 0.0, cos_p)
        n2cos = n2d * cos_i
        n1cosp = n1 * cos_p
        rpar = (n2cos - n1cosp) / maximum(n2cos + n1cosp, 1e-20)
        rperp = (n1 * cos_i - n2d * cos_p) / maximum(n1 * cos_i + n2d * cos_p,
                                                      1e-20)
        r_refl = 0.5 * (rpar * rpar + rperp * rperp)
        r_refr = 1.0 - r_refl
        child_medium = obj_n

        is_rl = active & is_diel & ~tir & can_recurse
        refr_dir = ((d + n_mod * cos_i[:, None]) * ratio_n[:, None]
                    - n_mod * cos_p[:, None])
        refr_dir = _perturb_dir(refr_dir, rough, psi(rng.SITE_ROUGH_F))
        absorb_rf = torch.where((child_medium > 1.001)[:, None], mat_abs, 0.0)

        any_reflect = any_reflect | is_rl
        if opts.stochastic_dielectric:
            # one leg: reflect with probability r_refl, else refract; the
            # Fresnel weight cancels against the choice's probability
            choose_refl = draws.uniform(it, rng.SITE_REFL, r)[:, 0] < r_refl
            fm = (is_rl & choose_refl)[:, None]
            refl_o = torch.where(fm, p + n_mod * eps, refl_o)
            refl_d = torch.where(fm, w_rd, refl_d)
            refl_w = torch.where(fm, w, refl_w)
            refl_absorb = torch.where(fm & (child_medium > 1.00001)[:, None],
                                      mat_abs, refl_absorb)
            gm = (is_rl & ~choose_refl)[:, None]
            refl_o = torch.where(gm, p - n_mod * eps, refl_o)
            refl_d = torch.where(gm, refr_dir, refl_d)
            refl_w = torch.where(gm, w, refl_w)
            refl_absorb = torch.where(gm, absorb_rf, refl_absorb)
        else:
            rm = is_rl[:, None]
            refl_o = torch.where(rm, p + n_mod * eps, refl_o)
            refl_d = torch.where(rm, w_rd, refl_d)
            refl_w = torch.where(rm, w * r_refl[:, None], refl_w)
            refl_absorb = torch.where(rm & (child_medium > 1.00001)[:, None],
                                      mat_abs, refl_absorb)
        refl_medium = torch.where(is_rl, child_medium, refl_medium)
        if st.has_env:
            refl_env = refl_env | is_rl

    if opts.path_tracing and opts.stochastic_spec_gi:
        # one child: where a GI and a specular child both exist, a fair
        # coin picks one and its weight doubles
        gi_would = gi_alive & gi_hit.valid
        spec_would = any_reflect if any_specular else no
        both = gi_would & spec_would
        choose_gi = draws.uniform(it, rng.SITE_COIN, r)[:, 0] < 0.5
        two = torch.where(both, 2.0, 1.0)[:, None]
        stack = _push(stack, gi_would & (~spec_would | choose_gi), gi_o, gi_dir,
                      gi_w * two, zeros3, medium, depth - 1, no)
        if any_specular:
            stack = _push(stack, spec_would & (~gi_would | ~choose_gi), refl_o,
                          refl_d, refl_w * two, refl_absorb, refl_medium,
                          depth - 1, refl_env)
    elif any_specular:
        stack = _push(stack, any_reflect, refl_o, refl_d, refl_w, refl_absorb,
                      refl_medium, depth - 1, refl_env)

    if st.has_dielectric and not opts.stochastic_dielectric:
        # the deterministic split's refraction leg is a second child
        # (358-410)
        stack = _push(stack, is_rl, p - n_mod * eps, refr_dir,
                      w * r_refr[:, None], absorb_rf, child_medium, depth - 1,
                      torch.full((r,), bool(st.has_env), device=dev))
    return L, stack


def primary_miss_color(pack, cam, px, py, d):
    """The radiance of a primary ray that hits nothing (raytracer.cpp:
    49-62): the background texture at the pixel's UV, else the environment
    light, else the flat background colour."""
    st = pack.static
    r = px.shape[0]
    if st.bg_tex >= 0:
        uv = torch.stack([div(px, float(cam.width)), div(py, float(cam.height))],
                         dim=-1)
        ti = torch.full((r,), st.bg_tex, dtype=torch.int64, device=px.device)
        return _sample_tex_rgb(pack, ti, uv)
    if st.has_env:
        return env_sample_radiance(pack, d)
    return pack.bg_color.expand(r, 3)


def trace_radiance(pack, cam, px, py, draws, opts: RenderOptions):
    """The radiance (R,3) of primary rays through (fractional) pixel
    coordinates px, py (R,): PerPixel (src/raytracer.cpp:38-63) with the
    thin lens of a DoF camera and the motion-blur time, the primary miss's
    background, then the shading tree.  ``draws`` is the draw source
    (``ops/rng.py``) of these rays; it is moved to their device."""
    st = pack.static
    r, dev = px.shape[0], px.device
    draws = draws.to(dev)
    time = (draws.uniform(-1, rng.SITE_TIME, r)[:, 0] if st.has_motion
            else torch.zeros(r, dtype=torch.float32, device=dev))
    lens = (draws.uniform(-1, rng.SITE_LENS, r, 2, lo=-1.0, hi=1.0)
            if cam.use_dof else None)
    o, d = generate_rays(cam, px, py, lens, dof=cam.use_dof)
    miss_col = primary_miss_color(pack, cam, px, py, d)

    stack = _make_stack(r, stack_size(st, opts), dev)
    ones = torch.ones(r, dtype=torch.bool, device=dev)
    stack = _push(stack, ones, o, d, torch.ones((r, 3), device=dev),
                  torch.zeros((r, 3), device=dev), torch.ones(r, device=dev),
                  torch.full((r,), opts.max_depth, dtype=torch.int64, device=dev),
                  ~ones, primary=ones)
    L = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    max_iters = opts.auto_iters(branching=branches(st, opts)) + 1
    for it in range(max_iters):
        if not bool((stack.sp > 0).any()):
            break
        stack, active, (eo, ed, ew, eabs, emed, edep, eenv, eprim) = _pop(stack)
        hit = closest_hit(pack, eo, ed, time, differentiable=opts.differentiable)
        hit = hit._replace(valid=hit.valid & active)
        # a primary miss sees the background; a secondary one the env light
        # where its branch samples it, else nothing
        missed = active & ~hit.valid
        L = L + torch.where((missed & eprim)[:, None], ew * miss_col, 0.0)
        if st.has_env:
            L = L + torch.where((missed & ~eprim & eenv)[:, None],
                                ew * env_sample_radiance(pack, ed), 0.0)
        L, stack = _process_hit(pack, opts, eo, ed, ew, eabs, emed, edep, time,
                                draws, it, hit, L, stack)
    return L
