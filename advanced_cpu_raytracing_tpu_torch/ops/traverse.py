"""Scene-level closest-hit and occlusion queries of the wavefront
integrator (the JAX package's ``ops/traverse.py``).

Two strategies, chosen at pack time (``StaticInfo.use_bvh``):

* **brute** (at most 2,048 work items): every ray against every
  world-space work item, through kernel K3 (``ops/tri_intersect.py``; its
  plain version on the CPU), motion scenes included: K3 takes the items'
  motion rows and the rays' times, where the JAX package falls back to a
  jnp broadcast.  Shadow queries sweep ``ws_v*``, the non-emissive items.
* **bvh** (larger scenes): per entity, the rays go to object space and a
  ray-batched walk of the entity's BVH (BVH::IntersectBVH,
  src/bvh.cpp:5-31: AABB reject at node entry, leaves test their face
  range, interiors push both children), a loop over the rays still on
  their stack with a stack tensor per ray.  Plain torch: the JAX package
  writes it in jnp too.

Occlusion mirrors Raytracer::CastShadowRay (src/raytracer.cpp:585-623):
triangles of emissive (light-mesh) entities are skipped, spheres are not;
a hit counts where ``t < light_t``.

With ``differentiable=True`` the winner is chosen on detached rays by the
fast path and (t, beta, gamma) are recomputed differentiably on the
winning triangle in its entity's object space (``_tri_recompute``), so
gradients reach the rays and ``pack.verts``; which primitive wins, and
occlusion, contribute none (diff/params.py).  The topology comes from the
items frozen at pack time (``wi_v*``), as in the JAX wavefront.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from advanced_cpu_raytracing_tpu_torch.ops.intersect import (
    ray_aabb,
    ray_sphere,
    ray_triangle,
    transform_ray,
)
from advanced_cpu_raytracing_tpu_torch.ops.tri_intersect import tri_closest_hit

INF = float("inf")
KIND_NONE, KIND_TRI, KIND_SPHERE = -1, 0, 1


class Hit(NamedTuple):
    t: torch.Tensor  # (R,)
    valid: torch.Tensor  # (R,) bool
    kind: torch.Tensor  # (R,) -1 none / 0 tri / 1 sphere
    index: torch.Tensor  # (R,) entity index (tri) or sphere index
    face: torch.Tensor  # (R,) global face index (tri only)
    beta: torch.Tensor  # (R,)
    gamma: torch.Tensor  # (R,)


def _empty_hit(n: int, dev) -> Hit:
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    return Hit(torch.full((n,), INF, device=dev),
               torch.zeros(n, dtype=torch.bool, device=dev),
               torch.full((n,), KIND_NONE, dtype=torch.int64, device=dev),
               zi, zi, z, z)


# --------------------------------------------------------------------------
# triangles: brute force through K3
# --------------------------------------------------------------------------


def _brute_tri_best(pack, o, d, time, skip_emissive: bool):
    """The nearest work item per ray through K3: (t, ent, face, beta,
    gamma, valid).  Shadow queries (``skip_emissive``) sweep the
    non-emissive items, which lost the entity/face mapping: they return
    the item index in both places (JAX traverse.py:104-114)."""
    st = pack.static
    o, d = o.contiguous(), d.contiguous()
    mo = {}
    if st.has_motion:
        mo = dict(motion=(pack.ws_motion if skip_emissive else pack.wi_motion),
                  time=time.contiguous())
    if skip_emissive:
        t, idx, beta, gamma = tri_closest_hit(o, d, pack.ws_v0, pack.ws_v1,
                                              pack.ws_v2, **mo)
        valid = idx >= 0
        idx0 = idx.clamp(min=0).long()
        return t, idx0, idx0, beta, gamma, valid
    t, idx, beta, gamma = tri_closest_hit(o, d, pack.wi_v0, pack.wi_v1,
                                          pack.wi_v2, **mo)
    valid = idx >= 0
    idx0 = idx.clamp(min=0).long()
    return (t, pack.wi_ent[idx0].long(), pack.wi_face[idx0].long(), beta,
            gamma, valid)


# --------------------------------------------------------------------------
# triangles: BVH walk
# --------------------------------------------------------------------------


def _bvh_entity_best(pack, ent: int, o, d, time, t0):
    """Walk entity ``ent``'s BVH for every ray, starting from the best t
    so far ``t0``: returns (t, face, beta, gamma), t == t0 and face -1
    where nothing nearer was hit (JAX traverse.py:151-219)."""
    st = pack.static
    dev = o.device
    n = o.shape[0]
    o_l, d_l = transform_ray(pack.ent_minv[ent], o, d)
    if st.has_motion:
        o_l = o_l + pack.ent_motion[ent][None, :] * time[:, None]
    verts, vidx = pack.verts, pack.tri_vidx.long()
    node_min, node_max = pack.node_min, pack.node_max
    node_left, node_right = pack.node_left.long(), pack.node_right.long()
    node_first, node_count = pack.node_first.long(), pack.node_count.long()
    max_leaf = int(node_count.max())
    stack = torch.zeros((n, st.bvh_max_depth + 2), dtype=torch.int64, device=dev)
    stack[:, 0] = int(pack.ent_root[ent])
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    t_best = t0.clone()
    f_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    b_best = torch.zeros(n, dtype=torch.float32, device=dev)
    g_best = torch.zeros(n, dtype=torch.float32, device=dev)
    while True:
        a = torch.nonzero(sp > 0).squeeze(1)
        if a.numel() == 0:
            break
        sp[a] -= 1
        node = stack[a, sp[a]]
        oa, da = o_l[a], d_l[a]
        hit_box = ray_aabb(oa, da, node_min[node], node_max[node], t_best[a])
        left = node_left[node]
        is_leaf = left < 0
        # leaf: its face range in order (bvh.cpp:13-20)
        count = torch.where(hit_box & is_leaf, node_count[node], 0)
        first = node_first[node]
        for k in range(max_leaf):
            m = torch.nonzero(count > k).squeeze(1)
            if m.numel() == 0:
                break
            rows = a[m]
            f = first[m] + k
            vi = vidx[f]
            t, beta, gamma, valid = ray_triangle(
                oa[m], da[m], verts[vi[:, 0]], verts[vi[:, 1]], verts[vi[:, 2]])
            better = valid & (t < t_best[rows])
            rows, f = rows[better], f[better]
            t_best[rows] = t[better]
            f_best[rows] = f
            b_best[rows] = beta[better]
            g_best[rows] = gamma[better]
        # interior: push left, then right (bvh.cpp:22-27)
        push = hit_box & ~is_leaf
        rows = a[push]
        stack[rows, sp[rows]] = left[push]
        sp[rows] += 1
        stack[rows, sp[rows]] = node_right[node[push]]
        sp[rows] += 1
    return t_best, f_best, b_best, g_best


def _bvh_tri_best(pack, o, d, time, skip_emissive: bool):
    st = pack.static
    n, dev = o.shape[0], o.device
    t_best = torch.full((n,), INF, device=dev)
    ent_best = torch.zeros(n, dtype=torch.int64, device=dev)
    face_best = torch.zeros(n, dtype=torch.int64, device=dev)
    b_best = torch.zeros(n, dtype=torch.float32, device=dev)
    g_best = torch.zeros(n, dtype=torch.float32, device=dev)
    emissive = pack.ent_emissive.cpu()
    for e in range(st.n_entities):
        if skip_emissive and bool(emissive[e]):
            continue  # JAX walks it and masks the update: the same
        t_e, f_e, b_e, g_e = _bvh_entity_best(pack, e, o, d, time, t_best)
        better = t_e < t_best
        t_best = torch.where(better, t_e, t_best)
        ent_best = torch.where(better, e, ent_best)
        face_best = torch.where(better, f_e, face_best)
        b_best = torch.where(better, b_e, b_best)
        g_best = torch.where(better, g_e, g_best)
    return t_best, ent_best, face_best, b_best, g_best, t_best < INF


# --------------------------------------------------------------------------
# spheres
# --------------------------------------------------------------------------


def _sphere_best(pack, o, d, time):
    """Nearest sphere per ray (Sphere::Intersect, src/sphere.cpp:13-80):
    (t, index, valid); ties go to the lowest index."""
    st = pack.static
    o_l, d_l = transform_ray(pack.sph_minv[:, None], o[None], d[None])
    if st.has_motion:
        o_l = o_l + pack.sph_motion[:, None, :] * time[None, :, None]
    t, valid = ray_sphere(o_l, d_l, pack.sph_center[:, None, :],
                          pack.sph_radius[:, None])
    t = torch.where(valid, t, INF)
    best = torch.argmin(t, dim=0)
    t_best = t.gather(0, best[None])[0]
    return t_best, best, t_best < INF


# --------------------------------------------------------------------------
# public queries
# --------------------------------------------------------------------------


def _tri_recompute(pack, o, d, time, ent, face):
    """Differentiable (t, beta, gamma) on each ray's winning triangle, in
    its entity's object space (Mesh::Intersect, src/mesh.cpp:161-170), so
    gradients reach the rays and ``pack.verts``."""
    o_l, d_l = transform_ray(pack.ent_minv[ent], o, d)
    if pack.static.has_motion:
        o_l = o_l + pack.ent_motion[ent] * time[:, None]
    vi = pack.tri_vidx[face].long()
    t, beta, gamma, _ = ray_triangle(o_l, d_l, pack.verts[vi[:, 0]],
                                     pack.verts[vi[:, 1]], pack.verts[vi[:, 2]])
    return t, beta, gamma


def _tri_best(pack, o, d, time, skip_emissive: bool):
    if pack.static.use_bvh:
        return _bvh_tri_best(pack, o, d, time, skip_emissive)
    return _brute_tri_best(pack, o, d, time, skip_emissive)


def closest_hit(pack, o, d, time=None, skip_emissive: bool = False,
                differentiable: bool = False) -> Hit:
    """Closest intersection along each ray (IntersectObjects,
    src/raytracer.cpp:625-643)."""
    st = pack.static
    n, dev = o.shape[0], o.device
    if time is None:
        time = torch.zeros(n, dtype=torch.float32, device=dev)
    hit = _empty_hit(n, dev)
    if st.n_faces > 0 and st.n_entities > 0:
        if differentiable:
            with torch.no_grad():
                _, ent, face, _, _, v_tri = _tri_best(
                    pack, o.detach(), d.detach(), time.detach(), skip_emissive)
            t_r, b_r, g_r = _tri_recompute(pack, o, d, time, ent, face)
            # misses gathered rows of item 0: masked at the source so no
            # cotangent reaches them
            t_tri = torch.where(v_tri, t_r, INF)
            beta = torch.where(v_tri, b_r, 0.0)
            gamma = torch.where(v_tri, g_r, 0.0)
        else:
            t_tri, ent, face, beta, gamma, v_tri = _tri_best(
                pack, o, d, time, skip_emissive)
        hit = Hit(t=torch.where(v_tri, t_tri, hit.t),
                  valid=hit.valid | v_tri,
                  kind=torch.where(v_tri, KIND_TRI, hit.kind),
                  index=torch.where(v_tri, ent, hit.index),
                  face=torch.where(v_tri, face, hit.face),
                  beta=torch.where(v_tri, beta, hit.beta),
                  gamma=torch.where(v_tri, gamma, hit.gamma))
    if st.n_spheres > 0:
        t_s, idx_s, v_s = _sphere_best(pack, o, d, time)
        closer = v_s & (t_s < hit.t)
        hit = hit._replace(t=torch.where(closer, t_s, hit.t),
                           valid=hit.valid | closer,
                           kind=torch.where(closer, KIND_SPHERE, hit.kind),
                           index=torch.where(closer, idx_s, hit.index))
    return hit


def occluded(pack, o, d, light_t, time=None,
             differentiable: bool = False) -> torch.Tensor:
    """True where something (non-emissive, for meshes) blocks the segment
    to the light (IsInShadow, src/raytracer.cpp:567-583).  Boolean, so a
    pure topology query: ``differentiable`` detaches its inputs."""
    st = pack.static
    n, dev = o.shape[0], o.device
    if time is None:
        time = torch.zeros(n, dtype=torch.float32, device=dev)
    with torch.no_grad():
        if differentiable:
            o, d, light_t, time = (x.detach() for x in (o, d, light_t, time))
        blocked = torch.zeros(n, dtype=torch.bool, device=dev)
        if st.n_faces > 0 and st.n_entities > 0:
            t_tri, _, _, _, _, v = _tri_best(pack, o, d, time, True)
            blocked = blocked | (v & (t_tri < light_t))
        if st.n_spheres > 0:
            t_s, _, v_s = _sphere_best(pack, o, d, time)
            blocked = blocked | (v_s & (t_s < light_t))
    return blocked
