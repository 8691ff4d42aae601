"""The dense closest hit (K3): every ray against every work item.

It replaces the JAX package's Pallas kernel
``ops/pallas/tri_intersect.py::_kernel`` (launched by
``tri_closest_hit_pallas``), the wavefront integrator's brute-force
closest-hit and shadow query for scenes of at most 2,048 work items
(``scene/pack.py::BRUTE_FORCE_MAX_ITEMS``).  ``tri_closest_hit`` launches
``csrc/tri_intersect.cu`` for CUDA tensors and runs the plain version,
``tri_closest_hit_ref``, for CPU tensors.  Both compute the TPU kernel's
arithmetic (tri_intersect.py:58-88) in its order: e1 = v0 - v1,
e2 = v0 - v2, b = v0 - o, the determinant's cross terms, beta, gamma and
t by three IEEE divisions by the guarded determinant; a hit is valid where
det != 0, beta >= 0, gamma >= 0, beta + gamma <= 1 and t > 0, and the
nearest wins strictly in ascending item order, so ties go to the lowest
index.  Where nothing is hit, t is +inf and the index -1.

Beyond the TPU kernel, both take an optional motion row per item and a
time per ray: the origin of each test is then ``o + motion * time`` (the
JAX jnp route's ``ow``, ops/traverse.py:123-125), so motion scenes go
through the kernel too.

The kernel reads its items from ``item_table``, built once per call: 16
floats a row (v0, e1, e2, the motion row, padding), three 16-byte loads.
It rejects an item by an approximate reciprocal of the determinant before
any division, only where that provably cannot change the answer (the
argument is in the kernel's header), so it stays bit for bit equal to the
plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

BIG = 3.0e38  # the TPU kernel's "no hit" distance (_INF)
LIBRARY = "tri_intersect"
# launches of the CUDA kernel (only those count)
LAUNCHES = {"tri_intersect": 0}
# elements of the (items, rays) planes of one step of the plain version
_REF_ELEMS = 1 << 24


ITEM_COLS = 16  # item_table: v0 0:3, e1 3:6, e2 6:9, motion 9:12, padding


def item_table(v0, v1, v2, motion=None):
    """The kernel's (W, ITEM_COLS) item table: v0, e1 = v0 - v1,
    e2 = v0 - v2 (the TPU kernel's subtractions, tri_intersect.py:58-59),
    the motion row (zeros without motion) and four zeros of padding."""
    tab = torch.zeros((v0.shape[0], ITEM_COLS), dtype=torch.float32,
                      device=v0.device)
    tab[:, 0:3] = v0
    tab[:, 3:6] = v0 - v1
    tab[:, 6:9] = v0 - v2
    if motion is not None:
        tab[:, 9:12] = motion
    return tab


def tri_closest_hit_ref(o, d, v0, v1, v2, motion=None, time=None):
    """The plain version of K3: (t, idx, beta, gamma) for rays o, d (R,3)
    against items v0, v1, v2 (W,3); ``motion`` (W,3) with ``time`` (R,)
    moves each test's origin.  The items are swept in chunks: within one,
    the first minimum of the valid t; across chunks a strictly smaller t
    replaces the best, the fold of the kernel."""
    r, w = o.shape[0], v0.shape[0]
    dev = o.device
    e1 = v0 - v1
    e2 = v0 - v2
    t_best = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    i_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    b_best = torch.zeros(r, dtype=torch.float32, device=dev)
    g_best = torch.zeros(r, dtype=torch.float32, device=dev)
    ox, oy, oz = (o[:, k][None] for k in range(3))
    dx, dy, dz = (d[:, k][None] for k in range(3))
    step = max(1, _REF_ELEMS // max(r, 1))
    for lo in range(0, w, step):
        hi = min(lo + step, w)

        def col(x, k):
            return x[lo:hi, k][:, None]

        px, py, pz = ox, oy, oz
        if motion is not None:
            tau = time[None]
            px = ox + col(motion, 0) * tau
            py = oy + col(motion, 1) * tau
            pz = oz + col(motion, 2) * tau
        e1x, e1y, e1z = col(e1, 0), col(e1, 1), col(e1, 2)
        e2x, e2y, e2z = col(e2, 0), col(e2, 1), col(e2, 2)
        bx = col(v0, 0) - px
        by = col(v0, 1) - py
        bz = col(v0, 2) - pz
        m0 = e2y * dz - dy * e2z
        m1 = e2x * dz - dx * e2z
        m2 = e2x * dy - dx * e2y
        det = e1x * m0 - e1y * m1 + e1z * m2
        safe = torch.where(det == 0.0, 1.0, det)
        beta = (bx * m0 - by * m1 + bz * m2) / safe
        n0 = by * dz - dy * bz
        n1 = bx * dz - dx * bz
        n2 = bx * dy - dx * by
        gamma = (e1x * n0 - e1y * n1 + e1z * n2) / safe
        q0 = e2y * bz - by * e2z
        q1 = e2x * bz - bx * e2z
        q2 = e2x * by - bx * e2y
        t = (e1x * q0 - e1y * q1 + e1z * q2) / safe
        valid = ((det != 0.0) & (beta >= 0.0) & (gamma >= 0.0)
                 & (beta + gamma <= 1.0) & (t > 0.0))
        t = torch.where(valid, t, float("inf"))
        j = torch.argmin(t, dim=0, keepdim=True)
        tc = t.gather(0, j)[0]
        better = tc < t_best
        t_best = torch.where(better, tc, t_best)
        i_best = torch.where(better, (j[0] + lo).to(torch.int32), i_best)
        b_best = torch.where(better, beta.gather(0, j)[0], b_best)
        g_best = torch.where(better, gamma.gather(0, j)[0], g_best)
    t_best = torch.where(i_best < 0, float("inf"), t_best)
    return t_best, i_best, b_best, g_best


def tri_closest_hit(o, d, v0, v1, v2, motion=None, time=None):
    """(t, idx, beta, gamma) of the nearest valid item per ray (t +inf and
    idx -1 on a miss): CPU tensors run ``tri_closest_hit_ref``, CUDA
    tensors launch K3 or raise.  ``motion`` (W,3) and ``time`` (R,) go
    together.  ``LAUNCHES`` counts the kernel's launches."""
    if (motion is None) != (time is None):
        raise ValueError("tri_closest_hit: motion and time go together")
    if o.device.type == "cpu":
        return tri_closest_hit_ref(o, d, v0, v1, v2, motion, time)
    from advanced_cpu_raytracing_tpu_torch.ops import _build
    from advanced_cpu_raytracing_tpu_torch.ops.megakernel import _check, _ptr

    r, w = o.shape[0], v0.shape[0]
    _check("o", o, (r, 3))
    _check("d", d, (r, 3))
    for name, x in (("v0", v0), ("v1", v1), ("v2", v2)):
        _check(name, x, (w, 3))
    if motion is not None:
        _check("motion", motion, (w, 3))
        _check("time", time, (r,))
    devs = {x.device for x in (o, d, v0, v1, v2, *(
        () if motion is None else (motion, time)))}
    if len(devs) != 1:
        raise ValueError(f"tri_closest_hit: tensors on several devices {devs}")
    if w < 1:
        raise ValueError("tri_closest_hit: an empty item table")
    t = torch.empty(r, dtype=torch.float32, device=o.device)
    idx = torch.empty(r, dtype=torch.int32, device=o.device)
    beta = torch.empty(r, dtype=torch.float32, device=o.device)
    gamma = torch.empty(r, dtype=torch.float32, device=o.device)
    if r == 0:
        return t, idx, beta, gamma
    lib = _build.load(LIBRARY)
    items = item_table(v0, v1, v2, motion)
    tau = ctypes.c_void_p(None) if motion is None else _ptr(time)
    with torch.cuda.device(o.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream)
        rc = lib.tri_intersect_launch(_ptr(o), _ptr(d), _ptr(items), tau, r, w,
                                      _ptr(t), _ptr(idx), _ptr(beta),
                                      _ptr(gamma), stream)
    if rc != 0:
        err = lib.tri_intersect_error_string(rc).decode()
        raise RuntimeError(f"tri_intersect launch failed: CUDA error {rc} "
                           f"({err})")
    LAUNCHES["tri_intersect"] += 1
    return t, idx, beta, gamma


def edge_tables(n_rays: int, seed: int = 0, device=None) -> dict:
    """Tables at the edges of the kernel's rejection, for its checks on the
    card: name -> (o, d, v0, v1, v2, motion, time), numpy-made from
    ``seed`` (motion and time None but for the motion table).

    * ``vertices and edges``: rays aimed at a vertex, an edge's point or
      beside it, so beta, gamma and beta + gamma - 1 lie within rounding of
      0;
    * ``ties at t_best``: each triangle twice and coplanar overlapping
      triangles, so later items meet the best t exactly or within rounding;
    * ``scaled``: per item a scale 2^k, k in [-70, 70], on the edges and the
      offset of v0 from the ray, so determinants leave the trusted range,
      numerators go denormal and quotients underflow to -0 or overflow;
    * ``near-degenerate``: slivers and rays almost in the triangle's plane,
      det within a few ulps of 0, and det = 0;
    * ``motion``: the first table with a motion row per item and a time
      per ray."""
    g = np.random.default_rng(seed)
    w = 512

    def tri(w):
        v0 = g.uniform(-1.0, 1.0, (w, 3))
        return v0, v0 + g.uniform(-0.5, 0.5, (w, 3)), v0 + g.uniform(
            -0.5, 0.5, (w, 3))

    def aim(v0, v1, v2, n, spread):
        k = g.integers(0, v0.shape[0], n)
        b = g.choice([0.0, 0.5, 1.0], (n, 2))
        b[:, 1] = np.where(b[:, 0] == 1.0, 0.0, b[:, 1] * (1.0 - b[:, 0]))
        b[: n // 2] += g.normal(0.0, spread, (n // 2, 2))
        target = (v0[k] + b[:, :1] * (v1[k] - v0[k]) + b[:, 1:] * (v2[k]
                                                                   - v0[k]))
        o = target + g.normal(0.0, 1.0, (n, 3)) * np.float32(3.0)
        return o, target - o

    out = {}
    v0, v1, v2 = tri(w)
    o, d = aim(v0, v1, v2, n_rays, 1e-7)
    out["vertices and edges"] = (o, d, v0, v1, v2, None, None)
    a0, a1, a2 = tri(w // 2)
    c0 = np.concatenate([a0, a0])
    # the second half: the first's triangles again, and each first-half
    # triangle's plane cut otherwise (v0 kept, v1 and v2 moved in plane)
    c1 = np.concatenate([a1, a0 + 0.7 * (a1 - a0) + 0.2 * (a2 - a0)])
    c2 = np.concatenate([a2, a0 + 0.1 * (a1 - a0) + 0.9 * (a2 - a0)])
    c1[w // 2::3], c2[w // 2::3] = a1[::3], a2[::3]
    o, d = aim(a0, a1, a2, n_rays, 1e-3)
    out["ties at t_best"] = (o, d, c0, c1, c2, None, None)
    s = 2.0 ** g.integers(-70, 71, (w, 1))
    t0 = g.uniform(-1.0, 1.0, (w, 3)) * 2.0 ** g.integers(-110, 1, (w, 1))
    e1, e2 = g.uniform(-1.0, 1.0, (w, 3)) * s, g.uniform(-1.0, 1.0, (w, 3)) * s
    o = g.uniform(-1e-30, 1e-30, (n_rays, 3))
    d = g.normal(size=(n_rays, 3))
    out["scaled"] = (o, d, t0, t0 - e1, t0 - e2, None, None)
    v0, v1, v2 = tri(w)
    v2[::2] = v0[::2] + (v1[::2] - v0[::2]) * g.uniform(-2, 2, (w // 2, 1))
    v2[::4] += g.normal(0.0, 1e-7, (w // 4, 3))
    o, d = aim(v0, v1, v2, n_rays, 1e-2)
    k = g.integers(0, w, n_rays)
    nrm = np.cross(v1[k] - v0[k], v2[k] - v0[k])
    flat = np.cross(nrm, g.normal(size=(n_rays, 3)))
    d[::3] = (flat + g.normal(0.0, 1e-6, flat.shape) * np.linalg.norm(
        flat, axis=1, keepdims=True))[::3]
    out["near-degenerate"] = (o, d, v0, v1, v2, None, None)
    o, d, v0, v1, v2 = out["vertices and edges"][:5]
    out["motion"] = (o, d, v0, v1, v2, g.uniform(-0.05, 0.05, (w, 3)),
                     g.uniform(0.0, 1.0, n_rays))
    return {name: tuple(None if x is None else torch.as_tensor(
        np.ascontiguousarray(x, dtype=np.float32), device=device)
        for x in tab) for name, tab in out.items()}
