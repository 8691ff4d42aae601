"""The reference's ray queries: closest hit and shadow over triangles and
spheres, in plain torch.

Each mesh's faces are grouped into clusters of ``CLUSTER`` faces in the
Morton order of their centroids (worked out here from the vertices), and a
query tests every cluster box, then every face of each cluster it enters.
Whatever the cluster order, the answer is that of a brute-force sweep: the
nearest face at 0 < t < t_max, the lowest face index among equal t, then a
sphere that is strictly nearer.  The face test is Cramer's rule
(Mesh::IntersectFace, mesh.cpp:201-236) and the sphere's the quadratic
(Sphere::Intersect, sphere.cpp:31-72), in the tensors' dtype.

``Counts`` keeps the queries made, which the roofline files read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

BIG = 3.0e37
CLUSTER = 32
PAIR_BLOCK = 1 << 18  # (ray, cluster) pairs tested at once
RAY_BLOCK = 1 << 13  # rays slab-tested against every cluster at once


@dataclass
class Counts:
    closest: int = 0  # closest-hit queries (rays)
    shadow: int = 0  # shadow queries (rays)

    def add(self, kind: str, n: int):
        setattr(self, kind, getattr(self, kind) + int(n))


def dot3(a, b):
    """Row-wise dot product of (..., 3) tensors, summed x + y + z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _morton(c: np.ndarray) -> np.ndarray:
    lo, hi = c.min(0), c.max(0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return code


def clusters(verts: np.ndarray, faces: np.ndarray, spans) -> np.ndarray:
    """(C, CLUSTER) int64 face indices, -1 for padding: each mesh's faces
    in the Morton order of their centroids, cut into clusters."""
    out = []
    for first, count in spans:
        f = np.arange(first, first + count)
        cen = verts[faces[f]].astype(np.float64).mean(1)
        f = f[np.argsort(_morton(cen), kind="stable")]
        pad = -len(f) % CLUSTER
        out.append(np.concatenate([f, np.full(pad, -1)]).reshape(-1, CLUSTER))
    return np.concatenate(out)


class Geometry:
    """The scene's faces (world vertices ``tri9`` (F, 9)) and spheres
    (``sph`` (S, 4): center, radius) on one device in one dtype."""

    def __init__(self, tri9: torch.Tensor, groups: torch.Tensor,
                 sph: torch.Tensor, counts: Counts | None = None):
        dt, dev = tri9.dtype, tri9.device
        self.groups = groups.to(dev)
        pad = torch.zeros((1, 9), dtype=dt, device=dev)
        self.tri = torch.cat([tri9, pad])  # row F: the padding, det 0
        g = torch.where(self.groups >= 0, self.groups, tri9.shape[0])
        self.gidx = g
        v = self.tri[g].reshape(g.shape[0], CLUSTER * 3, 3)
        real = (self.groups >= 0).repeat_interleave(3, 1)[..., None]
        inf = torch.tensor(float("inf"), dtype=dt, device=dev)
        self.lo = torch.where(real, v, inf).amin(1)  # (C, 3)
        self.hi = torch.where(real, v, -inf).amax(1)
        self.sph = sph
        self.counts = counts if counts is not None else Counts()

    def _pairs(self, o, d, t_max):
        """(ray, cluster) pairs whose box the ray enters below t_max."""
        inv = 1.0 / d
        rays, cl = [], []
        for a in range(0, o.shape[0], RAY_BLOCK):
            b = min(a + RAY_BLOCK, o.shape[0])
            t1 = (self.lo[None] - o[a:b, None]) * inv[a:b, None]
            t2 = (self.hi[None] - o[a:b, None]) * inv[a:b, None]
            t1 = torch.nan_to_num(t1, nan=-float("inf"))
            t2 = torch.nan_to_num(t2, nan=float("inf"))
            tmin = torch.minimum(t1, t2).amax(2)
            tmax = torch.maximum(t1, t2).amin(2)
            ok = (tmax > 0) & (tmax >= tmin) & (tmin < t_max[a:b, None])
            r, c = ok.nonzero(as_tuple=True)
            rays.append(r + a)
            cl.append(c)
        return torch.cat(rays), torch.cat(cl)

    def _tests(self, o, d, t_max, rays, cl):
        """Per pair block: (t (P, CLUSTER), hit (P, CLUSTER), face ids)."""
        for a in range(0, rays.shape[0], PAIR_BLOCK):
            r = rays[a:a + PAIR_BLOCK]
            g = self.gidx[cl[a:a + PAIR_BLOCK]]
            v = self.tri[g]  # (P, CLUSTER, 9)
            p, dv = o[r][:, None], d[r][:, None]
            v0x, v0y, v0z = v[..., 0], v[..., 1], v[..., 2]
            e1x, e1y, e1z = v0x - v[..., 3], v0y - v[..., 4], v0z - v[..., 5]
            e2x, e2y, e2z = v0x - v[..., 6], v0y - v[..., 7], v0z - v[..., 8]
            px, py, pz = p[..., 0], p[..., 1], p[..., 2]
            vx, vy, vz = dv[..., 0], dv[..., 1], dv[..., 2]
            bx, by, bz = v0x - px, v0y - py, v0z - pz
            m0 = e2y * vz - vy * e2z
            m1 = e2x * vz - vx * e2z
            m2 = e2x * vy - vx * e2y
            det = e1x * m0 - e1y * m1 + e1z * m2
            safe = torch.where(det == 0, torch.ones_like(det), det)
            q0 = e2y * bz - by * e2z
            q1 = e2x * bz - bx * e2z
            q2 = e2x * by - bx * e2y
            t = (e1x * q0 - e1y * q1 + e1z * q2) / safe
            beta = (bx * m0 - by * m1 + bz * m2) / safe
            n0 = by * vz - vy * bz
            n1 = bx * vz - vx * bz
            n2 = bx * vy - vx * by
            gamma = (e1x * n0 - e1y * n1 + e1z * n2) / safe
            hit = ((det != 0) & (t > 0) & (t < t_max[r][:, None])
                   & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1))
            yield r, t, hit, g

    def _spheres(self, o, d):
        """(t (R, S), valid (R, S), unnormalised normal (R, S, 3))."""
        c = self.sph[:, 0:3][None]
        rad = self.sph[:, 3][None]
        dl = d[:, None].expand(-1, self.sph.shape[0], -1)
        oc = o[:, None] - c
        a = dot3(dl, dl)
        b = 2.0 * dot3(dl, oc)
        cc = dot3(oc, oc) - rad * rad
        delta = b * b - 4.0 * a * cc
        sq = torch.sqrt(torch.clamp(delta, min=0))
        denom = torch.where(a > 0, 2.0 * a, torch.ones_like(a))
        t1 = (-b + sq) / denom
        t2 = (-b - sq) / denom
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t = torch.where(lo > 0, lo, hi)
        valid = (delta >= 0) & (t > 0) & (a > 0)
        return t, valid, oc + t[..., None] * dl

    def closest(self, o, d):
        """(t (R,), face (R,) or -1, sphere (R,) or -1, sphere normal
        (R, 3) unnormalised) of rays o, d (R, 3)."""
        n = o.shape[0]
        dev = o.device
        self.counts.add("closest", n)
        t_max = torch.full((n,), BIG, dtype=o.dtype, device=dev)
        key = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                         device=dev)
        if self.groups.shape[0]:
            rays, cl = self._pairs(o, d, t_max)
            for r, t, hit, g in self._tests(o, d, t_max, rays, cl):
                tb = t.float().view(torch.int32).to(torch.int64)  # t > 0
                k = torch.where(hit, (tb << 32) | g, key.new_tensor(
                    torch.iinfo(torch.int64).max))
                key.scatter_reduce_(0, r, k.amin(1), reduce="amin")
        found = key != torch.iinfo(torch.int64).max
        face = torch.where(found, key & 0xFFFFFFFF, -1)
        tb = torch.where(found, (key >> 32).to(torch.int32).view(
            torch.float32).to(o.dtype), torch.full_like(t_max, BIG))
        sph = torch.full((n,), -1, dtype=torch.int64, device=dev)
        nrm = torch.zeros((n, 3), dtype=o.dtype, device=dev)
        if self.sph.shape[0]:
            ts, vs, ns = self._spheres(o, d)
            for s in range(self.sph.shape[0]):
                win = vs[:, s] & (ts[:, s] < tb)
                tb = torch.where(win, ts[:, s], tb)
                sph = torch.where(win, s, sph)
                nrm = torch.where(win[:, None], ns[:, s], nrm)
        face = torch.where(sph >= 0, -1, face)
        return tb, face, sph, nrm

    def blocked(self, o, d, limit):
        """(R,) bool: something at 0 < t < limit along rays o, d."""
        n = o.shape[0]
        self.counts.add("shadow", n)
        out = torch.zeros(n, dtype=torch.bool, device=o.device)
        if self.groups.shape[0]:
            rays, cl = self._pairs(o, d, limit)
            for r, _, hit, _ in self._tests(o, d, limit, rays, cl):
                out[r[hit.any(1)]] = True
        if self.sph.shape[0]:
            ts, vs, _ = self._spheres(o, d)
            out |= (vs & (ts < limit[:, None])).any(1)
        return out
