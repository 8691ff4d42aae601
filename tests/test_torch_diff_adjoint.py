"""The hand-derived adjoints of kernels K2a and K2b (csrc/mega_bwd.cu),
written here in torch as the kernel computes them, against torch autograd
of the plain version's forward formulas (ops/megabwd.py, and
ops/megakernel.py's GI direction) on random inputs.  The places where a
derivation goes wrong quietly: norm3's clamp, powmax, the Cramer t and its
det == 0 guard, the conductor's Fresnel ratio, refraction's square root on
refract lanes only, the sphere's root and normal; and K2b's: the GI
direction through the orthonormal basis (both sampling forms), the spot
light's cosine-space falloff, the area light's two-sided irradiance, the
mesh light's sampled point and the direction toward a light, and Russian
roulette's reweight through max (ties split) and the clip; and K2c's: the
barycentrics through the winner's vertices and the ray (beside Cramer's t),
uv from them, tile_uv's slope and the bilinear weights' through JAX's clip
(max then min: half at a tie).  In float64, so that a wrong term shows and
rounding does not: rtol 1e-9."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from advanced_cpu_raytracing_tpu_torch.ops import megabwd as mb
from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
from advanced_cpu_raytracing_tpu_torch.ops import texture as tex

F64 = torch.float64


def rand(rng, *shape, lo=-1.0, hi=1.0):
    return torch.tensor(rng.uniform(lo, hi, shape), dtype=F64)


def grads_of(fn, inputs, gout):
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, (list, tuple)) else [out]
    return torch.autograd.grad(out, leaves, gout, allow_unused=True)


def close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


# ---- the kernel's adjoints, transcribed ----

def norm3_vjp(x, gy):
    """``norm3_vjp``: gx = inv (gy - y (y . gy)) where |x|^2 > 1e-20."""
    s = (x * x).sum(0)
    inv = 1.0 / torch.sqrt(torch.clamp(s, min=1e-20))
    y = x * inv
    yg = (y * gy).sum(0)
    return torch.where(s > 1e-20, inv * (gy - y * yg), inv * gy)


def powmax_vjp(base, e, g):
    """``shade_unit_vjp``'s powmax: e val / base and val log(base) where
    base > 0, nothing elsewhere."""
    pos = base > 0
    safe = torch.where(pos, base, 1.0)
    val = torch.exp(e * torch.log(safe))
    return (torch.where(pos, g * e * val / safe, 0.0),
            torch.where(pos, g * val * torch.log(safe), 0.0))


def cramer_vjp(v, o, d, gt):
    """The kernel's Cramer adjoint: t = num / det, num = e1 . (e2 x b),
    det = e1 . (e2 x d), by the cross products."""
    e1, e2, b = v[0:3] - v[3:6], v[0:3] - v[6:9], v[0:3] - o
    det = (e1 * torch.linalg.cross(e2, d, dim=0)).sum(0)
    num = (e1 * torch.linalg.cross(e2, b, dim=0)).sum(0)
    t = num / det
    g_num, g_det = gt / det, -gt * t / det
    c = torch.linalg.cross
    ge1 = g_num * c(e2, b, dim=0) + g_det * c(e2, d, dim=0)
    ge2 = g_num * c(b, e1, dim=0) + g_det * c(d, e1, dim=0)
    gb = g_num * c(e1, e2, dim=0)
    gv = torch.cat([ge1 + ge2 + gb, -ge1, -ge2])
    return gv, -gb, g_det * c(e1, e2, dim=0)


def conductor_dratio(n2, k2, c):
    n2k2 = n2 * n2 + k2 * k2
    two = 2.0 * n2 * c
    cos2 = c * c
    bs, be = n2k2 + two + cos2, n2k2 * cos2 + two + 1.0
    ds, de = torch.clamp(bs, min=1e-20), torch.clamp(be, min=1e-20)
    rs, rp = (n2k2 - two + cos2) / ds, (n2k2 * cos2 - two + 1.0) / de
    drs = (2.0 * c - 2.0 * n2 - torch.where(bs > 1e-20, rs * (2.0 * n2 + 2.0 * c),
                                            0.0)) / ds
    drp = (2.0 * n2k2 * c - 2.0 * n2 - torch.where(
        be > 1e-20, rp * (2.0 * n2k2 * c + 2.0 * n2), 0.0)) / de
    return 0.5 * (drs + drp)


def refract_vjp(d, nm, ratio, gdir):
    """The refract leg's adjoint into d and nm (the kernel's dielectric
    branch, REFRACT): tn = norm3((d + nm cos_i) r - nm cos_p)."""
    cos_i = -(d * nm).sum(0)
    crit = ratio * ratio * (1.0 - cos_i * cos_i)
    x = 1.0 - crit
    cos_p = torch.sqrt(torch.clamp(x, min=1e-20))
    cv = (d + nm * cos_i) * ratio - nm * cos_p
    gc = norm3_vjp(cv, gdir)
    gnm = gc * ratio * cos_i - gc * cos_p
    gd = gc * ratio
    g_cos_i = (gc * ratio * nm).sum(0)
    g_cos_p = -(gc * nm).sum(0)
    g_crit = torch.where(x > 1e-20, -g_cos_p * 0.5 / cos_p, 0.0)
    g_cos_i = g_cos_i + g_crit * (ratio * ratio) * (-2.0 * cos_i)
    return gd - g_cos_i * nm, gnm - g_cos_i * d


# ---- the checks ----

def test_norm3_adjoint():
    rng = np.random.default_rng(0)
    x = rand(rng, 3, 500, lo=-3, hi=3)
    x[:, :5] = 1e-12  # below the clamp: the gradient of a constant inverse
    gy = rand(rng, 3, 500)
    want = grads_of(lambda v: torch.stack(mk._norm3(*v)), [x], gy)[0]
    close(norm3_vjp(x, gy), want)


def test_powmax_adjoint():
    rng = np.random.default_rng(1)
    base = rand(rng, 400, lo=-0.5, hi=1.0)
    base[:10] = 0.0
    e = rand(rng, 400, lo=0.0, hi=80.0)
    e[:3] = 0.0
    g = rand(rng, 400)
    want = grads_of(mb._powmax, [base, e], g)
    got = powmax_vjp(base, e, g)
    close(got[0], want[0])
    close(got[1], want[1])


def test_cramer_t_adjoint():
    rng = np.random.default_rng(2)
    v, o, d = rand(rng, 9, 300, lo=-5, hi=5), rand(rng, 3, 300), rand(rng, 3, 300)
    gt = rand(rng, 300)
    want = grads_of(lambda vv, oo, dd: mb._cramer_t(list(vv), list(oo), list(dd)),
                    [v, o, d], gt)
    got = cramer_vjp(v, o, d, gt)
    for a, b in zip(got, want):
        close(a, b)


def test_cramer_t_guard_keeps_a_degenerate_face_finite():
    """det == 0 (a ray in the face's plane): the plain version's guard
    divides by 1, so autograd passes no NaN; the kernel never reverses such
    a face, since a hit needs det != 0."""
    v = torch.tensor([0, 0, 0, 1, 0, 0, 0, 1, 0], dtype=F64)
    o = torch.tensor([0.2, 0.2, 0.0], dtype=F64)
    d = torch.tensor([1.0, 0.0, 0.0], dtype=F64)
    grads = grads_of(lambda vv, oo, dd: mb._cramer_t(list(vv), list(oo),
                                                     list(dd)),
                     [v, o, d], torch.ones((), dtype=F64))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("n2, k2", [(0.37, 2.82), (0.27, 3.41), (1.5, 0.0)])
def test_conductor_ratio_derivative(n2, k2):
    rng = np.random.default_rng(3)
    c = rand(rng, 300, lo=-1.0, hi=1.0)
    n2t, k2t = torch.full_like(c, n2), torch.full_like(c, k2)
    want = grads_of(lambda cc: mb._conductor_ratio(n2t, k2t, cc), [c],
                    torch.ones_like(c))[0]
    close(conductor_dratio(n2t, k2t, c), want)


@pytest.mark.parametrize("ratio", [1.0 / 1.5, 1.5])
def test_refraction_adjoint(ratio):
    """Refract lanes only (crit < 1: TIR lanes reflect), so cos_p's square
    root is differentiable where the kernel differentiates it."""
    rng = np.random.default_rng(4)
    nm = torch.stack(mk._norm3(*rand(rng, 3, 600)))
    d = torch.stack(mk._norm3(*rand(rng, 3, 600)))
    d = torch.where(((d * nm).sum(0) < 0)[None], d, -d)  # entering nm's side
    cos_i = -(d * nm).sum(0)
    keep = ratio * ratio * (1.0 - cos_i * cos_i) < 0.999
    d, nm = d[:, keep], nm[:, keep]
    gdir = rand(rng, 3, d.shape[1])

    def leg(dd, nn):
        ci = -(dd * nn).sum(0)
        crit = ratio * ratio * (1.0 - ci * ci)
        cp = torch.sqrt(torch.clamp(1.0 - crit, min=1e-20))
        return torch.stack(mk._norm3(*((dd + nn * ci) * ratio - nn * cp)))

    want = grads_of(leg, [d, nm], gdir)
    got = refract_vjp(d, nm, ratio, gdir)
    close(got[0], want[0])
    close(got[1], want[1])


def _discriminant(s, o, d):
    m = s[:, 0:12].reshape(-1, 3, 4)
    ol = torch.einsum("nij,jn->in", m[:, :, :3], o) + m[:, :, 3].T
    dl = torch.einsum("nij,jn->in", m[:, :, :3], d)
    oc = ol - s[:, 21:24].T
    a, b = (dl * dl).sum(0), 2.0 * (dl * oc).sum(0)
    return b * b - 4.0 * a * ((oc * oc).sum(0) - s[:, 24] ** 2)


def test_sphere_root_and_normal_adjoint():
    """The sphere's t and unit normal through the ray: the kernel's chain
    (normal, pr, the root's sign, sqrt of the discriminant, a, b, cc, the
    object-space ray) against autograd of ``_sphere_t`` and
    ``_sphere_normal``."""
    rng = np.random.default_rng(5)
    n = 400
    s = torch.zeros((n, mk.SPH_COLS), dtype=F64)
    m = rand(rng, n, 3, 3, lo=-0.4, hi=0.4) + torch.eye(3, dtype=F64)
    s[:, 0:12] = torch.cat([m, rand(rng, n, 3, 1)], 2).reshape(n, 12)
    s[:, 12:21] = torch.linalg.inv(m).transpose(1, 2).reshape(n, 9)
    s[:, 21:24] = rand(rng, n, 3)
    s[:, 24] = 1.0
    o = torch.tensor(rng.normal(0, 0.2, (3, n)), dtype=F64) + torch.tensor(
        [[0.0], [0.0], [6.0]], dtype=F64)
    d = torch.stack(mk._norm3(*(torch.tensor([[0.0], [0.0], [-1.0]], dtype=F64)
                                + rand(rng, 3, n, lo=-0.05, hi=0.05))))
    hit = torch.isfinite(mb._sphere_t(s, list(o), list(d))) & (
        _discriminant(s, o, d) > 0)
    s, o, d = s[hit], o[:, hit], d[:, hit]
    n = s.shape[0]
    assert n > 100
    gt, gn = rand(rng, n), rand(rng, 3, n)

    def fwd(oo, dd):
        t = mb._sphere_t(s, list(oo), list(dd))
        return [t, torch.stack(mb._sphere_normal(s, list(oo), list(dd), t))]

    want = grads_of(fwd, [o, d], [gt, gn])
    # the kernel's reverse of sphere_step
    M = s[:, 0:12].reshape(n, 3, 4)
    ol = torch.einsum("nij,jn->in", M[:, :, :3], o) + M[:, :, 3].T
    dl = torch.einsum("nij,jn->in", M[:, :, :3], d)
    oc = ol - s[:, 21:24].T
    a, b = (dl * dl).sum(0), 2.0 * (dl * oc).sum(0)
    cc = (oc * oc).sum(0) - s[:, 24] ** 2
    delta = b * b - 4.0 * a * cc
    sq, den = torch.sqrt(delta), 2.0 * a
    t1, t2 = (-b + sq) / den, (-b - sq) / den
    t = torch.where(torch.minimum(t1, t2) > 0, torch.minimum(t1, t2),
                    torch.maximum(t1, t2))
    sgn = torch.where(t == t1, 1.0, -1.0)
    pr = ol + t * dl - s[:, 21:24].T
    nrm = s[:, 12:21].reshape(n, 3, 3)
    mv = torch.einsum("nij,jn->in", nrm, pr)
    gmv = norm3_vjp(mv, gn)
    gpr = torch.einsum("nij,in->jn", nrm, gmv)
    g_ts = gt + (gpr * dl).sum(0)
    gol, gdl = gpr.clone(), gpr * t
    g_b0, g_sq, g_den = -g_ts / den, sgn * g_ts / den, -g_ts * t / den
    g_delta = g_sq * 0.5 / sq
    g_b = g_b0 + 2.0 * b * g_delta
    g_a = 2.0 * g_den - 4.0 * cc * g_delta
    g_cc = -4.0 * a * g_delta
    gdl = gdl + 2.0 * dl * g_a + 2.0 * oc * g_b
    gol = gol + 2.0 * dl * g_b + 2.0 * oc * g_cc
    go = torch.einsum("nij,in->jn", M[:, :, :3], gol)
    gd = torch.einsum("nij,in->jn", M[:, :, :3], gdl)
    close(go, want[0])
    close(gd, want[1])


# ---- K2b's adjoints, transcribed ----

def cross(a, b):
    return torch.linalg.cross(a, b, dim=0)


def gi_direction_vjp(n, r1, r2, importance, gg):
    """``gi_direction_vjp``: through the final norm3, v = unit(n x u),
    u = unit(r' x n) and r' (n with its smallest component set to 1)."""
    phi = 2.0 * np.pi * r1
    if importance:
        sin_t, cos_t = torch.sqrt(r2), torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    else:
        cos_t, sin_t = r2, torch.sqrt(torch.clamp(1.0 - r2 * r2, min=0.0))
    a = n.abs()
    use_x = (a[0] < a[1]) & (a[0] < a[2])
    use_y = ~(a[0] < a[1]) & (a[1] < a[2])
    use_z = ~(use_x | use_y)
    use = torch.stack([use_x, use_y, use_z])
    rp = torch.where(use, 1.0, n)
    ur = cross(rp, n)
    u = torch.stack(mk._norm3(*ur))
    vr = cross(n, u)
    v = torch.stack(mk._norm3(*vr))
    sc, ss = sin_t * torch.cos(phi), sin_t * torch.sin(phi)
    x = u * sc + n * cos_t + v * ss
    gx = norm3_vjp(x, gg)
    gu, gv, gn = gx * sc, gx * ss, gx * cos_t
    gvr = norm3_vjp(vr, gv)
    gn = gn + cross(u, gvr)
    gu = gu + cross(gvr, n)
    gur = norm3_vjp(ur, gu)
    grp = cross(n, gur)
    gn = gn + cross(gur, rp)
    return gn + torch.where(use, 0.0, grp)


def towards_vjp(tl, gwi, g_d2):
    """``towards_vjp``: the cotangent of tl = target - p from those of
    wi = tl / sqrt(d2) and d2 = max(tl . tl, 1e-20)."""
    s2 = (tl * tl).sum(0)
    d2 = torch.clamp(s2, min=1e-20)
    inv = 1.0 / torch.sqrt(d2)
    g_d2 = g_d2 + (gwi * tl).sum(0) * (-0.5 * inv / d2)
    return gwi * inv + torch.where(s2 > 1e-20, 2.0 * tl * g_d2, 0.0)


def spot_e_vjp(sl, wi, d2, ge):
    """``ext_e_vjp`` for a spot light: into wi and d2."""
    raw = -(sl[3] * wi[0] + sl[4] * wi[1] + sl[5] * wi[2])
    cos_a = torch.clamp(raw, -1.0, 1.0)
    irr = 1.0 / d2
    x = (cos_a - sl[9]) / sl[11]
    frac = torch.clamp(x, min=0.0)
    scale = torch.where(cos_a < sl[10], frac ** 4, 1.0)
    outside = (cos_a >= 1.0) | (cos_a < sl[9])
    scale = torch.where(outside, 0.0, scale)
    g_d2 = -ge * scale * irr / d2
    band = (~outside & (cos_a < sl[10]) & (x >= 0.0) & (raw >= -1.0)
            & (raw <= 1.0))
    g_cos = torch.where(band, ge * irr * 4.0 * x * x * x / sl[11], 0.0)
    d = torch.tensor(sl[3:6], dtype=F64)[:, None]
    return -g_cos * d, g_d2


def area_e_vjp(al, wi, d2, ge):
    """``ext_e_vjp`` for an area light: e = area |n . wi| / d2."""
    nl = torch.tensor(al[3:6], dtype=F64)[:, None]
    c = (nl * wi).sum(0)
    e = al[10] * c.abs() / d2
    return ge / d2 * al[10] * torch.sign(c) * nl, -ge * e / d2


def rr_fac_vjp(w, g_fac):
    """The GI weight's factor fac = 2 pi / clip(max w, 1e-4, 1): into w,
    the clip passing where 1e-4 <= max w <= 1, max splitting its cotangent
    among tied channels."""
    mx = w.amax(0)
    prob = torch.clamp(mx, 1e-4, 1.0)
    rs = 1.0 / prob
    g_mx = torch.where((mx >= 1e-4) & (mx <= 1.0),
                       -g_fac * 2.0 * np.pi * rs * rs, 0.0)
    ties = (w == mx).sum(0)
    return torch.where(w == mx, g_mx / ties, 0.0)


# ---- K2b's checks ----

@pytest.mark.parametrize("importance", [True, False])
def test_gi_direction_adjoint(importance):
    """The GI direction's adjoint in the normal (a sphere's normal moves
    with the ray), every axis of the basis's swap taken."""
    rng = np.random.default_rng(6)
    n = torch.stack(mk._norm3(*rand(rng, 3, 600)))
    n[:, :4] = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0],
                             [0.6, 0.0, 0.8]], dtype=F64).T
    r1, r2 = rand(rng, 600, lo=0, hi=1), rand(rng, 600, lo=0.01, hi=0.99)
    gg = rand(rng, 3, 600)
    a = n.abs()
    assert bool(((a[0] < a[1]) & (a[0] < a[2])).any())
    assert bool((~(a[0] < a[1]) & (a[1] < a[2])).any())
    want = grads_of(lambda nn: torch.stack(mk._gi_direction(
        *nn, r1, r2, importance)), [n], gg)[0]
    close(gi_direction_vjp(n, r1, r2, importance, gg), want)


def test_towards_adjoint():
    rng = np.random.default_rng(7)
    tl = rand(rng, 3, 500, lo=-4, hi=4)
    tl[:, :3] = 0.0  # the clamp binds
    gwi, g_d2 = rand(rng, 3, 500), rand(rng, 500)
    want = grads_of(lambda x: [torch.stack(mb._towards(list(x), [0.0] * 3)[0]),
                               mb._towards(list(x), [0.0] * 3)[1]],
                    [tl], [gwi, g_d2])[0]
    close(towards_vjp(tl, gwi, g_d2), want)


def test_spot_falloff_adjoint():
    """Inside the falloff cone (no gradient through the cosine), between
    the cones (frac^4), outside (zero): the spot row of scenes/
    feat_spotareaml.xml's kind, cos(cov/2) 0.9397, cos(fall/2) 0.9781."""
    rng = np.random.default_rng(8)
    chc, chf = float(np.cos(np.radians(20))), float(np.cos(np.radians(12)))
    # f32 values, as the light's table holds them (``_div`` makes the
    # denominator an f32 tensor)
    sl = [float(np.float32(x))
          for x in (0, 0, 0, 0.0, 0.0, -1.0, 1, 1, 1, chc, chf, chf - chc)]
    ang = rand(rng, 600, lo=0.0, hi=0.5)
    wi = torch.stack([torch.sin(ang), torch.zeros_like(ang), torch.cos(ang)])
    wi = torch.stack(mk._norm3(*(wi + rand(rng, 3, 600, lo=-1e-3, hi=1e-3))))
    d2 = rand(rng, 600, lo=0.5, hi=9.0)
    ge = rand(rng, 600)
    cos_a = -(sl[5] * wi[2])
    assert bool((cos_a < chc).any() and ((cos_a > chc) & (cos_a < chf)).any()
                and (cos_a > chf).any())
    want = grads_of(lambda w, dd: mb._spot_e(sl, list(w), dd), [wi, d2], ge)
    got = spot_e_vjp(sl, wi, d2, ge)
    close(got[0], want[0])
    close(got[1], want[1])


def test_area_irradiance_adjoint():
    """Both sides of the square (the two-sided cosine)."""
    rng = np.random.default_rng(9)
    al = [0, 3, 0, 0.3, -0.9, 0.2, 5, 5, 5, 1.2, 1.44, 1, 0, 0, 0, 0, 1]
    wi = torch.stack(mk._norm3(*rand(rng, 3, 500)))
    d2 = rand(rng, 500, lo=0.5, hi=9.0)
    ge = rand(rng, 500)
    c = (torch.tensor(al[3:6], dtype=F64)[:, None] * wi).sum(0)
    assert bool((c > 0).any() and (c < 0).any())

    def e(w, dd):
        return al[10] * torch.abs(al[3] * w[0] + al[4] * w[1] + al[5] * w[2]) / dd

    want = grads_of(e, [wi, d2], ge)
    got = area_e_vjp(al, wi, d2, ge)
    close(got[0], want[0])
    close(got[1], want[1])


def test_mesh_light_point_adjoint():
    """The sampled point's cotangent into the face's nine corners (the
    kernel's scatter by row) and into the hit point p, through the
    direction toward it."""
    rng = np.random.default_rng(10)
    v9 = rand(rng, 400, 9, lo=-3, hi=3)
    p = rand(rng, 3, 400, lo=-1, hi=1)
    b1, b2 = rand(rng, 400, lo=0, hi=1), rand(rng, 400, lo=0, hi=1)
    gwi, g_d2 = rand(rng, 3, 400), rand(rng, 400)

    def fwd(vv, pp):
        wi, d2 = mb._towards(mb._ml_point(vv, b1, b2), list(pp))
        return [torch.stack(wi), d2]

    want = grads_of(fwd, [v9, p], [gwi, g_d2])
    tl = torch.stack(mb._ml_point(v9, b1, b2)) - p
    gtl = towards_vjp(tl, gwi, g_d2)
    sq = torch.sqrt(b1)
    got_v = torch.cat([gtl * (1.0 - sq), gtl * sq * (1.0 - b2), gtl * sq * b2]).T
    close(got_v, want[0])
    close(-gtl, want[1])


def test_rr_reweight_adjoint():
    """The reweight's factor through max and the clip: ties (grey
    materials give equal channels) split the cotangent evenly, as torch's
    amax and the JAX oracle's max do; nothing passes where the clip
    binds."""
    rng = np.random.default_rng(11)
    w = rand(rng, 3, 600, lo=0.0, hi=1.3)
    w[:, :50] = w[0, :50]  # three-way ties
    w[1, 50:100] = w[0, 50:100]  # two-way
    w[:, 100:110] = 1e-5  # below the clip
    g_fac = rand(rng, 600)

    def fac(ww):
        return 2.0 * np.pi * (1.0 / torch.clamp(ww.amax(0), 1e-4, 1.0))

    want = grads_of(fac, [w], g_fac)[0]
    close(rr_fac_vjp(w, g_fac), want)


# ---- K2c: the texture step ----


def bary_vjp(v, o, d, gt, g_beta, g_gamma):
    """The kernel's Cramer adjoint with K2c's barycentrics beside t: beta =
    b . (e2 x d) / det, gamma = e1 . (b x d) / det, by the cross products
    c1..c6 of ``diff_ray``'s reverse sweep."""
    c = torch.linalg.cross
    e1, e2, b = v[0:3] - v[3:6], v[0:3] - v[6:9], v[0:3] - o
    det = (e1 * c(e2, d, dim=0)).sum(0)
    t = (e1 * c(e2, b, dim=0)).sum(0) / det
    beta = (b * c(e2, d, dim=0)).sum(0) / det
    gamma = (e1 * c(b, d, dim=0)).sum(0) / det
    g_num = gt / det
    g_det = -gt * t / det - (g_beta * beta + g_gamma * gamma) / det
    g_bn, g_gn = g_beta / det, g_gamma / det
    c1, c2, c3 = c(e2, b, dim=0), c(b, e1, dim=0), c(e1, e2, dim=0)
    c4, c5, c6 = c(e2, d, dim=0), c(d, e1, dim=0), c(b, d, dim=0)
    ge1 = g_num * c1 + g_det * c4 + g_gn * c6
    ge2 = g_num * c2 + g_det * c5 - g_bn * c6
    gb = g_num * c3 + g_bn * c4 + g_gn * c5
    gd = g_det * c3 - g_bn * c1 - g_gn * c2
    return torch.cat([ge1 + ge2 + gb, -ge1, -ge2]), -gb, gd


def test_barycentric_adjoint():
    rng = np.random.default_rng(12)
    v, o, d = rand(rng, 9, 300, lo=-5, hi=5), rand(rng, 3, 300), rand(rng, 3, 300)
    gt, gb, gg = rand(rng, 300), rand(rng, 300), rand(rng, 300)
    want = grads_of(lambda vv, oo, dd: mb._cramer_t(
        list(vv), list(oo), list(dd), bary=True), [v, o, d], [gt, gb, gg])
    for a, b in zip(bary_vjp(v, o, d, gt, gb, gg), want):
        close(a, b)


def test_uv_from_the_barycentrics():
    """uv = uv0 + beta (uv1 - uv0) + gamma (uv2 - uv0): g_beta = g_u (u1 -
    u0) + g_v (v1 - v0), g_gamma = g_u (u2 - u0) + g_v (v2 - v0)."""
    rng = np.random.default_rng(13)
    uv = rand(rng, 6, 200, lo=-1.0, hi=3.0)
    beta, gamma, gu, gv = (rand(rng, 200) for _ in range(4))

    def fwd(bb, gg):
        return [uv[0] + bb * (uv[2] - uv[0]) + gg * (uv[4] - uv[0]),
                uv[1] + bb * (uv[3] - uv[1]) + gg * (uv[5] - uv[1])]

    want = grads_of(fwd, [beta, gamma], [gu, gv])
    close(gu * (uv[2] - uv[0]) + gv * (uv[3] - uv[1]), want[0])
    close(gu * (uv[4] - uv[0]) + gv * (uv[5] - uv[1]), want[1])


def tile_slope(x):
    """``tile_slope``: 1, or 0 where tile_uv returns the constant 1."""
    return ((x <= 1.0001) | (x - torch.floor(x) >= 0.0001)).to(x.dtype)


def test_tile_uv_slope():
    rng = np.random.default_rng(14)
    x = rand(rng, 400, lo=-2.0, hi=4.0)
    x[:6] = torch.tensor([1.0, 1.0001, 2.0, 2.00005, 3.0, 0.5])
    want = grads_of(tex.tile_uv, [x], torch.ones_like(x))[0]
    close(tile_slope(x), want)
    assert float(want[2]) == 0.0 and float(want[0]) == 1.0


def clip_slope(x, hi):
    """``clip_slope``: d min(max(x, 0), hi) / dx, half of it at each tie."""
    a = torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))
    y = torch.clamp(x, min=0.0)
    return a * torch.where(y < hi, 1.0, torch.where(y == hi, 0.5, 0.0))


def weights_vjp(u, v, w, h, gw):
    """``tex_step_vjp``'s bilinear part: the weights' cotangents gw (4, R)
    into u and v through dx, dy and the clip (floor a constant)."""
    xi, xj = u * w, v * h
    fi = torch.clamp(torch.clamp(xi, min=0.0), max=w - 1.0)
    fj = torch.clamp(torch.clamp(xj, min=0.0), max=h - 1.0)
    dx, dy = fi - torch.floor(fi), fj - torch.floor(fj)
    g_dx = (gw[1] - gw[0]) * (1.0 - dy) + (gw[3] - gw[2]) * dy
    g_dy = (gw[2] - gw[0]) * (1.0 - dx) + (gw[3] - gw[1]) * dx
    return g_dx * clip_slope(xi, w - 1.0) * w, g_dy * clip_slope(xj, h - 1.0) * h


@pytest.mark.parametrize("w, h", [(8, 5), (1, 3)])
def test_bilinear_weights_adjoint(w, h):
    """The four weights of ``ops/texture.py::bilinear_taps`` in u and v,
    with the coordinates exactly on 0 and on w - 1 (JAX's clip passes half
    there) and outside the image (nothing passes); a one-texel-wide image
    puts both ties on one point."""
    rng = np.random.default_rng(15)
    u, v = rand(rng, 300, lo=-0.3, hi=1.3), rand(rng, 300, lo=-0.3, hi=1.3)
    u[:4] = torch.tensor([0.0, (w - 1) / w, 1.0, 0.5], dtype=F64)
    v[4:8] = torch.tensor([0.0, (h - 1) / h, 1.0, 0.5], dtype=F64)
    gw = rand(rng, 4, 300)
    want = grads_of(lambda uu, vv: tex.bilinear_taps(uu, vv, w, h)[1],
                    [u, v], list(gw))
    got = weights_vjp(u, v, float(w), float(h), gw)
    close(got[0], want[0])
    close(got[1], want[1])
