// mega_bwd.cu — kernel K2a for NVIDIA Hopper (sm_90a): the differentiable
// render's Whitted chain, forward and reverse in one launch.
//
// Replaces the Whitted part of the TPU kernel
// advanced_cpu_raytracing_tpu/ops/pallas/megabwd.py::_kernel (line 428,
// launched by _bwd_call through pl.pallas_call at line 1727, reduced by
// _reduce_streams at 1739): per ray, a linear chain of depth = max_depth + 1
// segments.  Each traces the scene (mw::trace of mega_common.cuh, carrying
// the winner's row), fixes the segment's topology — which primitive wins,
// shadow visibility, emissive and lit, the mirror / conductor gate, the
// dielectric's entering sign, total internal reflection and its
// reflect-or-refract choice from the branch uniform — and takes one step:
// the hit's t (Cramer's rule through the winner's vertices, or the sphere's
// quadratic through the ray), Beer's attenuation on segments k > 0, the
// primary miss's background, the emissive term, ambient, point and
// directional Blinn-Phong light, and the one child ray (megabwd.py:783-1188,
// the Whitted lines).  Its plain version is
// ops/megabwd.py::diff_trace_ref, differentiated by torch autograd.
//
// Design.  One thread per ray, 128 per block, as K1.  Two instantiations
// of one template: the primal (kBwd = false: the radiance only, the JAX
// with_bwd=False) and the fwd+bwd (kBwd = true), each over the 128-face
// chunks or the tree (FlatChunks / ChunkTree, picked as K1 picks them), so
// K2a has no face cap.  The forward keeps each segment's stop-grad facts in
// a per-thread record (origin, direction, weight, Beer constant, the
// dielectric's ratio, winner row / sphere / material, topology and
// visibility bits; MAX_SEG records in local memory).  The reverse sweep
// runs from the last segment to the first: it recomputes the step's
// forward values from the record and the call's tables and applies each
// step's adjoint, derived by hand (the TPU kernel gets it from jax.vjp at
// trace time, which has no CUDA counterpart).  The cotangents are scattered
// with atomics in place of the TPU's one-hot MXU epilogue: the winner
// vertices' (9 per segment) straight to global memory by row; the
// materials', lights' and background's into shared memory per block first,
// then one global atomic per block and value (a few addresses take every
// ray's adds).  The ray cotangents d_o, d_d are written per ray.
//
// Bound.  FP32 arithmetic on the CUDA cores: the closest-hit and shadow
// queries' triangle, slab and sphere tests (once per launch: the reverse
// sweep traces nothing), counted over the chunks and over the tree,
// whichever needs fewer, plus the step and its adjoint per
// segment and light; bytes are the rays in and out and the tables (or the
// tree's boxes and rows) read once.  Built with
// -fmad=false, IEEE division and sqrtf, the forward computes the plain
// version's expressions in their order; the adjoint is an independent
// derivation, so it rounds otherwise than autograd.

#include "mega_common.cuh"

namespace mb {

using namespace mw;

constexpr int MAX_SEG = 11;  // segments: MAX_DEPTH (10) + 1
constexpr int FLAG_EMISSIVE = 8, FLAG_NO_SCATTER = 16;
constexpr int MAT_GRAD_COLS = 16;  // amb 0:3 kd 3:6 ks 6:9 mir 9:12 phong 12
                                   // radiance 13:16
constexpr float TWO_PI = 6.283185307179586f;
// a segment's shadow visibility, one bit per point or directional light:
// the launcher refuses more lights (ops/megabwd.py::MAX_LIGHTS)
constexpr int VIS_BITS = 32;

// topology bits of a segment record
constexpr unsigned HIT = 1u, LIT = 2u, MISS_PRIMARY = 4u, EMISSIVE = 8u,
                   MIRROR = 16u, COND = 32u, REFLECT = 64u, REFRACT = 128u,
                   EXITING = 256u, CHAIN = 512u;

struct BwdParams {
  Params g;          // the call's tables: tri (W,16), mat (M,22), pl, dl
  const float* bg;   // (3,)
  const float* ud;   // (depth, n) branch uniforms, or null: Philox
  const float* gbar;  // (n, 3) the radiance's cotangent (fwd+bwd only)
  float* d_tri;      // (W, 9)
  float* d_mat;      // (M, MAT_GRAD_COLS)
  float* d_pl;       // (n_point, 3)
  float* d_dl;       // (n_dir, 3)
  float* d_bg;       // (3,)
  float* d_o;        // (n, 3)
  float* d_d;        // (n, 3)
  int n, depth;
  unsigned seed, step;
};

// one segment's stop-grad facts (the TPU kernel's per-segment `st`)
struct Seg {
  float o[3], d[3], w[3], ab[3];
  float ratio;  // the dielectric's n1 / n2
  int row, sph, mat;
  unsigned bits, vis;
};

// the branch uniform of segment k of ray i: the table's, else Philox keyed
// (seed, step), counter (ray, segment, 0, 0), word 0 (ops/megabwd.py::ud_table)
__device__ __forceinline__ float branch_uniform(const BwdParams& Q, int i,
                                                int k) {
  if (Q.ud != nullptr) return __ldg(Q.ud + static_cast<size_t>(k) * Q.n + i);
  const uint4 w = philox(make_uint4(static_cast<unsigned>(i),
                                    static_cast<unsigned>(k), 0u, 0u),
                         Q.seed, Q.step);
  return static_cast<float>(w.x >> 9) * (1.0f / 8388608.0f);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// y = x / |x| (norm3) and its adjoint: gx = inv (gy - y (y . gy)), where
// the clamp of |x|^2 at 1e-20 does not bind
__device__ __forceinline__ void norm3_vjp(const float* x, const float* gy,
                                          float* gx) {
  const float s = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  const float inv = 1.0f / sqrtf(fmaxf(s, 1e-20f));
  if (s > 1e-20f) {
    const float y[3] = {x[0] * inv, x[1] * inv, x[2] * inv};
    const float yg = dot3(y, gy);
    for (int c = 0; c < 3; ++c) gx[c] = inv * (gy[c] - y[c] * yg);
  } else {
    for (int c = 0; c < 3; ++c) gx[c] = inv * gy[c];
  }
}

// the conductor's Fresnel ratio at cos c (raytracer.cpp:208-254) and its
// derivative in c
__device__ __forceinline__ float conductor_ratio(float n2, float k2, float c,
                                                 float* dratio) {
  const float n2k2 = n2 * n2 + k2 * k2;
  const float two = 2.0f * n2 * c;
  const float cos2 = c * c;
  const float bs = n2k2 + two + cos2, be = n2k2 * cos2 + two + 1.0f;
  const float ds = fmaxf(bs, 1e-20f), de = fmaxf(be, 1e-20f);
  const float rs = (n2k2 - two + cos2) / ds;
  const float rp = (n2k2 * cos2 - two + 1.0f) / de;
  if (dratio != nullptr) {
    const float da = 2.0f * c - 2.0f * n2, db = 2.0f * n2 + 2.0f * c;
    const float dc = 2.0f * n2k2 * c - 2.0f * n2, dd = 2.0f * n2k2 * c + 2.0f * n2;
    const float drs = (da - (bs > 1e-20f ? rs * db : 0.0f)) / ds;
    const float drp = (dc - (be > 1e-20f ? rp * dd : 0.0f)) / de;
    *dratio = 0.5f * (drs + drp);
  }
  return 0.5f * (rs + rp);
}

// a sphere's quadratic and normal through the ray (megabwd.py:545-580),
// with what the adjoint needs
struct SphereStep {
  float ol[3], dl[3], oc[3], a, b, cc, delta, sq, denom, t, pr[3], m[3],
      n[3];
  float sgn;  // +1: the root (-b + sq) / denom, -1: (-b - sq) / denom
};

__device__ __forceinline__ void sphere_step(const float* s, const float* o,
                                            const float* d, bool want_t,
                                            float t_in, SphereStep& S) {
  for (int i = 0; i < 3; ++i) {
    S.ol[i] = s[4 * i] * o[0] + s[4 * i + 1] * o[1] + s[4 * i + 2] * o[2] +
              s[4 * i + 3];
    S.dl[i] = s[4 * i] * d[0] + s[4 * i + 1] * d[1] + s[4 * i + 2] * d[2];
    S.oc[i] = S.ol[i] - s[21 + i];
  }
  const float rad = s[24];
  S.a = S.dl[0] * S.dl[0] + S.dl[1] * S.dl[1] + S.dl[2] * S.dl[2];
  S.b = 2.0f * (S.dl[0] * S.oc[0] + S.dl[1] * S.oc[1] + S.dl[2] * S.oc[2]);
  S.cc = S.oc[0] * S.oc[0] + S.oc[1] * S.oc[1] + S.oc[2] * S.oc[2] - rad * rad;
  S.delta = S.b * S.b - 4.0f * S.a * S.cc;
  S.sq = S.delta > 0.0f ? sqrtf(S.delta) : 0.0f;
  S.denom = S.a > 0.0f ? 2.0f * S.a : 1.0f;
  const float t1 = (-S.b + S.sq) / S.denom, t2 = (-S.b - S.sq) / S.denom;
  const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
  S.t = lo > 0.0f ? lo : hi;
  S.sgn = S.t == t1 ? 1.0f : -1.0f;
  const float t = want_t ? S.t : t_in;
  for (int i = 0; i < 3; ++i) S.pr[i] = S.ol[i] + t * S.dl[i] - s[21 + i];
  for (int i = 0; i < 3; ++i) {
    S.m[i] = s[12 + 3 * i] * S.pr[0] + s[13 + 3 * i] * S.pr[1] +
             s[14 + 3 * i] * S.pr[2];
    S.n[i] = S.m[i];
  }
  norm3(S.n[0], S.n[1], S.n[2]);
}

// Cramer's t through the winner's vertices (megabwd.py:809-818)
struct TriStep {
  float e1[3], e2[3], b[3], det, safe, num, t;
};

__device__ __forceinline__ void tri_step(const float* v, const float* o,
                                         const float* d, TriStep& T) {
  for (int i = 0; i < 3; ++i) {
    T.e1[i] = v[i] - v[3 + i];
    T.e2[i] = v[i] - v[6 + i];
    T.b[i] = v[i] - o[i];
  }
  const float* e1 = T.e1;
  const float* e2 = T.e2;
  const float* b = T.b;
  const float m0 = e2[1] * d[2] - d[1] * e2[2];
  const float m1 = e2[0] * d[2] - d[0] * e2[2];
  const float m2 = e2[0] * d[1] - d[0] * e2[1];
  T.det = e1[0] * m0 - e1[1] * m1 + e1[2] * m2;
  T.safe = T.det == 0.0f ? 1.0f : T.det;
  const float q0 = e2[1] * b[2] - b[1] * e2[2];
  const float q1 = e2[0] * b[2] - b[0] * e2[2];
  const float q2 = e2[0] * b[1] - b[0] * e2[1];
  T.num = e1[0] * q0 - e1[1] * q1 + e1[2] * q2;
  T.t = T.num / T.safe;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// Blinn-Phong with unit irradiance toward wi (raytracer.cpp:540-554)
struct Shade {
  float dn, hr[3], h[3], hn, cos_t, cos_hm, spec, v[3];
};

__device__ __forceinline__ void shade_unit(const float* wi, const float* n,
                                           const float* wo, const float* m,
                                           Shade& S) {
  S.dn = wi[0] * n[0] + wi[1] * n[1] + wi[2] * n[2];
  S.cos_t = fmaxf(0.0f, S.dn);
  for (int c = 0; c < 3; ++c) S.hr[c] = S.h[c] = wi[c] + wo[c];
  norm3(S.h[0], S.h[1], S.h[2]);
  S.hn = S.h[0] * n[0] + S.h[1] * n[1] + S.h[2] * n[2];
  S.cos_hm = fmaxf(0.0f, S.hn);
  S.spec = powmax(S.cos_hm, m[13]);
  for (int c = 0; c < 3; ++c) S.v[c] = m[4 + c] * S.cos_t + m[7 + c] * S.spec;
}

// The adjoint of shade_unit for the cotangent gv of its value: into the
// material's kd, ks and phong (gm), the direction wi (gwi, may be null for
// a constant wi), the normal (gn) and wo (gwo)
__device__ __forceinline__ void shade_unit_vjp(const float* wi,
                                               const float* n, const float* m,
                                               const Shade& S, const float* gv,
                                               float* gm, float* gwi, float* gn,
                                               float* gwo) {
  float g_cos_t = 0.0f, g_spec = 0.0f;
  for (int c = 0; c < 3; ++c) {
    gm[3 + c] += gv[c] * S.cos_t;
    gm[6 + c] += gv[c] * S.spec;
    g_cos_t += gv[c] * m[4 + c];
    g_spec += gv[c] * m[7 + c];
  }
  // powmax: d/dbase = e val / base, d/de = val log(base), where base > 0
  float g_hm = 0.0f;
  if (S.cos_hm > 0.0f) {
    const float e = m[13];
    g_hm = g_spec * e * S.spec / S.cos_hm;
    gm[12] += g_spec * S.spec * logf(S.cos_hm);
  }
  float gh[3] = {0.0f, 0.0f, 0.0f};
  if (S.hn > 0.0f) {
    for (int c = 0; c < 3; ++c) {
      gh[c] = g_hm * n[c];
      gn[c] += g_hm * S.h[c];
    }
  }
  float ghr[3];
  norm3_vjp(S.hr, gh, ghr);
  for (int c = 0; c < 3; ++c) gwo[c] += ghr[c];
  if (gwi != nullptr) {
    for (int c = 0; c < 3; ++c) gwi[c] += ghr[c];
    if (S.dn > 0.0f)
      for (int c = 0; c < 3; ++c) gwi[c] += g_cos_t * n[c];
  }
  if (S.dn > 0.0f)
    for (int c = 0; c < 3; ++c) gn[c] += g_cos_t * wi[c];
}

// The step's forward values recomputed from a record: t, the normal, the
// hit point and the weight after Beer (the sphere's or triangle's solve
// kept for the adjoint).
struct Geo {
  TriStep T;
  SphereStep Sp;
  float t, n[3], p[3], wo[3], e[3], wb[3];
};

template <bool kRecompute>
__device__ __forceinline__ void step_geometry(const BwdParams& Q,
                                              const Seg& s, int k, float t_hit,
                                              Geo& G) {
  const bool hit = (s.bits & HIT) != 0;
  G.t = 0.0f;
  G.n[0] = 0.0f;
  G.n[1] = 0.0f;
  G.n[2] = 1.0f;
  if (s.row >= 0) {
    const float* r = Q.g.tri + s.row * TRI_COLS;
    if (kRecompute) {
      float v[9];
      for (int j = 0; j < 9; ++j) v[j] = r[j];
      tri_step(v, s.o, s.d, G.T);
      G.t = G.T.t;
    } else {
      G.t = t_hit;
    }
    G.n[0] = r[9];
    G.n[1] = r[10];
    G.n[2] = r[11];
  } else if (s.sph >= 0) {
    sphere_step(Q.g.sph + s.sph * SPH_COLS, s.o, s.d, kRecompute, t_hit,
                G.Sp);
    G.t = kRecompute ? G.Sp.t : t_hit;
    for (int c = 0; c < 3; ++c) G.n[c] = G.Sp.n[c];
  }
  if (!hit) G.t = 0.0f;
  for (int c = 0; c < 3; ++c) {
    G.p[c] = s.o[c] + G.t * s.d[c];
    G.wo[c] = -s.d[c];
    G.e[c] = 1.0f;
    G.wb[c] = s.w[c];
  }
  if ((Q.g.flags & FLAG_DIELECTRIC) && k > 0) {
    for (int c = 0; c < 3; ++c) {
      G.e[c] = expf(-s.ab[c] * G.t);
      G.wb[c] = s.w[c] * G.e[c];
    }
  }
}

// light l's table row and its direction and distance from p: point lights
// first, then directional
__device__ __forceinline__ bool light_at(const Params& P, int l,
                                         const float* p, float* tl, float* wi,
                                         float& d2, float& inv,
                                         const float*& row) {
  const bool point = l < P.n_point;
  row = point ? P.pl + l * LIGHT_COLS : P.dl + (l - P.n_point) * LIGHT_COLS;
  if (point) {
    for (int c = 0; c < 3; ++c) tl[c] = row[c] - p[c];
    d2 = fmaxf(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2], 1e-20f);
    inv = 1.0f / sqrtf(d2);
    for (int c = 0; c < 3; ++c) wi[c] = tl[c] * inv;
  } else {
    for (int c = 0; c < 3; ++c) wi[c] = row[c];
  }
  return point;
}

// emissive faces cast no shadow (CastShadowRay, raytracer.cpp:590-593)
template <class G>
__device__ __forceinline__ bool light_visible(const Params& P, int l,
                                              const float* so,
                                              const float* wi, float d2,
                                              bool point) {
  const float limit = point ? sqrtf(d2) : BIG;
  if (P.flags & FLAG_EMISSIVE)
    return !shadow<true, NoMotion, G>(P, so[0], so[1], so[2], wi[0], wi[1],
                                      wi[2], limit);
  return !shadow<false, NoMotion, G>(P, so[0], so[1], so[2], wi[0], wi[1],
                                     wi[2], limit);
}

template <bool kBwd, class G>
__device__ void diff_ray(const BwdParams& Q, const float* __restrict__ o,
                         const float* __restrict__ d, float* __restrict__ out,
                         int i, float* sm) {
  const Params& P = Q.g;
  const bool diel = (P.flags & FLAG_DIELECTRIC) != 0;
  const bool has_em = (P.flags & FLAG_EMISSIVE) != 0;
  const bool any_spec =
      (P.flags & (FLAG_MIRROR | FLAG_DIELECTRIC | FLAG_CONDUCTOR)) != 0;
  const bool has_amb = P.amb[0] != 0.0f || P.amb[1] != 0.0f || P.amb[2] != 0.0f;
  const float eps = P.eps;
  const int n_light = P.n_point + P.n_dir;
  Seg rec[kBwd ? MAX_SEG : 1];
  int n_seg = 0;
  Seg s;
  for (int c = 0; c < 3; ++c) {
    s.o[c] = o[3 * i + c];
    s.d[c] = d[3 * i + c];
    s.w[c] = 1.0f;
    s.ab[c] = 0.0f;
  }
  float med = 1.0f;
  float L[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < Q.depth; ++k) {
    // ---- trace and topology (stop-grad) ----
    int win[2];
    const Hit h = trace<false, NoMotion, true, G>(
        P, s.o[0], s.o[1], s.o[2], s.d[0], s.d[1], s.d[2], NoMotion(), win);
    s.row = win[0];
    s.sph = win[1];
    s.mat = h.hit ? h.mat : 0;
    s.ratio = 1.0f;
    s.vis = 0u;
    const float* m = P.mat + s.mat * MAT_COLS;
    const int type = static_cast<int>(m[0]);
    unsigned bits = h.hit ? HIT : 0u;
    if (h.hit && has_em && type == MAT_EMISSIVE) bits |= EMISSIVE;
    const bool lit = h.hit && !(bits & EMISSIVE) && !(diel && med > 1.00001f);
    if (lit) bits |= LIT;
    if (k == 0 && !h.hit) bits |= MISS_PRIMARY;
    s.bits = bits;
    Geo g;
    step_geometry<false>(Q, s, k, h.t, g);
    const float* n = g.n;
    // ---- the segment's radiance ----
    float seg[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 3; ++c) {
      if (bits & MISS_PRIMARY) seg[c] = seg[c] + g.wb[c] * Q.bg[c];
      if (bits & EMISSIVE) seg[c] = seg[c] + g.wb[c] * m[19 + c] * TWO_PI;
      if (has_amb && lit) seg[c] = seg[c] + g.wb[c] * P.amb[c] * m[1 + c];
    }
    if (lit) {
      const float so[3] = {g.p[0] + n[0] * eps, g.p[1] + n[1] * eps,
                           g.p[2] + n[2] * eps};
      for (int l = 0; l < n_light; ++l) {
        float tl[3], wi[3], d2 = 0.0f, inv = 0.0f;
        const float* row;
        const bool point = light_at(P, l, g.p, tl, wi, d2, inv, row);
        if (!light_visible<G>(P, l, so, wi, d2, point)) continue;
        s.vis |= 1u << l;
        Shade S;
        shade_unit(wi, n, g.wo, m, S);
        for (int c = 0; c < 3; ++c)
          seg[c] = seg[c] + (point ? g.wb[c] * row[3 + c] / d2
                                   : g.wb[c] * row[3 + c]) * S.v[c];
      }
    }
    for (int c = 0; c < 3; ++c) L[c] = L[c] + seg[c];
    // ---- the child ----
    bool chain = false;
    float o2[3], d2v[3], w2[3], ab2[3] = {0.0f, 0.0f, 0.0f}, med2 = 1.0f;
    if (k < Q.depth - 1 && any_spec && h.hit) {
      if (type == MAT_MIRROR || type == MAT_CONDUCTOR) {
        const float ndotwo = dot3(n, g.wo);
        float ratio = 1.0f;
        chain = true;
        if (type == MAT_CONDUCTOR) {
          ratio = conductor_ratio(m[14], m[15], ndotwo, nullptr);
          chain = ratio > 1e-4f;
        }
        if (chain) {
          s.bits |= type == MAT_MIRROR ? MIRROR : COND;
          float r[3];
          for (int c = 0; c < 3; ++c) r[c] = 2.0f * n[c] * ndotwo - g.wo[c];
          norm3(r[0], r[1], r[2]);
          for (int c = 0; c < 3; ++c) {
            o2[c] = g.p[c] + n[c] * eps;
            d2v[c] = r[c];
            w2[c] = g.wb[c] * (type == MAT_MIRROR ? m[10 + c]
                                                  : m[10 + c] * ratio);
          }
        }
      } else if (type == MAT_DIELECTRIC) {
        const float ior = m[14];
        const float cos0 = -dot3(n, s.d);
        const bool entering = cos0 > 0.0f;
        const float n1 = entering ? med : ior;
        const float n2 = entering ? ior : 1.0f;
        const float ratio_n = n1 / fmaxf(n2, 1e-20f);
        const float cos_a = fabsf(cos0);
        const float crit0 = ratio_n * ratio_n * (1.0f - cos_a * cos_a);
        const bool tir = crit0 > 1.0f;
        const float cos_p0 = tir ? 0.0f : sqrtf(fmaxf(1.0f - crit0, 1e-20f));
        const float n2cos = n2 * cos_a, n1cosp = n1 * cos_p0;
        const float rpar = (n2cos - n1cosp) / fmaxf(n2cos + n1cosp, 1e-20f);
        const float rperp = (n1 * cos_a - n2 * cos_p0) /
                            fmaxf(n1 * cos_a + n2 * cos_p0, 1e-20f);
        const float r_refl = 0.5f * (rpar * rpar + rperp * rperp);
        const bool refl = tir || branch_uniform(Q, i, k) < r_refl;
        chain = true;
        s.bits |= (refl ? REFLECT : REFRACT) | (entering ? 0u : EXITING);
        s.ratio = ratio_n;
        med2 = tir ? med : n2;
        const bool take = tir ? med > 1.0001f
                              : (refl ? n2 > 1.00001f : n2 > 1.001f);
        if (take)
          for (int c = 0; c < 3; ++c) ab2[c] = m[16 + c];
        const float sgn = entering ? 1.0f : -1.0f;
        const float nm[3] = {n[0] * sgn, n[1] * sgn, n[2] * sgn};
        const float cos_i = -dot3(s.d, nm);
        if (refl) {
          float rm[3];
          for (int c = 0; c < 3; ++c) rm[c] = 2.0f * nm[c] * cos_i + s.d[c];
          norm3(rm[0], rm[1], rm[2]);
          for (int c = 0; c < 3; ++c) {
            o2[c] = g.p[c] + nm[c] * eps;
            d2v[c] = rm[c];
          }
        } else {
          const float crit = ratio_n * ratio_n * (1.0f - cos_i * cos_i);
          const float cos_p = sqrtf(fmaxf(1.0f - crit, 1e-20f));
          float tn[3];
          for (int c = 0; c < 3; ++c)
            tn[c] = (s.d[c] + nm[c] * cos_i) * ratio_n - nm[c] * cos_p;
          norm3(tn[0], tn[1], tn[2]);
          for (int c = 0; c < 3; ++c) {
            o2[c] = g.p[c] - nm[c] * eps;
            d2v[c] = tn[c];
          }
        }
        for (int c = 0; c < 3; ++c) w2[c] = g.wb[c];
      }
    }
    if (chain) s.bits |= CHAIN;
    if (kBwd) rec[n_seg] = s;
    ++n_seg;
    if (!chain) break;
    for (int c = 0; c < 3; ++c) {
      s.o[c] = o2[c];
      s.d[c] = d2v[c];
      s.w[c] = w2[c];
      s.ab[c] = ab2[c];
    }
    med = med2;
  }
  for (int c = 0; c < 3; ++c) out[3 * i + c] = L[c];
  if constexpr (!kBwd) return;

  // ---- reverse sweep: the last segment to the first ----
  const bool scatter = (P.flags & FLAG_NO_SCATTER) == 0;
  float* sm_mat = sm;
  float* sm_pl = sm + P.n_mat * MAT_GRAD_COLS;
  float* sm_dl = sm_pl + 3 * P.n_point;
  float* sm_bg = sm_dl + 3 * P.n_dir;
  float gL[3], go2[3] = {0.0f, 0.0f, 0.0f}, gd2[3] = {0.0f, 0.0f, 0.0f},
               gw2[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) gL[c] = Q.gbar[3 * i + c];
  for (int k = n_seg - 1; k >= 0; --k) {
    const Seg& s = rec[k];
    const float* m = P.mat + s.mat * MAT_COLS;
    Geo g;
    step_geometry<true>(Q, s, k, 0.0f, g);
    const float* n = g.n;
    float gm[MAT_GRAD_COLS];
    for (int j = 0; j < MAT_GRAD_COLS; ++j) gm[j] = 0.0f;
    float gwb[3] = {0.0f, 0.0f, 0.0f}, gp[3] = {0.0f, 0.0f, 0.0f},
          gn[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f},
          go[3] = {0.0f, 0.0f, 0.0f}, gwo[3] = {0.0f, 0.0f, 0.0f};
    float gt = 0.0f;
    // the child
    if (s.bits & CHAIN) {
      if (s.bits & (MIRROR | COND)) {
        const float ndotwo = dot3(n, g.wo);
        float a[3];
        for (int c = 0; c < 3; ++c) a[c] = 2.0f * n[c] * ndotwo - g.wo[c];
        float ga[3];
        norm3_vjp(a, gd2, ga);
        float g_ndotwo = 0.0f;
        for (int c = 0; c < 3; ++c) {
          gp[c] += go2[c];
          gn[c] += go2[c] * eps + 2.0f * ndotwo * ga[c];
          g_ndotwo += 2.0f * n[c] * ga[c];
          gwo[c] -= ga[c];
        }
        if (s.bits & MIRROR) {
          for (int c = 0; c < 3; ++c) {
            gwb[c] += gw2[c] * m[10 + c];
            gm[9 + c] += gw2[c] * g.wb[c];
          }
        } else {
          float dratio;
          const float ratio = conductor_ratio(m[14], m[15], ndotwo, &dratio);
          float g_ratio = 0.0f;
          for (int c = 0; c < 3; ++c) {
            const float f = m[10 + c] * ratio;
            gwb[c] += gw2[c] * f;
            const float gf = gw2[c] * g.wb[c];
            gm[9 + c] += gf * ratio;
            g_ratio += gf * m[10 + c];
          }
          g_ndotwo += g_ratio * dratio;
        }
        for (int c = 0; c < 3; ++c) {
          gn[c] += g_ndotwo * g.wo[c];
          gwo[c] += g_ndotwo * n[c];
        }
      } else {  // the dielectric's leg
        const float sgn = (s.bits & EXITING) ? -1.0f : 1.0f;
        const float ratio_n = s.ratio;
        const float nm[3] = {n[0] * sgn, n[1] * sgn, n[2] * sgn};
        const float cos_i = -dot3(s.d, nm);
        float gnm[3] = {0.0f, 0.0f, 0.0f}, g_cos_i = 0.0f;
        for (int c = 0; c < 3; ++c) gp[c] += go2[c];
        if (s.bits & REFLECT) {
          float b[3];
          for (int c = 0; c < 3; ++c) b[c] = 2.0f * nm[c] * cos_i + s.d[c];
          float gb[3];
          norm3_vjp(b, gd2, gb);
          for (int c = 0; c < 3; ++c) {
            gnm[c] += go2[c] * eps + 2.0f * cos_i * gb[c];
            g_cos_i += 2.0f * nm[c] * gb[c];
            gd[c] += gb[c];
          }
        } else {
          const float crit = ratio_n * ratio_n * (1.0f - cos_i * cos_i);
          const float x = 1.0f - crit;
          const float cos_p = sqrtf(fmaxf(x, 1e-20f));
          float cv[3];
          for (int c = 0; c < 3; ++c)
            cv[c] = (s.d[c] + nm[c] * cos_i) * ratio_n - nm[c] * cos_p;
          float gc[3];
          norm3_vjp(cv, gd2, gc);
          float g_cos_p = 0.0f;
          for (int c = 0; c < 3; ++c) {
            gnm[c] += -go2[c] * eps + gc[c] * ratio_n * cos_i - gc[c] * cos_p;
            gd[c] += gc[c] * ratio_n;
            g_cos_i += gc[c] * ratio_n * nm[c];
            g_cos_p -= gc[c] * nm[c];
          }
          if (x > 1e-20f) {
            const float g_crit = -g_cos_p * 0.5f / cos_p;
            g_cos_i += g_crit * (ratio_n * ratio_n) * (-2.0f * cos_i);
          }
        }
        for (int c = 0; c < 3; ++c) {
          gwb[c] += gw2[c];
          gd[c] -= g_cos_i * nm[c];
          gnm[c] -= g_cos_i * s.d[c];
          gn[c] += gnm[c] * sgn;
        }
      }
    }
    // the segment's radiance
    const bool lit = (s.bits & LIT) != 0;
    for (int c = 0; c < 3; ++c) {
      if (s.bits & MISS_PRIMARY) {
        gwb[c] += gL[c] * Q.bg[c];
        if (scatter) atomicAdd(sm_bg + c, gL[c] * g.wb[c]);
      }
      if (s.bits & EMISSIVE) {
        gwb[c] += gL[c] * TWO_PI * m[19 + c];
        gm[13 + c] += gL[c] * TWO_PI * g.wb[c];
      }
      if (has_amb && lit) {
        gwb[c] += gL[c] * m[1 + c] * P.amb[c];
        gm[c] += gL[c] * (g.wb[c] * P.amb[c]);
      }
    }
    if (lit) {
      for (int l = 0; l < n_light; ++l) {
        if (!((s.vis >> l) & 1u)) continue;
        float tl[3], wi[3], d2 = 0.0f, inv = 0.0f;
        const float* row;
        const bool point = light_at(P, l, g.p, tl, wi, d2, inv, row);
        Shade S;
        shade_unit(wi, n, g.wo, m, S);
        float gv[3], gwi[3] = {0.0f, 0.0f, 0.0f};
        if (point) {
          float g_d2 = 0.0f;
          for (int c = 0; c < 3; ++c) {
            const float q = g.wb[c] * row[3 + c] / d2;
            const float gq = gL[c] * S.v[c];
            gv[c] = gL[c] * q;
            gwb[c] += gq / d2 * row[3 + c];
            if (scatter) atomicAdd(sm_pl + 3 * l + c, gq / d2 * g.wb[c]);
            g_d2 -= gq * q / d2;
          }
          shade_unit_vjp(wi, n, m, S, gv, gm, gwi, gn, gwo);
          // wi = tl / sqrt(d2), d2 = max(tl . tl, 1e-20), tl = pos - p
          const float g_inv = dot3(gwi, tl);
          g_d2 += g_inv * (-0.5f * inv / d2);
          const float s2 = tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2];
          for (int c = 0; c < 3; ++c) {
            float gtl = gwi[c] * inv;
            if (s2 > 1e-20f) gtl += 2.0f * tl[c] * g_d2;
            gp[c] -= gtl;
          }
        } else {
          const int j = l - P.n_point;
          for (int c = 0; c < 3; ++c) {
            const float q = g.wb[c] * row[3 + c];
            const float gq = gL[c] * S.v[c];
            gv[c] = gL[c] * q;
            gwb[c] += gq * row[3 + c];
            if (scatter) atomicAdd(sm_dl + 3 * j + c, gq * g.wb[c]);
          }
          shade_unit_vjp(wi, n, m, S, gv, gm, nullptr, gn, gwo);
        }
      }
    }
    // wo = -d; Beer; p = o + t d
    float gw[3];
    for (int c = 0; c < 3; ++c) {
      gd[c] -= gwo[c];
      gw[c] = gwb[c] * g.e[c];
      gt += gwb[c] * s.w[c] * g.e[c] * -s.ab[c];
      go[c] += gp[c];
      gt += gp[c] * s.d[c];
      gd[c] += gp[c] * g.t;
    }
    // t and the normal through the hit
    if (s.bits & HIT) {
      if (s.row >= 0) {
        const TriStep& T = g.T;
        if (T.det != 0.0f) {
          const float g_num = gt / T.safe;
          const float g_det = -gt * T.t / T.safe;
          float c1[3], c2[3], c3[3], c4[3], c5[3];
          cross3(T.e2, T.b, c1);   // d num / d e1
          cross3(T.b, T.e1, c2);   // d num / d e2
          cross3(T.e1, T.e2, c3);  // d num / d b, d det / d d
          cross3(T.e2, s.d, c4);   // d det / d e1
          cross3(s.d, T.e1, c5);   // d det / d e2
          float gv9[9];
          for (int c = 0; c < 3; ++c) {
            const float ge1 = g_num * c1[c] + g_det * c4[c];
            const float ge2 = g_num * c2[c] + g_det * c5[c];
            const float gb = g_num * c3[c];
            gd[c] += g_det * c3[c];
            go[c] -= gb;
            gv9[c] = ge1 + ge2 + gb;
            gv9[3 + c] = -ge1;
            gv9[6 + c] = -ge2;
          }
          if (scatter)
            for (int j = 0; j < 9; ++j)
              if (gv9[j] != 0.0f) atomicAdd(Q.d_tri + s.row * 9 + j, gv9[j]);
        }
      } else if (s.sph >= 0) {
        const SphereStep& S = g.Sp;
        const float* sp = P.sph + s.sph * SPH_COLS;
        // n = norm3(nrm pr), pr = (ol + t dl) - c
        float gmv[3], gpr[3], gol[3], gdl[3];
        norm3_vjp(S.m, gn, gmv);
        for (int c = 0; c < 3; ++c)
          gpr[c] = sp[12 + c] * gmv[0] + sp[15 + c] * gmv[1] +
                   sp[18 + c] * gmv[2];
        float g_ts = gt;
        for (int c = 0; c < 3; ++c) {
          gol[c] = gpr[c];
          gdl[c] = gpr[c] * S.t;
          g_ts += gpr[c] * S.dl[c];
        }
        // t = (-b + sgn sq) / denom
        const float g_b0 = -g_ts / S.denom;
        const float g_sq = S.sgn * g_ts / S.denom;
        const float g_den = -g_ts * S.t / S.denom;
        float g_a = S.a > 0.0f ? 2.0f * g_den : 0.0f;
        const float g_delta = S.delta > 0.0f ? g_sq * 0.5f / S.sq : 0.0f;
        const float g_b = g_b0 + 2.0f * S.b * g_delta;
        g_a += -4.0f * S.cc * g_delta;
        const float g_cc = -4.0f * S.a * g_delta;
        float goc[3];
        for (int c = 0; c < 3; ++c) {
          gdl[c] += 2.0f * S.dl[c] * g_a + 2.0f * S.oc[c] * g_b;
          goc[c] = 2.0f * S.dl[c] * g_b + 2.0f * S.oc[c] * g_cc;
          gol[c] += goc[c];
        }
        // ol = M o + m3, dl = M d
        for (int c = 0; c < 3; ++c) {
          go[c] += sp[c] * gol[0] + sp[4 + c] * gol[1] + sp[8 + c] * gol[2];
          gd[c] += sp[c] * gdl[0] + sp[4 + c] * gdl[1] + sp[8 + c] * gdl[2];
        }
      }
    }
    if (scatter && (s.bits & HIT)) {
      float* dst = sm_mat + s.mat * MAT_GRAD_COLS;
      for (int j = 0; j < MAT_GRAD_COLS; ++j)
        if (gm[j] != 0.0f) atomicAdd(dst + j, gm[j]);
    }
    for (int c = 0; c < 3; ++c) {
      go2[c] = go[c];
      gd2[c] = gd[c];
      gw2[c] = gw[c];
    }
  }
  for (int c = 0; c < 3; ++c) {
    Q.d_o[3 * i + c] = go2[c];
    Q.d_d[3 * i + c] = gd2[c];
  }
}

// the block's shared sums: materials, point and directional lights, bg
__device__ __forceinline__ int shared_floats(const Params& P) {
  return P.n_mat * MAT_GRAD_COLS + 3 * (P.n_point + P.n_dir) + 3;
}

template <bool kBwd, class G>
__device__ __forceinline__ void run(const BwdParams& Q,
                                    const float* __restrict__ o,
                                    const float* __restrict__ d,
                                    float* __restrict__ out) {
  extern __shared__ float sm[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kBwd) {
    const int ns = shared_floats(Q.g);
    for (int j = threadIdx.x; j < ns; j += blockDim.x) sm[j] = 0.0f;
    __syncthreads();
    if (i < Q.n) diff_ray<true, G>(Q, o, d, out, i, sm);
    __syncthreads();
    // one global atomic per block and value
    const Params& P = Q.g;
    const int n_mat = P.n_mat * MAT_GRAD_COLS, n_pl = 3 * P.n_point,
              n_dl = 3 * P.n_dir;
    for (int j = threadIdx.x; j < ns; j += blockDim.x) {
      const float v = sm[j];
      if (v == 0.0f) continue;
      float* dst = j < n_mat               ? Q.d_mat + j
                   : j < n_mat + n_pl      ? Q.d_pl + (j - n_mat)
                   : j < n_mat + n_pl + n_dl ? Q.d_dl + (j - n_mat - n_pl)
                                             : Q.d_bg + (j - n_mat - n_pl - n_dl);
      atomicAdd(dst, v);
    }
  } else {
    if (i < Q.n) diff_ray<false, G>(Q, o, d, out, i, nullptr);
  }
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_kernel(BwdParams Q, const float* __restrict__ o,
                       const float* __restrict__ d, float* __restrict__ out) {
  run<false, FlatChunks>(Q, o, d, out);
}

// the fwd+bwd instantiations at 4 blocks of 128 threads per SM (at most 128
// registers): left to itself ptxas takes 150 and 3 blocks, and the launch
// runs 15% slower on the gauge scene on an H100 (PERF.md)
constexpr int BWD_MIN_BLOCKS = 4;

__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
mega_bwd_kernel(BwdParams Q, const float* __restrict__ o,
                const float* __restrict__ d, float* __restrict__ out) {
  run<true, FlatChunks>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_tree_kernel(BwdParams Q, const float* __restrict__ o,
                            const float* __restrict__ d,
                            float* __restrict__ out) {
  run<false, ChunkTree>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
mega_bwd_tree_kernel(BwdParams Q, const float* __restrict__ o,
                     const float* __restrict__ d, float* __restrict__ out) {
  run<true, ChunkTree>(Q, o, d, out);
}

}  // namespace mb

// ---- C interface (loaded with ctypes) ----

// gbar null: the primal instantiation (the cotangent pointers unused), else
// the fwd+bwd one; nodes: the tree, or null (the chunk sweep).  consts =
// eps, ambient 3.  The cotangent buffers must be zeroed by the caller.
extern "C" int mega_bwd_launch(
    const float* o, const float* d, const float* gbar, float* out, int n,
    const float* tri, int n_tri, const float* chunk, int n_chunks,
    const float* nodes, const float* sph, int n_sph, const float* mat,
    int n_mat, const float* pl, int n_point, const float* dl, int n_dir,
    const float* bg, const float* consts, const float* ud, int depth,
    int max_depth, int flags, unsigned seed, unsigned step, float* d_tri,
    float* d_mat, float* d_pl, float* d_dl, float* d_bg, float* d_o,
    float* d_d, void* stream) {
  if (n <= 0 || depth < 1 || depth > mb::MAX_SEG ||
      n_point + n_dir > mb::VIS_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const float c7[7] = {consts[0], consts[1], consts[2], consts[3],
                       0.0f,      0.0f,      0.0f};
  mb::BwdParams Q;
  Q.g = mw::make_params(tri, n_tri, chunk, n_chunks, nodes, sph, n_sph, mat,
                        n_mat, pl, n_point, dl, n_dir, c7, max_depth, 0, depth,
                        flags);
  Q.bg = bg;
  Q.ud = ud;
  Q.gbar = gbar;
  Q.d_tri = d_tri;
  Q.d_mat = d_mat;
  Q.d_pl = d_pl;
  Q.d_dl = d_dl;
  Q.d_bg = d_bg;
  Q.d_o = d_o;
  Q.d_d = d_d;
  Q.n = n;
  Q.depth = depth;
  Q.seed = seed;
  Q.step = step;
  const int blocks = (n + mw::THREADS - 1) / mw::THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tree = nodes != nullptr;
  if (gbar == nullptr) {
    if (tree)
      mb::mega_bwd_primal_tree_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, o, d,
                                                                      out);
    else
      mb::mega_bwd_primal_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, o, d, out);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(
      n_mat * mb::MAT_GRAD_COLS + 3 * (n_point + n_dir) + 3);
  auto kern = tree ? mb::mega_bwd_tree_kernel : mb::mega_bwd_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<blocks, mw::THREADS, smem, st>>>(Q, o, d, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
