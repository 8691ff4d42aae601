// mega_pt.cu — the path-tracing megakernel (K1b) for NVIDIA Hopper (sm_90a).
//
// Replaces the path-tracing part of the TPU kernel
// advanced_cpu_raytracing_tpu/ops/pallas/megakernel.py::_kernel (lines
// 912-2690, launched by mega_trace_flat through pl.pallas_call at line
// 2785) together with the Whitted core it runs on: per ray, emissive hits
// (Le * 2pi, raytracer.cpp:81-84), the GI sample (Russian roulette,
// importance or uniform hemisphere direction, the GI ray traced at once so
// that next-event estimation skips the mesh light it hit;
// raytracer.cpp:135-191), ambient, point and directional light, mesh-light
// sampling (raytracer.cpp:778-803), mirror, conductor and dielectric
// children, and the GI child as the continuation or, where a specular chain
// continues, pushed after the refraction leg.  The plain version beside it
// is ops/megakernel.py::mega_trace_ref.
//
// Design.  As K1a (mega_whitted.cu), whose scene tables and ray queries it
// shares through mega_common.cuh: one thread per ray, 128 threads per
// block, one node per loop iteration.  A live ray's own node count equals
// the TPU kernel's block iteration `it` (a ray that stops never resumes), so
// it indexes the draws exactly as the TPU does.  Draws come from a table
// (max_iters * n_draws, n) when one is given, else from Philox4x32-10 keyed
// by (seed, sample) with counter (ray, it, slot / 4, 0) — the layout of
// ops/rng.py, whose torch twin computes the same words.  The stack holds
// up to MAX_K = 2 * (10 + 8) + 4 entries (path tracing with dielectrics and
// Russian roulette at depth 10) in local memory; a push past stack_k is
// dropped and a pop past it reads zeros, as on the TPU.
//
// Bound.  FP32 arithmetic on the CUDA cores, as K1a: ray x triangle, slab
// and sphere tests of the traced, GI and shadow rays; 36 bytes of rays in
// and out per ray.  Built with -fmad=false and IEEE division and sqrtf, it
// computes the plain version's expressions in their order; libdevice's
// expf/logf/sinf/cosf may round otherwise in the last bit.

#include "mega_common.cuh"

namespace mp {

using namespace mw;

constexpr int MAX_K = 40;
constexpr int ML_FACE_COLS = 10;   // corners v0 v1 v2, area weight
constexpr int ML_LIGHT_COLS = 5;   // radiance 3, first face, face count
constexpr int FLAG_PT = 8, FLAG_IMPORTANCE = 16, FLAG_NEE = 32, FLAG_RR = 64,
              FLAG_EMISSIVE = 128;
constexpr float TWO_PI = 6.283185307179586f;

struct PtParams {
  Params g;
  const float* mlf;  // mesh-light faces (n_mlf, ML_FACE_COLS)
  int n_mlf;
  const float* mll;  // mesh lights (n_ml, ML_LIGHT_COLS)
  int n_ml;
  const float* draws;  // (max_iters * n_draws, n) or null: Philox
  int n, n_draws, rr_floor;
  unsigned seed, sample;
};

// Philox4x32-10 (Random123): counter c, key (k0, k1)
__device__ __forceinline__ uint4 philox(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Draw `slot` of node iteration `it` of ray i (the JAX kernel's rnd)
__device__ __forceinline__ float rnd(const PtParams& Q, int i, int it,
                                     int slot) {
  if (Q.draws != nullptr) {
    const size_t row =
        static_cast<size_t>(min(it, Q.g.max_iters - 1) * Q.n_draws + slot);
    return __ldg(Q.draws + row * Q.n + i);
  }
  const uint4 w = philox(make_uint4(static_cast<unsigned>(i),
                                    static_cast<unsigned>(it),
                                    static_cast<unsigned>(slot >> 2), 0u),
                         Q.seed, Q.sample);
  const int k = slot & 3;
  const unsigned x = k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
  return static_cast<float>(x >> 9) * (1.0f / 8388608.0f);
}

// Axis-swap orthonormal basis (GetOrthonormalBasis, helperMath.cpp:59-85)
__device__ __forceinline__ void onb(float nx, float ny, float nz, float& ux,
                                    float& uy, float& uz, float& vx,
                                    float& vy, float& vz) {
  const float ax = fabsf(nx), ay = fabsf(ny), az = fabsf(nz);
  const bool use_x = ax < ay && ax < az;
  const bool use_y = !(ax < ay) && ay < az;
  const bool use_z = !(use_x || use_y);
  const float rpx = use_x ? 1.0f : nx;
  const float rpy = use_y ? 1.0f : ny;
  const float rpz = use_z ? 1.0f : nz;
  ux = rpy * nz - rpz * ny;
  uy = rpz * nx - rpx * nz;
  uz = rpx * ny - rpy * nx;
  norm3(ux, uy, uz);
  vx = ny * uz - nz * uy;
  vy = nz * ux - nx * uz;
  vz = nx * uy - ny * ux;
  norm3(vx, vy, vz);
}

// Default diffuse + Blinn-Phong with unit irradiance along unit w_i
// (GetDiffuse/GetSpecular, raytracer.cpp:540-554) for material row m.
__device__ __forceinline__ void shade_unit(const float* m, float nx, float ny,
                                           float nz, float wox, float woy,
                                           float woz, float wix, float wiy,
                                           float wiz, float& vx, float& vy,
                                           float& vz) {
  const float cos_t = fmaxf(0.0f, wix * nx + wiy * ny + wiz * nz);
  float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
  norm3(hx, hy, hz);
  const float cos_hm = fmaxf(0.0f, hx * nx + hy * ny + hz * nz);
  const float spec = powmax(cos_hm, m[13]);
  vx = m[4] * cos_t + m[7] * spec;
  vy = m[5] * cos_t + m[8] * spec;
  vz = m[6] * cos_t + m[9] * spec;
}

// The whole shading tree of ray i; radiance to out[3i:3i+3].
__device__ void shade_pt(const PtParams& Q, const float* __restrict__ o,
                         const float* __restrict__ d,
                         float* __restrict__ out, int i) {
  const Params& P = Q.g;
  float cox = o[3 * i], coy = o[3 * i + 1], coz = o[3 * i + 2];
  float cdx = d[3 * i], cdy = d[3 * i + 1], cdz = d[3 * i + 2];
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  float cwx = 1.0f, cwy = 1.0f, cwz = 1.0f;
  float cax = 0.0f, cay = 0.0f, caz = 0.0f, cmed = 1.0f;
  int cdep = P.max_depth;
  const bool diel = (P.flags & FLAG_DIELECTRIC) != 0;
  const bool any_spec = (P.flags & (FLAG_MIRROR | FLAG_DIELECTRIC |
                                    FLAG_CONDUCTOR)) != 0 && P.max_depth > 0;
  const bool pt = (P.flags & FLAG_PT) != 0;
  const bool importance = (P.flags & FLAG_IMPORTANCE) != 0;
  const bool rr = (P.flags & FLAG_RR) != 0;
  const bool emissive = (P.flags & FLAG_EMISSIVE) != 0;
  // PT without NEE samples no direct light at all, ambient included
  const bool sample_direct = !pt || (P.flags & FLAG_NEE) != 0;
  const bool has_amb = P.amb[0] != 0.0f || P.amb[1] != 0.0f ||
                       P.amb[2] != 0.0f;
  const float eps = P.eps;
  // stack entry: o3 d3 w3 a3 medium (13 f32) + depth
  float stk[MAX_K][13];
  int sdep[MAX_K];
  int sp = 0;
  bool act = true;

  for (int it = 0; act && it < P.max_iters; ++it) {
    const Hit h = trace<true>(P, cox, coy, coz, cdx, cdy, cdz);
    const float t_safe = h.hit ? h.t : 0.0f;
    if (diel) {  // Beer attenuation of this segment (raytracer.cpp:416-423)
      cwx = cwx * expf(-cax * t_safe);
      cwy = cwy * expf(-cay * t_safe);
      cwz = cwz * expf(-caz * t_safe);
    }
    if (!h.hit && it == 0) {  // primary miss: background
      lr += cwx * P.bg[0];
      lg += cwy * P.bg[1];
      lb += cwz * P.bg[2];
    }
    const float px = cox + t_safe * cdx;
    const float py = coy + t_safe * cdy;
    const float pz = coz + t_safe * cdz;
    const float wox = -cdx, woy = -cdy, woz = -cdz;
    const float nx = h.nx, ny = h.ny, nz = h.nz;
    const float* m = P.mat + h.mat * MAT_COLS;
    const int type = static_cast<int>(m[0]);
    const bool inside = diel && cmed > 1.00001f;

    bool shadeable = h.hit;
    if (emissive && h.hit && type == MAT_EMISSIVE) {
      // emissive hit: radiance * 2pi and nothing else
      lr += cwx * m[19] * TWO_PI;
      lg += cwy * m[20] * TWO_PI;
      lb += cwz * m[21] * TWO_PI;
      shadeable = false;
    }
    const bool lit = shadeable && !inside;

    // GI sample, traced now: NEE skips the mesh light the GI ray hit
    bool g_hit = false;
    int skip_ml = -1;
    float gox = 0.0f, goy = 0.0f, goz = 0.0f;
    float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;
    float rr_scale = 1.0f;
    if (pt) {
      bool gi_alive;
      if (rr) {
        const float maxw = fmaxf(cwx, fmaxf(cwy, cwz));
        const float prob = fminf(fmaxf(maxw, 1e-4f), 1.0f);
        const bool kill = cdep <= 0 && rnd(Q, i, it, 0) > prob;
        gi_alive = shadeable && !kill && cdep > -Q.rr_floor;
        rr_scale = cdep <= 0 ? 1.0f / prob : 1.0f;
      } else {
        gi_alive = shadeable && cdep > 0;
      }
      if (gi_alive) {
        const float r1 = rnd(Q, i, it, 1), r2 = rnd(Q, i, it, 2);
        const float phi = TWO_PI * r1;
        float sin_t, cos_t;
        if (importance) {  // theta = asin(sqrt(r2))
          sin_t = sqrtf(r2);
          cos_t = sqrtf(fmaxf(1.0f - r2, 0.0f));
        } else {  // theta = acos(r2)
          cos_t = r2;
          sin_t = sqrtf(fmaxf(1.0f - r2 * r2, 0.0f));
        }
        float ux, uy, uz, vx, vy, vz;
        onb(nx, ny, nz, ux, uy, uz, vx, vy, vz);
        const float sc = sin_t * cosf(phi), ss = sin_t * sinf(phi);
        gdx = ux * sc + nx * cos_t + vx * ss;
        gdy = uy * sc + ny * cos_t + vy * ss;
        gdz = uz * sc + nz * cos_t + vz * ss;
        norm3(gdx, gdy, gdz);
        // the reference's hard-coded GI epsilon (raytracer.cpp:174)
        gox = px + nx * 1e-4f;
        goy = py + ny * 1e-4f;
        goz = pz + nz * 1e-4f;
        const Hit g = trace<true>(P, gox, goy, goz, gdx, gdy, gdz);
        g_hit = g.hit;
        if (g_hit && g.ml >= 0) skip_ml = g.ml;
      }
    }

    if (lit && sample_direct) {  // direct light (raytracer.cpp:98-100, 701-806)
      if (has_amb) {
        lr += cwx * (P.amb[0] * m[1]);
        lg += cwy * (P.amb[1] * m[2]);
        lb += cwz * (P.amb[2] * m[3]);
      }
      const float sox = px + nx * eps, soy = py + ny * eps,
                  soz = pz + nz * eps;
      const int n_lights = P.n_point + P.n_dir + Q.n_ml;
      for (int l = 0; l < n_lights; ++l) {
        float wix, wiy, wiz, limit, ir, ig, ib;
        if (l < P.n_point) {
          const float* L = P.pl + l * LIGHT_COLS;
          const float tlx = L[0] - px, tly = L[1] - py, tlz = L[2] - pz;
          const float d2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
          limit = sqrtf(d2);
          const float inv = 1.0f / limit;
          wix = tlx * inv;
          wiy = tly * inv;
          wiz = tlz * inv;
          ir = L[3] / d2;
          ig = L[4] / d2;
          ib = L[5] / d2;
        } else if (l < P.n_point + P.n_dir) {
          const float* L = P.dl + (l - P.n_point) * LIGHT_COLS;
          wix = L[0];
          wiy = L[1];
          wiz = L[2];
          limit = BIG;
          ir = L[3];
          ig = L[4];
          ib = L[5];
        } else {
          // mesh light: a face picked uniformly, a sqrt-warped barycentric
          // point, irradiance = radiance * faceArea/surfaceArea * 2pi
          const int ml = l - P.n_point - P.n_dir;
          if (ml == skip_ml) continue;
          const float* L = Q.mll + ml * ML_LIGHT_COLS;
          const int first = static_cast<int>(L[3]);
          const int count = static_cast<int>(L[4]);
          const float uf = rnd(Q, i, it, 3 + 3 * ml);
          const int fsel =
              min(static_cast<int>(uf * static_cast<float>(count)), count - 1);
          const float* F = Q.mlf + (first + fsel) * ML_FACE_COLS;
          const float b1 = rnd(Q, i, it, 4 + 3 * ml);
          const float b2 = rnd(Q, i, it, 5 + 3 * ml);
          const float sq = sqrtf(b1);
          const float qx = F[3] * (1.0f - b2) + F[6] * b2;
          const float qy = F[4] * (1.0f - b2) + F[7] * b2;
          const float qz = F[5] * (1.0f - b2) + F[8] * b2;
          const float tx = F[0] * (1.0f - sq) + qx * sq - px;
          const float ty = F[1] * (1.0f - sq) + qy * sq - py;
          const float tz = F[2] * (1.0f - sq) + qz * sq - pz;
          const float d2 = fmaxf(tx * tx + ty * ty + tz * tz, 1e-20f);
          limit = sqrtf(d2);
          const float inv = 1.0f / limit;
          wix = tx * inv;
          wiy = ty * inv;
          wiz = tz * inv;
          const float wgt = F[9];
          ir = L[0] * wgt * TWO_PI;
          ig = L[1] * wgt * TWO_PI;
          ib = L[2] * wgt * TWO_PI;
        }
        if (shadow<true>(P, sox, soy, soz, wix, wiy, wiz, limit)) continue;
        float vx, vy, vz;
        shade_unit(m, nx, ny, nz, wox, woy, woz, wix, wiy, wiz, vx, vy, vz);
        lr += cwx * ir * vx;
        lg += cwy * ig * vy;
        lb += cwz * ib * vz;
      }
    }

    // children: the reflection leg continues in place, refraction pushes;
    // the GI child (only where the GI ray hit) continues or is pushed
    bool new_act = false;
    float nox = px, noy = py, noz = pz;
    float ndx = wox, ndy = woy, ndz = woz;
    float nwx = cwx, nwy = cwy, nwz = cwz;
    float nax = 0.0f, nay = 0.0f, naz = 0.0f, nmed = 1.0f;
    float giwx = 0.0f, giwy = 0.0f, giwz = 0.0f;
    if (g_hit) {  // weight Shade(w_i = gi, unit Li) * 2pi * rr_scale
      float vx, vy, vz;
      shade_unit(m, nx, ny, nz, wox, woy, woz, gdx, gdy, gdz, vx, vy, vz);
      const float fac = TWO_PI * rr_scale;
      giwx = cwx * vx * fac;
      giwy = cwy * vy * fac;
      giwz = cwz * vz * fac;
      if (!any_spec) {  // diffuse PT: the GI sample is the continuation
        new_act = true;
        nox = gox;
        noy = goy;
        noz = goz;
        ndx = gdx;
        ndy = gdy;
        ndz = gdz;
        nwx = giwx;
        nwy = giwy;
        nwz = giwz;
        nmed = cmed;
      }
    }
    if (any_spec && shadeable && cdep > 0) {
      if (type == MAT_MIRROR || type == MAT_CONDUCTOR) {
        const float ndotwo = nx * wox + ny * woy + nz * woz;
        float rx = 2.0f * nx * ndotwo - wox;
        float ry = 2.0f * ny * ndotwo - woy;
        float rz = 2.0f * nz * ndotwo - woz;
        norm3(rx, ry, rz);
        float f = 1.0f;
        bool go = true;
        if (type == MAT_CONDUCTOR) {  // conductor Fresnel (208-254)
          const float n2 = m[14], k2 = m[15], cos_t = ndotwo;
          const float n2k2 = n2 * n2 + k2 * k2;
          const float two = 2.0f * n2 * cos_t;
          const float cos2 = cos_t * cos_t;
          const float rs = (n2k2 - two + cos2) / fmaxf(n2k2 + two + cos2, 1e-20f);
          const float rp = (n2k2 * cos2 - two + 1.0f) /
                           fmaxf(n2k2 * cos2 + two + 1.0f, 1e-20f);
          f = 0.5f * (rs + rp);
          go = f > 1e-4f;
        }
        if (go) {
          new_act = true;
          nox = px + nx * eps;
          noy = py + ny * eps;
          noz = pz + nz * eps;
          ndx = rx;
          ndy = ry;
          ndz = rz;
          nwx = cwx * m[10];
          nwy = cwy * m[11];
          nwz = cwz * m[12];
          if (type == MAT_CONDUCTOR) {
            nwx = nwx * f;
            nwy = nwy * f;
            nwz = nwz * f;
          }
        }
      } else if (type == MAT_DIELECTRIC) {  // Fresnel split (261-415)
        const float ior = m[14];
        const float cos0 = -(cdx * nx + cdy * ny + cdz * nz);
        const bool entering = cos0 > 0.0f;
        const float sgn = entering ? 1.0f : -1.0f;
        const float nmx = nx * sgn, nmy = ny * sgn, nmz = nz * sgn;
        const float cos_i = fabsf(cos0);
        const float n1 = entering ? cmed : ior;
        const float n2 = entering ? ior : 1.0f;
        const float ratio_n = n1 / fmaxf(n2, 1e-20f);
        const float sin2 = 1.0f - cos_i * cos_i;
        const float crit = ratio_n * ratio_n * sin2;
        const float ndw = nmx * wox + nmy * woy + nmz * woz;
        float rdx = 2.0f * nmx * ndw - wox;
        float rdy = 2.0f * nmy * ndw - woy;
        float rdz = 2.0f * nmz * ndw - woz;
        norm3(rdx, rdy, rdz);
        new_act = true;
        nox = px + nmx * eps;
        noy = py + nmy * eps;
        noz = pz + nmz * eps;
        ndx = rdx;
        ndy = rdy;
        ndz = rdz;
        if (crit > 1.0f) {  // total internal reflection: weight, medium kept
          if (cmed > 1.0001f) {
            nax = m[16];
            nay = m[17];
            naz = m[18];
          }
          nmed = cmed;
        } else {
          const float cos_p = sqrtf(fmaxf(1.0f - crit, 0.0f));
          const float n2cos = n2 * cos_i, n1cosp = n1 * cos_p;
          const float rpar = (n2cos - n1cosp) / fmaxf(n2cos + n1cosp, 1e-20f);
          const float rperp = (n1 * cos_i - n2 * cos_p) /
                              fmaxf(n1 * cos_i + n2 * cos_p, 1e-20f);
          const float r_refl = 0.5f * (rpar * rpar + rperp * rperp);
          const float r_refr = 1.0f - r_refl;
          nwx = cwx * r_refl;
          nwy = cwy * r_refl;
          nwz = cwz * r_refl;
          if (n2 > 1.00001f) {
            nax = m[16];
            nay = m[17];
            naz = m[18];
          }
          nmed = n2;
          if (sp < P.stack_k) {  // refraction leg; dropped past K, as on TPU
            float fdx = (cdx + nmx * cos_i) * ratio_n - nmx * cos_p;
            float fdy = (cdy + nmy * cos_i) * ratio_n - nmy * cos_p;
            float fdz = (cdz + nmz * cos_i) * ratio_n - nmz * cos_p;
            norm3(fdx, fdy, fdz);
            const bool fin = n2 > 1.001f;
            float* e = stk[sp];
            e[0] = px - nmx * eps;
            e[1] = py - nmy * eps;
            e[2] = pz - nmz * eps;
            e[3] = fdx;
            e[4] = fdy;
            e[5] = fdz;
            e[6] = cwx * r_refr;
            e[7] = cwy * r_refr;
            e[8] = cwz * r_refr;
            e[9] = fin ? m[16] : 0.0f;
            e[10] = fin ? m[17] : 0.0f;
            e[11] = fin ? m[18] : 0.0f;
            e[12] = n2;
            sdep[sp] = cdep - 1;
          }
          ++sp;
        }
      }
    }
    if (any_spec && g_hit) {
      if (!new_act) {  // no specular chain: the GI child continues
        new_act = true;
        nox = gox;
        noy = goy;
        noz = goz;
        ndx = gdx;
        ndy = gdy;
        ndz = gdz;
        nwx = giwx;
        nwy = giwy;
        nwz = giwz;
        nax = 0.0f;
        nay = 0.0f;
        naz = 0.0f;
        nmed = cmed;
      } else {  // pushed after the refraction leg
        if (sp < P.stack_k) {
          float* e = stk[sp];
          e[0] = gox;
          e[1] = goy;
          e[2] = goz;
          e[3] = gdx;
          e[4] = gdy;
          e[5] = gdz;
          e[6] = giwx;
          e[7] = giwy;
          e[8] = giwz;
          e[9] = 0.0f;
          e[10] = 0.0f;
          e[11] = 0.0f;
          e[12] = cmed;
          sdep[sp] = cdep - 1;
        }
        ++sp;
      }
    }

    int ndep = cdep - 1;
    if (!new_act && sp > 0) {  // pop
      const int top = sp - 1;
      float e[13];
      for (int k = 0; k < 13; ++k) e[k] = top < P.stack_k ? stk[top][k] : 0.0f;
      ndep = top < P.stack_k ? sdep[top] : 0;
      nox = e[0];
      noy = e[1];
      noz = e[2];
      ndx = e[3];
      ndy = e[4];
      ndz = e[5];
      nwx = e[6];
      nwy = e[7];
      nwz = e[8];
      nax = e[9];
      nay = e[10];
      naz = e[11];
      nmed = e[12];
      --sp;
      new_act = true;
    }
    cox = nox;
    coy = noy;
    coz = noz;
    cdx = ndx;
    cdy = ndy;
    cdz = ndz;
    cwx = nwx;
    cwy = nwy;
    cwz = nwz;
    cax = nax;
    cay = nay;
    caz = naz;
    cmed = nmed;
    cdep = ndep;
    act = new_act;
  }
  out[3 * i] = lr;
  out[3 * i + 1] = lg;
  out[3 * i + 2] = lb;
}

// ---- kernel and C interface (loaded with ctypes) ----

__global__ void __launch_bounds__(THREADS)
mega_pt_kernel(PtParams Q, const float* __restrict__ o,
               const float* __restrict__ d, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n) shade_pt(Q, o, d, out, i);
}

}  // namespace mp

// ints: max_depth, stack_k, max_iters, flags, n_draws, rr_floor
extern "C" int mega_pt_launch(
    const float* o, const float* d, float* out, int n, const float* tri,
    int n_tri, const float* chunk, int n_chunks, const float* sph, int n_sph,
    const float* mat, int n_mat, const float* pl, int n_point,
    const float* dl, int n_dir, const float* consts, const float* mlf,
    int n_mlf, const float* mll, int n_ml, const int* ints,
    const float* draws, unsigned seed, unsigned sample, void* stream) {
  if (ints[1] > mp::MAX_K || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  mp::PtParams Q;
  Q.g = mw::make_params(tri, n_tri, chunk, n_chunks, sph, n_sph, mat, n_mat,
                        pl, n_point, dl, n_dir, consts, ints[0], ints[1],
                        ints[2], ints[3]);
  Q.mlf = mlf;
  Q.n_mlf = n_mlf;
  Q.mll = mll;
  Q.n_ml = n_ml;
  Q.draws = draws;
  Q.n = n;
  Q.n_draws = ints[4];
  Q.rr_floor = ints[5];
  Q.seed = seed;
  Q.sample = sample;
  const int blocks = (n + mw::THREADS - 1) / mw::THREADS;
  mp::mega_pt_kernel<<<blocks, mw::THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(Q, o, d, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
