// mega_pt.cu — the path-tracing megakernel (K1b), its extension with spot
// and area lights, BRDFs, roughness and motion blur (K1c), and that with
// textures and the environment light (K1d) for NVIDIA Hopper (sm_90a).
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
// K1c (mega_ext_kernel, and mega_ext_motion_kernel for scenes with motion
// blur) is the same shading tree, instantiated with the extension tables
// (ExtParams): spot lights (spotLight.h:33-57, cone tests
// in cosine space) and area lights (areaLight.h:34-41, one uniform point on
// the square) after the directional lights, the pluggable BRDFs
// (raytracer.cpp:192-206, brdf*.cpp) switched on each material's kind for
// every light and the GI weight, glossy roughness (raytracer.cpp:424-440)
// on the mirror, conductor and both dielectric legs, and motion blur: one
// time per primary ray, drawn at iteration 0 from the last slot, moving
// every ray query of its tree (megakernel.py:1379-1382, 1421-1425,
// 1776-1779, 2145-2304, 2410-2562).  Lights are loops over device tables,
// so any number of spot and area lights works (the TPU kernel unrolls at
// most 4 of each).  K1b is the instantiation with NoExt, whose code is that
// of the static scene; mega_pt_launch picks the instantiation.
//
// K1d (mega_tex_kernel, mega_tex_motion_kernel) is K1c's tree with a third
// policy, TexParams (mega_tex.cuh; NoTex for K1b and K1c compiles none of
// it): the trace names its winner, whose texture slots, UV and tangent
// frame shade it (Perlin and image bumps, normal maps, replace_all,
// diffuse and specular textures); a primary miss sees the
// replace_background texture at the ray's pixel UV, else the env map, and
// a mirror or dielectric child's miss sees the env map (the env-on-miss
// flag rides the stack); the env light's direct term takes the first of 16
// rejection candidates, draw slots 3 + 3 n_ml + 2 n_area onwards, before
// the roughness pair (megakernel.py:1548-2135, 2352-2374, 2383-2678).
//
// K1e (the *_tree_kernel entries) is each of these five over a tree in
// place of the 128-face chunk sweep, for every scene past one chunk on the
// forward route (render_camera): the geometry policy ChunkTree of
// mega_common.cuh (FlatChunks for the others).
//
// Design.  As K1a (mega_whitted.cu), whose scene tables and ray queries it
// shares through mega_common.cuh: one thread per ray, 128 threads per
// block, one node per loop iteration.  A live ray's own node count equals
// the TPU kernel's block iteration `it` (a ray that stops never resumes), so
// it indexes the draws exactly as the TPU does.  Draws come from a table
// (max_iters * n_draws, n) when one is given, else from Philox4x32-10 keyed
// by (seed, sample) with counter (ray, it, slot / 4, 0) — the layout of
// ops/rng.py, whose torch twin computes the same words.  A Philox block is
// 10 rounds of two __umulhi and two 32-bit multiplies, about 90 integer
// instructions, and its four words are four neighbouring slots; the
// kernels used to run one per draw and keep one word.  A node's draws
// (Russian roulette 0, the GI pair 1-2, a mesh light's three, an area
// light's pair, up to 16 env candidates of three, the roughness pairs) go
// in slot order through a cursor (Draws) that keeps its last block, so
// each block is computed once for its words, bit for bit the same words
// (ops/megakernel.py::mega_trace_ref counts the draws and the blocks;
// chip_smoke.py phases 8, 11 and 14 report both per ray).  The stack holds
// up to MAX_K = 2 * (10 + 8) + 4 entries (path tracing with dielectrics and
// Russian roulette at depth 10) in local memory; a push past stack_k is
// dropped and a pop past it reads zeros, as on the TPU.
//
// Bound.  FP32 arithmetic on the CUDA cores, as K1a: ray x triangle, slab
// and sphere tests of the traced, GI and shadow rays; 36 bytes of rays in
// and out per ray.  Built with -fmad=false and IEEE division and sqrtf, it
// computes the plain version's expressions in their order; libdevice's
// expf/logf/sinf/cosf may round otherwise in the last bit.  K1c adds the
// shadow rays of its spot and area lights and 6 FP32 operations per test
// of a moving face or sphere; the BRDF constants that the JAX kernel folds in double
// precision come folded from the host (ops/megakernel.py, MATX_COLS).
// What bounds them on an NVIDIA H100 80GB HBM3 (700.00 W) is not that
// work: each thread runs its own divergent chain of dependent loads (the
// tree walks of the traced, shadow and child rays, texel and table reads)
// at 4-7 resident blocks of 128 threads an SM, and K1a-K1d reach 2-7% of
// the FP32 bound.  The per-draw
// Philox was 4% of K1b's and K1d's time: the cursor took it out (K1b
// 0.313 -> 0.304 ms, K1d 1.171 -> 1.125 on their main paths' rays), and
// K1b held to 72 registers runs 7 blocks an SM (0.290 ms).  On K1d's
// feat_textures.xml, leaving out the shadow rays saves 37% of its time,
// the env light's term 18% (its rejection loop, atan2f/acosf and a texel
// on every lit node), the texture work 16%, Perlin 5% (PERF.md section 6,
// PR 14's design table); capping K1d's registers spills and gains nothing
// on that scene.

#include "mega_common.cuh"
#include "mega_tex.cuh"

namespace mp {

using namespace mw;
using mt::NoTex;
using mt::TexParams;

constexpr int MAX_K = 40;
constexpr int ML_FACE_COLS = 10;   // corners v0 v1 v2, area weight
constexpr int ML_LIGHT_COLS = 5;   // radiance 3, first face, face count
constexpr int FLAG_PT = 8, FLAG_IMPORTANCE = 16, FLAG_NEE = 32, FLAG_RR = 64,
              FLAG_EMISSIVE = 128, FLAG_ROUGH = 256, FLAG_MOTION = 512;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float PI_F = 3.141592653589793f;
constexpr float INV_PI = 0.3183098861837907f;  // 1/pi rounded once
constexpr int SPOT_COLS = 12;  // pos 3, dir 3, intensity 3, cos(cov/2),
                               // cos(fall/2), falloff denominator
constexpr int AREA_COLS = 17;  // pos 3, normal 3, radiance 3, extent, area,
                               // u 3, v 3
constexpr int MATX_COLS = 11;  // roughness, BRDF kind, exponent, normalized,
                               // kdfresnel, lobe factor, diffuse term 3,
                               // r0, 1 - r0
constexpr int BRDF_PHONG = 0, BRDF_MODIFIED_PHONG = 1, BRDF_BLINN_PHONG = 2,
              BRDF_MODIFIED_BLINN_PHONG = 3;  // 4: Torrance-Sparrow
constexpr float ROUGH_MIN = 0.001f;
constexpr int ENV_DRAWS = 48;  // 16 env candidates x 3 draws

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

// K1b: no extension tables
struct NoExt {
  static constexpr bool kOn = false;
};

// K1c: spot and area lights, material extras, motion.  Passed by pointer
// to mega_pt_launch (null for K1b); ops/megakernel.py mirrors the layout.
struct ExtParams {
  static constexpr bool kOn = true;
  const float* sl;  // spot lights (n_spot, SPOT_COLS)
  int n_spot;
  const float* al;  // area lights (n_area, AREA_COLS)
  int n_area;
  const float* mx;   // material extras (n_mat, MATX_COLS)
  const float* tmo;  // per-face world motion (n_tri, 3), null if none moves
  const float* smo;  // per-sphere object-space motion (n_sph, 3), or null
};

// The draws of node iteration `it` of ray i (the JAX kernel's rnd(it,
// slot)): table row min(it, max_iters - 1) * n_draws + slot, or word
// slot % 4 of the Philox block (i, it, slot / 4).  The cursor keeps the
// last block it computed and computes another only when a slot leaves it,
// so a node's draws, made in slot order, cost one Philox4x32-10 per block
// and not one per draw; the words are the same either way.
struct Draws {
  const PtParams& Q;
  const int i, it;
  int blk = -1;
  uint4 w;

  __device__ __forceinline__ Draws(const PtParams& q, int ray, int iter)
      : Q(q), i(ray), it(iter) {}

  __device__ __forceinline__ float operator()(int slot) {
    if (Q.draws != nullptr) {
      const size_t row =
          static_cast<size_t>(min(it, Q.g.max_iters - 1) * Q.n_draws + slot);
      return __ldg(Q.draws + row * Q.n + i);
    }
    if ((slot >> 2) != blk) {
      blk = slot >> 2;
      w = philox(make_uint4(static_cast<unsigned>(i),
                            static_cast<unsigned>(it),
                            static_cast<unsigned>(blk), 0u),
                 Q.seed, Q.sample);
    }
    const int k = slot & 3;
    const unsigned x = k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
    return static_cast<float>(x >> 9) * (1.0f / 8388608.0f);
  }
};

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

// shade_unit with a reflectance kd, ks of the ray's own (K1d: textured)
__device__ __forceinline__ void shade_kd(const float* kd, const float* ks,
                                         float phong, float nx, float ny,
                                         float nz, float wox, float woy,
                                         float woz, float wix, float wiy,
                                         float wiz, float& vx, float& vy,
                                         float& vz) {
  const float cos_t = fmaxf(0.0f, wix * nx + wiy * ny + wiz * nz);
  float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
  norm3(hx, hy, hz);
  const float cos_hm = fmaxf(0.0f, hx * nx + hy * ny + hz * nz);
  const float spec = powmax(cos_hm, phong);
  vx = kd[0] * cos_t + ks[0] * spec;
  vy = kd[1] * cos_t + ks[1] * spec;
  vz = kd[2] * cos_t + ks[2] * spec;
}

// A pluggable BRDF's value times cos+, gated to the front side, with unit
// irradiance (megakernel.py:2159-2221) for material row m with extras mx
// (kind mx[1] >= 0).
__device__ __forceinline__ void brdf_unit(const float* m, const float* mx,
                                          float nx, float ny, float nz,
                                          float wox, float woy, float woz,
                                          float wix, float wiy, float wiz,
                                          float& vx, float& vy, float& vz) {
  const int kind = static_cast<int>(mx[1]);
  const float e = mx[2];
  float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
  norm3(hx, hy, hz);
  const float ndwi = wix * nx + wiy * ny + wiz * nz;
  const float cos_ic = fminf(fmaxf(ndwi, -1.0f), 1.0f);
  const bool front = cos_ic > 0.0f;
  const float cos_pos = fmaxf(cos_ic, 0.0f);
  const float cos_den = fmaxf(cos_ic, 1e-20f);
  const float cos_hc = fminf(fmaxf(hx * nx + hy * ny + hz * nz, -1.0f), 1.0f);
  float dr = mx[6], dg = mx[7], db = mx[8];
  float lobe;
  if (kind == BRDF_PHONG || kind == BRDF_MODIFIED_PHONG) {
    // lobe around the mirror direction of w_i
    float rlx = 2.0f * nx * ndwi - wix;
    float rly = 2.0f * ny * ndwi - wiy;
    float rlz = 2.0f * nz * ndwi - wiz;
    norm3(rlx, rly, rlz);
    const float cos_r =
        fminf(fmaxf(rlx * wox + rly * woy + rlz * woz, -1.0f), 1.0f);
    const float pw = powmax(cos_r, e);
    lobe = kind == BRDF_PHONG ? pw / cos_den : mx[5] * pw;
  } else if (kind == BRDF_BLINN_PHONG) {
    lobe = powmax(cos_hc, e) / cos_den;
  } else if (kind == BRDF_MODIFIED_BLINN_PHONG) {
    lobe = mx[5] * powmax(cos_hc, e);
  } else {  // Torrance-Sparrow (brdfTorranceSparrow.cpp:15-66)
    const float d_t = mx[5] * powmax(cos_hc, e);
    const float hdwo = hx * wox + hy * woy + hz * woz;
    const float om = fmaxf(1.0f - hdwo, 0.0f);
    const float f_t = mx[9] + mx[10] * om * om * om * om * om;
    const float ndwo = nx * wox + ny * woy + nz * woz;
    const float wodh = hdwo == 0.0f ? 1e-20f : hdwo;
    const float g_t = fminf(1.0f, fminf(2.0f * cos_hc * ndwo / wodh,
                                        2.0f * cos_hc * ndwi / wodh));
    const float kd_c = mx[4] > 0.5f ? (1.0f - f_t) / PI_F : INV_PI;
    const float nn = ndwi * ndwo;
    const float den = 4.0f * (nn == 0.0f ? 1e-20f : nn);
    lobe = d_t * f_t * g_t / den;
    dr = dr * kd_c;
    dg = dg * kd_c;
    db = db * kd_c;
  }
  vx = (front ? dr + m[7] * lobe : 0.0f) * cos_pos;
  vy = (front ? dg + m[8] * lobe : 0.0f) * cos_pos;
  vz = (front ? db + m[9] * lobe : 0.0f) * cos_pos;
}

// The material's BRDF where it has one (K1c), else shade_unit
template <class Ext>
__device__ __forceinline__ void shade(const float* m, const float* mx,
                                      float nx, float ny, float nz, float wox,
                                      float woy, float woz, float wix,
                                      float wiy, float wiz, float& vx,
                                      float& vy, float& vz) {
  if constexpr (Ext::kOn) {
    if (mx[1] >= 0.0f) {
      brdf_unit(m, mx, nx, ny, nz, wox, woy, woz, wix, wiy, wiz, vx, vy, vz);
      return;
    }
  }
  shade_unit(m, nx, ny, nz, wox, woy, woz, wix, wiy, wiz, vx, vy, vz);
}

// Glossy perturbation (Raytracer::Reflect, raytracer.cpp:424-440): a
// becomes unit(a + (u p1 + v p2) roughness), (u, v) the basis around
// unit(a), where the material is rough, else unit(a); p1, p2 are draws
// `slot` and `slot` + 1, less 0.5.
__device__ __forceinline__ void perturb(float& ax, float& ay, float& az,
                                        Draws& rnd, int slot, float rough) {
  const float p1 = rnd(slot) - 0.5f;
  const float p2 = rnd(slot + 1) - 0.5f;
  float bx = ax, by = ay, bz = az;
  norm3(bx, by, bz);
  if (rough > ROUGH_MIN) {
    float ux, uy, uz, vx, vy, vz;
    onb(bx, by, bz, ux, uy, uz, vx, vy, vz);
    bx = ax + (ux * p1 + vx * p2) * rough;
    by = ay + (uy * p1 + vy * p2) * rough;
    bz = az + (uz * p1 + vz * p2) * rough;
    norm3(bx, by, bz);
  }
  ax = bx;
  ay = by;
  az = bz;
}

// Spot light l < n_spot (spotLight.h:33-57; the falloff ((cos a -
// cos(cov/2)) / (cos(fall/2) - cos(cov/2)))^4 in cosine space) or area
// light l - n_spot (areaLight.h:34-41; one uniform point on the square,
// area |n.w| / d^2): direction, distance and irradiance at p.
template <class Ext>
__device__ __forceinline__ void ext_light(const PtParams& Q, const Ext& E,
                                          Draws& rnd, int l, float px,
                                          float py, float pz, float& wix,
                                          float& wiy, float& wiz,
                                          float& limit, float& ir, float& ig,
                                          float& ib) {
  if constexpr (Ext::kOn) {
    float tlx, tly, tlz;
    const float* L = E.sl;
    const float* A = E.al;
    if (l < E.n_spot) {
      L = E.sl + l * SPOT_COLS;
      tlx = L[0] - px;
      tly = L[1] - py;
      tlz = L[2] - pz;
    } else {
      const int a = l - E.n_spot;
      A = E.al + a * AREA_COLS;
      const int slot = 3 + 3 * Q.n_ml + 2 * a;
      const float o1 = rnd(slot) - 0.5f;
      const float o2 = rnd(slot + 1) - 0.5f;
      const float ext = A[9];
      tlx = A[0] + A[11] * (ext * o1) + A[14] * (ext * o2) - px;
      tly = A[1] + A[12] * (ext * o1) + A[15] * (ext * o2) - py;
      tlz = A[2] + A[13] * (ext * o1) + A[16] * (ext * o2) - pz;
    }
    const float d2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
    limit = sqrtf(d2);
    const float inv = 1.0f / limit;
    wix = tlx * inv;
    wiy = tly * inv;
    wiz = tlz * inv;
    if (l < E.n_spot) {
      const float cos_a =
          fminf(fmaxf(-(L[3] * wix + L[4] * wiy + L[5] * wiz), -1.0f), 1.0f);
      const float irr = 1.0f / d2;
      const float scale = spot_falloff(L, cos_a);
      ir = L[6] * irr * scale;
      ig = L[7] * irr * scale;
      ib = L[8] * irr * scale;
    } else {
      const float irr = A[10] * fabsf(A[3] * wix + A[4] * wiy + A[5] * wiz) / d2;
      ir = A[6] * irr;
      ig = A[7] * irr;
      ib = A[8] * irr;
    }
  }
}

// The whole shading tree of ray i; radiance to out[3i:3i+3].  M is the
// scene's motion (Motion only with ExtParams), T its textures and env
// light (TexParams only with ExtParams), G its geometry (the 128-face
// chunks, or the tree of K1e).
template <class Ext, class M = NoMotion, class T = NoTex,
          class G = FlatChunks>
__device__ void shade_pt(const PtParams& Q, const Ext& E, const T& X,
                         const float* __restrict__ o,
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
  // stack entry: o3 d3 w3 a3 medium (13 f32), K1d: + env-on-miss flag;
  // + depth
  constexpr int NS = T::kOn ? 14 : 13;
  float stk[MAX_K][NS];
  int sdep[MAX_K];
  int sp = 0;
  bool act = true;
  bool cenv = false;  // K1d: this ray's miss sees the env map
  // K1c: the scene at this ray's time, drawn once (megakernel.py:1776-1779)
  M mo{};
  if constexpr (M::kOn) {
    mo.tri = E.tmo;
    mo.sph = E.smo;
    mo.tau = Draws(Q, i, 0)(Q.n_draws - 1);
  }
  int n_sa = 0;  // spot and area lights
  int base_rough = 0;
  if constexpr (Ext::kOn) {
    n_sa = E.n_spot + E.n_area;
    base_rough = 3 + 3 * Q.n_ml + 2 * E.n_area;
  }
  int base_env = 0;  // K1d: the env candidates' draws precede roughness's
  if constexpr (T::kOn) {
    base_env = base_rough;
    if (X.env_w > 0) base_rough += ENV_DRAWS;
  }

  for (int it = 0; act && it < P.max_iters; ++it) {
    Draws rnd(Q, i, it);  // this node's draws
    Hit h;
    mt::Surface S;
    if constexpr (T::kOn) {
      int win[2];  // the winning face, the winning sphere
      h = trace<true, M, true, G>(P, cox, coy, coz, cdx, cdy, cdz, mo, win);
      if (X.n_tex > 0)
        mt::surface(P, X, h, win[0], win[1], cox, coy, coz, cdx, cdy, cdz, mo,
                    S);
    } else {
      h = trace<true, M, false, G>(P, cox, coy, coz, cdx, cdy, cdz, mo);
    }
    const float t_safe = h.hit ? h.t : 0.0f;
    if (diel) {  // Beer attenuation of this segment (raytracer.cpp:416-423)
      cwx = cwx * expf(-cax * t_safe);
      cwy = cwy * expf(-cay * t_safe);
      cwz = cwz * expf(-caz * t_safe);
    }
    if constexpr (T::kOn) {
      // a primary miss sees the background texture at the pixel UV, else
      // the env map, else the flat colour; a later miss the env map where
      // its branch is flagged (raytracer.cpp:49-62)
      if (!h.hit) {
        float r = 0.0f, g = 0.0f, b = 0.0f;
        if (X.bg_tex >= 0 && it == 0) {
          mt::img_sample(X, X.bg_tex, X.pix_uv[2 * i], X.pix_uv[2 * i + 1],
                         true, r, g, b);
        } else if (X.env_w > 0) {
          if (cenv || it == 0) mt::env_radiance(X, cdx, cdy, cdz, r, g, b);
        } else if (it == 0) {
          r = P.bg[0];
          g = P.bg[1];
          b = P.bg[2];
        }
        lr += cwx * r;
        lg += cwy * g;
        lb += cwz * b;
      }
    } else if (!h.hit && it == 0) {  // primary miss: background
      lr += cwx * P.bg[0];
      lg += cwy * P.bg[1];
      lb += cwz * P.bg[2];
    }
    const float px = cox + t_safe * cdx;
    const float py = coy + t_safe * cdy;
    const float pz = coz + t_safe * cdz;
    const float wox = -cdx, woy = -cdy, woz = -cdz;
    float nx = h.nx, ny = h.ny, nz = h.nz;
    if constexpr (T::kOn) {
      if (X.n_tex > 0) mt::shading_normal(X, S, px, py, pz, nx, ny, nz);
    }
    const float* m = P.mat + h.mat * MAT_COLS;
    const float* mx = nullptr;
    if constexpr (Ext::kOn) mx = E.mx + h.mat * MATX_COLS;
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
    // K1d: the ray's reflectances; replace_all shades with the raw sample
    // alone (raytracer.cpp:87-89)
    float kd[3], ks[3];
    if constexpr (T::kOn) {
      for (int c = 0; c < 3; ++c) {
        kd[c] = m[4 + c];
        ks[c] = m[7 + c];
      }
      if (X.n_tex > 0 && h.hit) {
        if (shadeable && S.slot[3] >= 0) {
          float r, g, b;
          mt::img_sample(X, S.slot[3], S.u, S.v, true, r, g, b);
          lr += cwx * r;
          lg += cwy * g;
          lb += cwz * b;
        }
        if (S.slot[3] >= 0) shadeable = false;
        mt::reflectance(X, S.slot[0], S, px, py, pz, kd);
        mt::reflectance(X, S.slot[1], S, px, py, pz, ks);
      }
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
        const bool kill = cdep <= 0 && rnd(0) > prob;
        gi_alive = shadeable && !kill && cdep > -Q.rr_floor;
        rr_scale = cdep <= 0 ? 1.0f / prob : 1.0f;
      } else {
        gi_alive = shadeable && cdep > 0;
      }
      if (gi_alive) {
        const float r1 = rnd(1);
        const float r2 = rnd(2);
        gi_direction(nx, ny, nz, r1, r2, importance, gdx, gdy, gdz);
        // the reference's hard-coded GI epsilon (raytracer.cpp:174)
        gox = px + nx * 1e-4f;
        goy = py + ny * 1e-4f;
        goz = pz + nz * 1e-4f;
        const Hit g =
            trace<true, M, false, G>(P, gox, goy, goz, gdx, gdy, gdz, mo);
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
      const int n_lights = P.n_point + P.n_dir + n_sa + Q.n_ml;
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
        } else if (Ext::kOn && l < P.n_point + P.n_dir + n_sa) {
          ext_light(Q, E, rnd, l - P.n_point - P.n_dir, px, py, pz, wix, wiy,
                    wiz, limit, ir, ig, ib);
        } else {
          // mesh light: a face picked uniformly, a sqrt-warped barycentric
          // point, irradiance = radiance * faceArea/surfaceArea * 2pi
          const int ml = l - P.n_point - P.n_dir - n_sa;
          if (ml == skip_ml) continue;
          const float* L = Q.mll + ml * ML_LIGHT_COLS;
          const int first = static_cast<int>(L[3]);
          const int count = static_cast<int>(L[4]);
          const float uf = rnd(3 + 3 * ml);
          const int fsel =
              min(static_cast<int>(uf * static_cast<float>(count)), count - 1);
          const float* F = Q.mlf + (first + fsel) * ML_FACE_COLS;
          const float b1 = rnd(4 + 3 * ml);
          const float b2 = rnd(5 + 3 * ml);
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
        if (shadow<true, M, G>(P, sox, soy, soz, wix, wiy, wiz, limit, mo))
          continue;
        float vx, vy, vz;
        if constexpr (T::kOn) {
          if (mx[1] >= 0.0f)
            brdf_unit(m, mx, nx, ny, nz, wox, woy, woz, wix, wiy, wiz, vx, vy, vz);
          else
            shade_kd(kd, ks, m[13], nx, ny, nz, wox, woy, woz, wix, wiy, wiz,
                     vx, vy, vz);
        } else {
          shade<Ext>(m, mx, nx, ny, nz, wox, woy, woz, wix, wiy, wiz, vx, vy,
                     vz);
        }
        lr += cwx * ir * vx;
        lg += cwy * ig * vy;
        lb += cwz * ib * vz;
      }
      if constexpr (T::kOn) {
        if (X.env_w > 0) {
          // the env light (raytracer.cpp:741-755): the first of 16
          // rejection candidates in the unit ball above the surface, else
          // the normal; its radiance shaded with the normal as w_i and no
          // shadow ray (reference quirks, kept)
          float ex = nx, ey = ny, ez = nz;
          for (int ci = 0; ci < 16; ++ci) {
            const float cx = 2.0f * rnd(base_env + 3 * ci) - 1.0f;
            const float cy = 2.0f * rnd(base_env + 3 * ci + 1) - 1.0f;
            const float cz = 2.0f * rnd(base_env + 3 * ci + 2) - 1.0f;
            if (cx * cx + cy * cy + cz * cz <= 1.0f &&
                cx * nx + cy * ny + cz * nz > 0.0f) {
              ex = cx;
              ey = cy;
              ez = cz;
              break;
            }
          }
          float er, eg, eb, vx, vy, vz;
          mt::env_radiance(X, ex, ey, ez, er, eg, eb);
          if (mx[1] >= 0.0f)
            brdf_unit(m, mx, nx, ny, nz, wox, woy, woz, nx, ny, nz, vx, vy, vz);
          else
            shade_kd(kd, ks, m[13], nx, ny, nz, wox, woy, woz, nx, ny, nz, vx,
                     vy, vz);
          lr += cwx * er * vx;
          lg += cwy * eg * vy;
          lb += cwz * eb * vz;
        }
      }
    }

    // children: the reflection leg continues in place, refraction pushes;
    // the GI child (only where the GI ray hit) continues or is pushed
    bool new_act = false;
    float nox = px, noy = py, noz = pz;
    float ndx = wox, ndy = woy, ndz = woz;
    float nwx = cwx, nwy = cwy, nwz = cwz;
    float nax = 0.0f, nay = 0.0f, naz = 0.0f, nmed = 1.0f;
    bool ncenv = false;
    float giwx = 0.0f, giwy = 0.0f, giwz = 0.0f;
    if (g_hit) {  // weight Shade(w_i = gi, unit Li) * 2pi * rr_scale
      float vx, vy, vz;
      if constexpr (T::kOn) {
        if (mx[1] >= 0.0f)
          brdf_unit(m, mx, nx, ny, nz, wox, woy, woz, gdx, gdy, gdz, vx, vy, vz);
        else
          shade_kd(kd, ks, m[13], nx, ny, nz, wox, woy, woz, gdx, gdy, gdz, vx,
                   vy, vz);
      } else {
        shade<Ext>(m, mx, nx, ny, nz, wox, woy, woz, gdx, gdy, gdz, vx, vy,
                   vz);
      }
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
        if constexpr (Ext::kOn) {
          if (P.flags & FLAG_ROUGH)
            perturb(rx, ry, rz, rnd, base_rough, mx[0]);
        }
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
          // a mirror child's miss sees the env (raytracer.cpp:461-469)
          if (type == MAT_MIRROR) ncenv = true;
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
        if constexpr (Ext::kOn) {  // the same psi pair as the mirror's
          if (P.flags & FLAG_ROUGH)
            perturb(rdx, rdy, rdz, rnd, base_rough, mx[0]);
        }
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
          ncenv = true;  // both legs' misses see the env; TIR's does not
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
            if constexpr (Ext::kOn) {
              if (P.flags & FLAG_ROUGH)  // perturbed on the raw vector
                perturb(fdx, fdy, fdz, rnd, base_rough + 2, mx[0]);
              else
                norm3(fdx, fdy, fdz);
            } else {
              norm3(fdx, fdy, fdz);
            }
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
            if constexpr (T::kOn) e[13] = 1.0f;
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
        ncenv = false;
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
          if constexpr (T::kOn) e[13] = 0.0f;
          sdep[sp] = cdep - 1;
        }
        ++sp;
      }
    }

    int ndep = cdep - 1;
    if (!new_act && sp > 0) {  // pop
      const int top = sp - 1;
      float e[NS];
      for (int k = 0; k < NS; ++k) e[k] = top < P.stack_k ? stk[top][k] : 0.0f;
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
      if constexpr (T::kOn) ncenv = e[13] != 0.0f;
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
    cenv = ncenv;
    act = new_act;
  }
  out[3 * i] = lr;
  out[3 * i + 1] = lg;
  out[3 * i + 2] = lb;
}

// ---- kernel and C interface (loaded with ctypes) ----

// K1b held to 72 registers (7 blocks of 128 threads an SM, from 6 at its
// 80; 82 bytes of spills): 0.304 -> 0.290 ms on feat_pt.xml's 640,000 rays
// on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6, PR 14)
__global__ void __launch_bounds__(THREADS, 7)
mega_pt_kernel(PtParams Q, const float* __restrict__ o,
               const float* __restrict__ d, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n) shade_pt(Q, NoExt(), NoTex(), o, d, out, i);
}

// K1c on a static scene
__global__ void __launch_bounds__(THREADS)
mega_ext_kernel(PtParams Q, ExtParams E, const float* __restrict__ o,
                const float* __restrict__ d, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n) shade_pt(Q, E, NoTex(), o, d, out, i);
}

// K1c on a scene with motion blur
__global__ void __launch_bounds__(THREADS)
mega_ext_motion_kernel(PtParams Q, ExtParams E, const float* __restrict__ o,
                       const float* __restrict__ d, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n) shade_pt<ExtParams, Motion>(Q, E, NoTex(), o, d, out, i);
}

// K1d on a static scene
__global__ void __launch_bounds__(THREADS)
mega_tex_kernel(PtParams Q, ExtParams E, TexParams X,
                const float* __restrict__ o, const float* __restrict__ d,
                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n) shade_pt<ExtParams, NoMotion, TexParams>(Q, E, X, o, d, out, i);
}

// K1d on a scene with motion blur (an env light; textures exclude motion)
__global__ void __launch_bounds__(THREADS)
mega_tex_motion_kernel(PtParams Q, ExtParams E, TexParams X,
                       const float* __restrict__ o,
                       const float* __restrict__ d, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n) shade_pt<ExtParams, Motion, TexParams>(Q, E, X, o, d, out, i);
}

// K1e: the five variants above over the tree
__global__ void __launch_bounds__(THREADS)
mega_pt_tree_kernel(PtParams Q, const float* __restrict__ o,
                    const float* __restrict__ d, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n)
    shade_pt<NoExt, NoMotion, NoTex, ChunkTree>(Q, NoExt(), NoTex(), o, d, out,
                                                i);
}

__global__ void __launch_bounds__(THREADS)
mega_ext_tree_kernel(PtParams Q, ExtParams E, const float* __restrict__ o,
                     const float* __restrict__ d, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n)
    shade_pt<ExtParams, NoMotion, NoTex, ChunkTree>(Q, E, NoTex(), o, d, out,
                                                    i);
}

__global__ void __launch_bounds__(THREADS)
mega_ext_motion_tree_kernel(PtParams Q, ExtParams E,
                            const float* __restrict__ o,
                            const float* __restrict__ d,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n)
    shade_pt<ExtParams, Motion, NoTex, ChunkTree>(Q, E, NoTex(), o, d, out, i);
}

__global__ void __launch_bounds__(THREADS)
mega_tex_tree_kernel(PtParams Q, ExtParams E, TexParams X,
                     const float* __restrict__ o, const float* __restrict__ d,
                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n)
    shade_pt<ExtParams, NoMotion, TexParams, ChunkTree>(Q, E, X, o, d, out, i);
}

__global__ void __launch_bounds__(THREADS)
mega_tex_motion_tree_kernel(PtParams Q, ExtParams E, TexParams X,
                            const float* __restrict__ o,
                            const float* __restrict__ d,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q.n)
    shade_pt<ExtParams, Motion, TexParams, ChunkTree>(Q, E, X, o, d, out, i);
}

// ints: max_depth, stack_k, max_iters, flags, n_draws, rr_floor
inline PtParams make_pt_params(
    int n, const float* tri, int n_tri, const float* chunk, int n_chunks,
    const float* nodes, const float* sph, int n_sph, const float* mat,
    int n_mat, const float* pl,
    int n_point, const float* dl, int n_dir, const float* consts,
    const float* mlf, int n_mlf, const float* mll, int n_ml, const int* ints,
    const float* draws, unsigned seed, unsigned sample) {
  PtParams Q;
  Q.g = mw::make_params(tri, n_tri, chunk, n_chunks, nodes, sph, n_sph, mat,
                        n_mat, pl, n_point, dl, n_dir, consts, ints[0],
                        ints[1], ints[2], ints[3]);
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
  return Q;
}

}  // namespace mp

// ints: max_depth, stack_k, max_iters, flags, n_draws, rr_floor.  ext null:
// K1b; else K1c with those tables, or with tex K1d, each in its motion
// instantiation when the flags say the scene has motion; with nodes (the
// tree) the K1e instantiation of each, else the chunk sweep's.
extern "C" int mega_pt_launch(
    const float* o, const float* d, float* out, int n, const float* tri,
    int n_tri, const float* chunk, int n_chunks, const float* nodes,
    const float* sph, int n_sph, const float* mat, int n_mat,
    const float* pl, int n_point, const float* dl, int n_dir,
    const float* consts, const float* mlf, int n_mlf, const float* mll,
    int n_ml, const int* ints, const float* draws, unsigned seed,
    unsigned sample, const mp::ExtParams* ext, const mt::TexParams* tex,
    void* stream) {
  if (ints[1] > mp::MAX_K || n <= 0 || (tex != nullptr && ext == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const mp::PtParams Q = mp::make_pt_params(
      n, tri, n_tri, chunk, n_chunks, nodes, sph, n_sph, mat, n_mat, pl,
      n_point, dl, n_dir, consts, mlf, n_mlf, mll, n_ml, ints, draws, seed,
      sample);
  const int blocks = (n + mw::THREADS - 1) / mw::THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool motion = (ints[3] & mp::FLAG_MOTION) != 0;
  if (nodes != nullptr) {
    if (ext == nullptr)
      mp::mega_pt_tree_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, o, d, out);
    else if (tex != nullptr && motion)
      mp::mega_tex_motion_tree_kernel<<<blocks, mw::THREADS, 0, st>>>(
          Q, *ext, *tex, o, d, out);
    else if (tex != nullptr)
      mp::mega_tex_tree_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, *ext, *tex,
                                                               o, d, out);
    else if (motion)
      mp::mega_ext_motion_tree_kernel<<<blocks, mw::THREADS, 0, st>>>(
          Q, *ext, o, d, out);
    else
      mp::mega_ext_tree_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, *ext, o, d,
                                                               out);
  } else if (ext == nullptr) {
    mp::mega_pt_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, o, d, out);
  } else if (tex != nullptr && motion) {
    mp::mega_tex_motion_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, *ext, *tex,
                                                               o, d, out);
  } else if (tex != nullptr) {
    mp::mega_tex_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, *ext, *tex, o, d,
                                                        out);
  } else if (motion) {
    mp::mega_ext_motion_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, *ext, o, d,
                                                               out);
  } else {
    mp::mega_ext_kernel<<<blocks, mw::THREADS, 0, st>>>(Q, *ext, o, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
