// mega_bwd.cu — kernels K2a, K2b and K2c for NVIDIA Hopper (sm_90a): the
// differentiable render's chain, forward and reverse (K2b and K2c in one
// launch, K2a's reverse from its primal's records), and the refit of the
// boxes from each call's vertices.
//
// Replaces the TPU kernel advanced_cpu_raytracing_tpu/ops/pallas/megabwd.py::
// _kernel (line 428, launched by _bwd_call through pl.pallas_call at line
// 1727, reduced by _reduce_streams at 1739): per ray, a linear chain of
// depth segments (max_depth + 1, and
// RR_DEPTH_FLOOR more under Russian roulette).  Each traces the scene
// (mw::trace of mega_common.cuh, carrying the winner's row), fixes the
// segment's topology — which primitive wins, shadow visibility, emissive and
// lit, the mirror / conductor gate, the dielectric's entering sign, total
// internal reflection and its reflect-or-refract choice from the branch
// uniform — and takes one step: the hit's t (Cramer's rule through the
// winner's vertices, or the sphere's quadratic through the ray), Beer's
// attenuation on segments k > 0, the primary miss's background, the
// emissive term, ambient, point and directional Blinn-Phong light, and the
// one child ray (megabwd.py:783-1188).  K2a (kPt = false) is the Whitted
// chain with point and directional lights.  K2b (kPt = true, megabwd.py:
// 947-1112, 1379-1483) adds spot lights (cosine-space cones, the intensity a
// leaf), area lights (a stop-grad point on the square, the two-sided
// irradiance area |cos| / d^2 differentiable through the hit), mesh lights (a
// stop-grad face pick and warp, the sampled point differentiable through
// that face's world corners by row) and path tracing: the GI ray from the
// replayed (r1, r2) about the step's normal, traced once per segment — its
// hit settles next-event estimation's suppression of the mesh light it hit
// and is the next segment's hit where the GI child is taken — Russian
// roulette (a replayed kill on the post-Beer weight, the differentiable
// reweight 1 / clip(max w, 1e-4, 1)) and the replayed fair coin between a GI
// and a specular child, whose taken weight doubles.  K2c (kTex = true, on
// either chain; megabwd.py:835-883, 1484-1564) differentiates diffuse image
// textures: on a face whose diffuse slot holds a replace_kd or blend_kd
// image, the step's kd is the texture's — the hit's barycentrics again
// through the winner's vertices, its UV tiled, the nearest tap or the four
// bilinear taps of the texel pool (the call's parameter) and the bilinear
// weights, differentiable in the UV — in every term that reads kd, the GI
// weight included.  The plain version is ops/megabwd.py::diff_trace_ref,
// differentiated by torch autograd.
//
// Design.  One thread per ray, 128 per block, as K1.  Each chain has a
// primal (kBwd = false: the radiance only, the JAX with_bwd=False) and a
// backward, over the 128-face chunks or the tree (FlatChunks / ChunkTree)
// as K1 picks them: the tree past one chunk (ops/megakernel.py::
// FWD_FLAT_MAX_FACES), with leaves of 4 rows, so no instantiation has a
// face cap.  The forward keeps each segment's stop-grad facts in a record
// (origin, direction, weight, Beer constant, the dielectric's ratio,
// winner row / sphere / material, topology and visibility bits, and in K2b
// the sampled mesh-light faces and the GI, coin and suppression bits).
// The reverse sweep runs from the last segment to the first: it recomputes
// the step's forward values from the record, the call's tables and the
// draws (read or drawn again, not stored) and applies each step's adjoint,
// derived by hand (the TPU kernel gets it from jax.vjp at trace time,
// which has no CUDA counterpart).  The ray cotangents d_o, d_d are written
// per ray.
//
// K2a's backward is a reverse kernel (kRev) that traces nothing: its
// primal writes each ray's records to a buffer of the call's
// (ops/megabwd.py::records_shape: REC_WORDS 32-bit words a segment,
// field-major, so the warp's threads store and load neighbouring words;
// 325 MB at 640,000 rays and 7 segments, which the card holds and moves
// in about 0.1 ms each way), and the reverse kernel reads them with the
// call's tables and the cotangent.  The TPU kernel traced the chain again
// in its fwd+bwd, since per-ray records could not outlive a kernel there;
// K2b's and K2c's fwd+bwd still do, keeping MAX_SEG records in local
// memory.  K2c reads its taps from K1d's pool (mega_tex.cuh: every image
// at native size, RGB f32, any number of texels and textures) with __ldg,
// in place of the TPU's channel-block texel table, its row-masked lane
// gather and the 16 tap streams; the diffuse slot is read again from the
// winner's row, not kept in the record.
//
// The boxes.  K2 moves the vertices, so each call refits the boxes the
// kernels read from its own vertices (mega_bwd_refit_*: the tree's child
// boxes over the topology and row order of the build, or the chunks'),
// and a moved face is never culled by a box of where it was.  The JAX
// kernel keeps the initial pack's boxes.
//
// The scatter, in place of the TPU's one-hot MXU epilogue and the 4,096
// texels it capped the pool at (the port has no cap).  Each cotangent target
// (vertices by row, materials, point, directional, spot, area and mesh
// lights, background, texels) has its own flag, and one the caller needs no
// gradient of is never added to.  Thousands of rays add into a few
// addresses: on the inverse-texture quad 640,000 rays x 9 vertex values go
// to 18, and 4 taps x 3 channels to 12,288 texel values whose neighbouring
// pixels share taps.  So every add is first summed over the warp's lanes
// that share its destination (__match_any_sync on the address, or on the
// first tap's texel and the filter, which fix the other three taps; then a
// tree of shuffles), and one lane adds the group's sums.  Those adds go to
// shared memory where the target fits in it: the materials' and lights'
// always; the rows' when 9 n_tri floats are few (FLAG_TRI_SHARED; the host
// picks, ops/megabwd.py::scatter_flags).  At the block's end each nonzero
// shared sum goes to global memory with one atomic.  Elsewhere (the
// 32,768-face torus's rows; the texel pool, whose copy in shared memory
// measured slower than these sums on an H100 at every pool size tried,
// PERF.md) the group sums go to global memory directly.
//
// Draws.  A table (the JAX wavefront_rng planes: ops/megabwd.py::BwdDraws)
// when one is given, else Philox4x32-10 keyed (seed, step), counter (ray,
// segment, c, 0): c = 0 the branch uniform, c = 1 the GI pair, the kill
// draw and the coin, c = 2 + a area light a's offsets, c = 2 + n_area + m
// mesh light m's pick and barycentrics (ops/megabwd.py::bwd_draws).
//
// Bound.  FP32 arithmetic on the CUDA cores: the closest-hit, GI and shadow
// queries' triangle, slab and sphere tests (once per launch: the reverse
// sweep traces nothing), counted over the chunks and over the tree,
// whichever needs fewer, plus the step and its adjoint per segment, light
// and GI sample; bytes are the rays in and out and the tables (or the
// tree's boxes and rows) read once; K2c adds its taps' weights and blend.
// K2a's primal adds the records it writes; its reverse kernel is the
// step's adjoint per segment and lit light against the bytes of the
// records, the cotangent, the tables and the cotangents out.
// Built with -fmad=false, IEEE division and sqrtf, the forward computes the
// plain version's expressions in their order; the adjoint is an
// independent derivation, so it rounds otherwise than autograd.

#include <type_traits>

#include "mega_common.cuh"
#include "mega_tex.cuh"

namespace mb {

using namespace mw;

constexpr int MAX_SEG_WHITTED = 11;  // K2a's segments: MAX_DEPTH (10) + 1
constexpr int MAX_SEG = 19;  // K2b's: + RR_DEPTH_FLOOR (8) under Russian roulette
constexpr int MAX_ML = 4;    // mesh lights (ops/megakernel.py::MAX_MESH_LIGHTS)
constexpr int FLAG_EMISSIVE = 8, FLAG_PT = 32, FLAG_IMPORTANCE = 64,
              FLAG_NEE = 128, FLAG_RR = 256, FLAG_PT_SPEC = 512;
// the fwd+bwd's cotangent targets, one flag each (ops/megabwd.py::
// SCATTER_FLAGS): a target without its flag is never added to; and the
// rows, whose sums a block keeps in shared memory first where the host
// asks (ops/megabwd.py::scatter_flags)
constexpr int SC_MAT = 1 << 10, SC_PL = 1 << 11, SC_DL = 1 << 12,
              SC_BG = 1 << 13, SC_TRI = 1 << 14, SC_SL = 1 << 15,
              SC_AL = 1 << 16, SC_ML = 1 << 17, SC_TEX = 1 << 18;
constexpr int FLAG_TRI_SHARED = 1 << 19;
constexpr int SPOT_COLS = 12;  // pos 3, dir 3, intensity 3, cos(cov/2),
                               // cos(fall/2), falloff denominator
constexpr int AREA_COLS = 17;  // pos 3, normal 3, radiance 3, extent, area,
                               // u 3, v 3
constexpr int ML_LIGHT_COLS = 5;  // radiance 3, first face, face count
constexpr int ML_ROW_COLS = 2;    // per mesh-light face: its row, its weight
constexpr float GI_EPS = 1e-4f;   // the GI ray's offset (raytracer.cpp:174)
constexpr int MAT_GRAD_COLS = 16;  // amb 0:3 kd 3:6 ks 6:9 mir 9:12 phong 12
                                   // radiance 13:16
constexpr float TWO_PI = 6.283185307179586f;
// a segment's shadow visibility, one bit per point, directional, spot, area
// or mesh light: the launcher refuses more lights (ops/megabwd.py::MAX_LIGHTS)
constexpr int VIS_BITS = 32;

// topology bits of a segment record
constexpr unsigned HIT = 1u, LIT = 2u, MISS_PRIMARY = 4u, EMISSIVE = 8u,
                   MIRROR = 16u, COND = 32u, REFLECT = 64u, REFRACT = 128u,
                   EXITING = 256u, CHAIN = 512u;
// K2b's: the child is the GI bounce; both a GI and a specular child existed
// (the coin's taken weight doubles); NEE skips mesh light m (SKIP_ML << m)
constexpr unsigned GI = 1024u, BOTH = 2048u, SKIP_ML = 4096u;

// K2b's tables, passed by pointer to mega_bwd_launch (null for K2a);
// ops/_build.py::BwdExtParams mirrors the layout
struct BwdExt {
  const float* sl;  // spot lights (n_spot, SPOT_COLS)
  int n_spot;
  const float* al;  // area lights (n_area, AREA_COLS)
  int n_area;
  const float* mll;  // mesh lights (n_ml, ML_LIGHT_COLS)
  int n_ml;
  const float* mlr;  // mesh-light faces (ML_ROW_COLS each)
  const float* uab;  // draw tables (BwdDraws), or null: Philox
  const float* uml;
  const float* ugi;
  float* d_sl;  // (n_spot, 3) cotangents
  float* d_al;  // (n_area, 3)
  float* d_ml;  // (n_ml, 3)
};

// K2c's tables, passed by pointer to mega_bwd_launch (null without
// textures); ops/_build.py::BwdTexParams mirrors the layout
struct BwdTex {
  const float* face;    // (n_tri, mt::TEXF_COLS): diffuse texture 0 (-1:
                        // none), vertex UVs 5:11 (ops/megakernel.py)
  const int* tint;      // (n_tex, mt::TEXI_COLS): interp 1, blend_kd 2,
                        // width 4, height 5, first texel 6
  const float* texels;  // (n_texels, 3) the pool: the call's parameter
  float* d_texels;      // (n_texels, 3) its cotangent (fwd+bwd only)
};

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
  // K2a's segment records (REC_WORDS words a segment, field-major, then
  // each ray's segment count): written by the primal where not null, read
  // by the reverse kernel
  float* rec;
  int n, depth;
  unsigned seed, step;
  BwdExt x;  // K2b only
  BwdTex t;  // K2c only
};

// one segment's stop-grad facts (the TPU kernel's per-segment `st`)
struct Seg {
  float o[3], d[3], w[3], ab[3];
  float ratio;  // the dielectric's n1 / n2
  int row, sph, mat;
  unsigned bits, vis;
};

// K2b's: + the sampled face of each mesh light (an index into mlr)
struct SegPt : Seg {
  int ml_face[MAX_ML];
};

// K2a's records (ops/megabwd.py::records_shape): word f of segment k of
// ray i at rec[(k REC_WORDS + f) n + i], so that the warp's threads store
// and load neighbouring words; o 0:3, d 3:6, w 6:9, ab 9:12, ratio 12, and
// row, sph, mat, bits, vis (13:18) as the bits of their 32-bit words.
// Each ray's segment count follows the depth's last segment.
constexpr int REC_WORDS = 18;

__device__ __forceinline__ float* rec_at(const BwdParams& Q, int i, int k) {
  return Q.rec + static_cast<size_t>(k) * REC_WORDS * Q.n + i;
}

__device__ __forceinline__ void store_seg(const BwdParams& Q, int i, int k,
                                          const Seg& s) {
  float* r = rec_at(Q, i, k);
  const size_t n = static_cast<size_t>(Q.n);
  for (int c = 0; c < 3; ++c) {
    r[c * n] = s.o[c];
    r[(3 + c) * n] = s.d[c];
    r[(6 + c) * n] = s.w[c];
    r[(9 + c) * n] = s.ab[c];
  }
  r[12 * n] = s.ratio;
  r[13 * n] = __int_as_float(s.row);
  r[14 * n] = __int_as_float(s.sph);
  r[15 * n] = __int_as_float(s.mat);
  r[16 * n] = __uint_as_float(s.bits);
  r[17 * n] = __uint_as_float(s.vis);
}

__device__ __forceinline__ Seg load_seg(const BwdParams& Q, int i, int k) {
  const float* r = rec_at(Q, i, k);
  const size_t n = static_cast<size_t>(Q.n);
  Seg s;
  for (int c = 0; c < 3; ++c) {
    s.o[c] = __ldg(r + c * n);
    s.d[c] = __ldg(r + (3 + c) * n);
    s.w[c] = __ldg(r + (6 + c) * n);
    s.ab[c] = __ldg(r + (9 + c) * n);
  }
  s.ratio = __ldg(r + 12 * n);
  s.row = __float_as_int(__ldg(r + 13 * n));
  s.sph = __float_as_int(__ldg(r + 14 * n));
  s.mat = __float_as_int(__ldg(r + 15 * n));
  s.bits = __float_as_uint(__ldg(r + 16 * n));
  s.vis = __float_as_uint(__ldg(r + 17 * n));
  return s;
}

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

// Blinn-Phong with unit irradiance toward wi (raytracer.cpp:540-554); kd
// is the material's (m + 4) or K2c's texture value
struct Shade {
  float dn, hr[3], h[3], hn, cos_t, cos_hm, spec, v[3];
};

__device__ __forceinline__ void shade_unit(const float* wi, const float* n,
                                           const float* wo, const float* m,
                                           const float* kd, Shade& S) {
  S.dn = wi[0] * n[0] + wi[1] * n[1] + wi[2] * n[2];
  S.cos_t = fmaxf(0.0f, S.dn);
  for (int c = 0; c < 3; ++c) S.hr[c] = S.h[c] = wi[c] + wo[c];
  norm3(S.h[0], S.h[1], S.h[2]);
  S.hn = S.h[0] * n[0] + S.h[1] * n[1] + S.h[2] * n[2];
  S.cos_hm = fmaxf(0.0f, S.hn);
  S.spec = powmax(S.cos_hm, m[13]);
  for (int c = 0; c < 3; ++c) S.v[c] = kd[c] * S.cos_t + m[7 + c] * S.spec;
}

// The adjoint of shade_unit for the cotangent gv of its value: into kd
// (gkd: the material's, gm + 3, or K2c's texture value), the material's ks
// and phong (gm), the direction wi (gwi, may be null for a constant wi),
// the normal (gn) and wo (gwo)
__device__ __forceinline__ void shade_unit_vjp(const float* wi,
                                               const float* n, const float* m,
                                               const float* kd, const Shade& S,
                                               const float* gv, float* gm,
                                               float* gkd, float* gwi,
                                               float* gn, float* gwo) {
  float g_cos_t = 0.0f, g_spec = 0.0f;
  for (int c = 0; c < 3; ++c) {
    gkd[c] += gv[c] * S.cos_t;
    gm[6 + c] += gv[c] * S.spec;
    g_cos_t += gv[c] * kd[c];
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

// the block's shared sums: materials, point and directional lights, bg
// (K2b: then the spot, area and mesh lights)
__device__ __forceinline__ int shared_floats(const Params& P) {
  return P.n_mat * MAT_GRAD_COLS + 3 * (P.n_point + P.n_dir) + 3;
}

// Where the reverse sweep adds its cotangents: the block's sums (sm, above);
// the rows' (9 per work item), the block's copy in shared memory or the
// call's buffer; the texel pool's (3 per texel), the call's buffer; and the
// targets asked for (SC_*).
struct Sinks {
  float* sm;
  float* tri;
  float* tex;
  int sc;
};

// Sums v over each group of the warp's converged lanes that share key: a
// tree over the group's lanes in lane order, by shuffles (the peers'
// reduction of E. Westphal's warp-aggregated atomics).  Returns true on the
// group's lowest lane, whose v then holds the group's sums; that lane alone
// adds them, so a group of 32 lanes on one address costs one atomic per
// value where each lane's own atomics would queue 32 deep on it.
template <int N>
__device__ __forceinline__ bool warp_sum(unsigned long long key, float (&v)[N]) {
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(active, key);
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned rel = __popc(below);                  // rank in the group
  unsigned rest = peers & ~((2u << lane) - 1u);  // the peers above
  while (__any_sync(active, rest != 0u)) {
    const int next = __ffs(rest) - 1;  // -1: none above
    for (int j = 0; j < N; ++j) {
      const float t = __shfl_sync(active, v[j], next < 0 ? lane : next);
      if (next >= 0) v[j] += t;
    }
    // a lane whose rank is odd at this level has passed its sum down
    rest &= ~__ballot_sync(active, rel & 1u);
    rel >>= 1;
  }
  return below == 0u;
}

// Adds v[0..N) at dst[0..N), one atomic per nonzero value and group of the
// warp's lanes on the same dst.
template <int N>
__device__ __forceinline__ void scatter_add(float* dst, float (&v)[N]) {
  if (warp_sum(reinterpret_cast<unsigned long long>(dst), v) && dst != nullptr)
    for (int j = 0; j < N; ++j)
      if (v[j] != 0.0f) atomicAdd(dst + j, v[j]);
}

// ---- K2b: the draws, the spot, area and mesh lights, the GI direction ----

__device__ __forceinline__ float word_uniform(unsigned x) {
  return static_cast<float>(x >> 9) * (1.0f / 8388608.0f);
}

// Philox block c of segment k of ray i: counter (ray, segment, c, 0)
__device__ __forceinline__ uint4 draw_block(const BwdParams& Q, int i, int k,
                                            unsigned c) {
  return philox(make_uint4(static_cast<unsigned>(i), static_cast<unsigned>(k),
                           c, 0u),
                Q.seed, Q.step);
}

__device__ __forceinline__ float plane(const float* tab, int row,
                                       const BwdParams& Q, int i) {
  return __ldg(tab + static_cast<size_t>(row) * Q.n + i);
}

// segment k's GI pair (phi, theta), Russian-roulette kill draw and coin
__device__ __forceinline__ float4 gi_draws(const BwdParams& Q, int i, int k) {
  if (Q.x.ugi != nullptr) {
    const bool rr = (Q.g.flags & FLAG_RR) != 0;
    const int d = Q.depth;
    return make_float4(
        plane(Q.x.ugi, 2 * k, Q, i), plane(Q.x.ugi, 2 * k + 1, Q, i),
        rr ? plane(Q.x.ugi, 2 * d + k, Q, i) : 0.0f,
        (Q.g.flags & FLAG_PT_SPEC) ? plane(Q.x.ugi, 2 * d + (rr ? d : 0) + k, Q, i)
                                   : 0.0f);
  }
  const uint4 w = draw_block(Q, i, k, 1u);
  return make_float4(word_uniform(w.x), word_uniform(w.y), word_uniform(w.z),
                     word_uniform(w.w));
}

// area light a's offsets on its square, in [-0.5, 0.5)
__device__ __forceinline__ void area_draws(const BwdParams& Q, int i, int k,
                                           int a, float& o1, float& o2) {
  if (Q.x.uab != nullptr) {
    const int b = (k * Q.x.n_area + a) * 2;
    o1 = plane(Q.x.uab, b, Q, i);
    o2 = plane(Q.x.uab, b + 1, Q, i);
    return;
  }
  const uint4 w = draw_block(Q, i, k, 2u + static_cast<unsigned>(a));
  o1 = word_uniform(w.x) - 0.5f;
  o2 = word_uniform(w.y) - 0.5f;
}

// mesh light m's face (an index into mlr: the table's pick, or
// min(floor(u count), count - 1)) and barycentric uniforms
__device__ __forceinline__ int ml_draws(const BwdParams& Q, int i, int k,
                                        int m, float& b1, float& b2) {
  const float* L = Q.x.mll + m * ML_LIGHT_COLS;
  const int first = static_cast<int>(L[3]), count = static_cast<int>(L[4]);
  int f;
  if (Q.x.uml != nullptr) {
    const int b = (k * Q.x.n_ml + m) * 3;
    f = static_cast<int>(plane(Q.x.uml, b, Q, i));
    b1 = plane(Q.x.uml, b + 1, Q, i);
    b2 = plane(Q.x.uml, b + 2, Q, i);
  } else {
    const uint4 w =
        draw_block(Q, i, k, 2u + static_cast<unsigned>(Q.x.n_area + m));
    f = min(static_cast<int>(word_uniform(w.x) * static_cast<float>(count)),
            count - 1);
    b1 = word_uniform(w.y);
    b2 = word_uniform(w.z);
  }
  return first + f;
}

// Spot, area or mesh light j (spots first) seen from p: tl = target - p,
// d2 = max(tl . tl, 1e-20), wi = tl / sqrt(d2), the irradiance factor e of
// the light term ((w I) e) Shade(wi), and the intensity row I.  Spot: e =
// falloff / d2; area: a point on the square, e = area |n . wi| / d2; mesh: a
// sqrt-warped barycentric point on the face ``face`` (-1: draw it), e =
// faceArea / surfaceArea 2 pi (raytracer.cpp:720-803).
struct ExtL {
  float tl[3], wi[3], d2, inv, e, b1, b2;
  const float* I;
  const float* row;  // the spot or area row, or the mesh face's mlr row
  int kind;          // 0 spot, 1 area, 2 mesh
  int face;
};

__device__ __forceinline__ void ext_at(const BwdParams& Q, int i, int k,
                                       int j, int face, const float* p,
                                       ExtL& X) {
  const BwdExt& E = Q.x;
  float target[3];
  if (j < E.n_spot) {
    X.kind = 0;
    X.row = E.sl + j * SPOT_COLS;
    X.I = X.row + 6;
    for (int c = 0; c < 3; ++c) target[c] = X.row[c];
  } else if (j < E.n_spot + E.n_area) {
    const int a = j - E.n_spot;
    X.kind = 1;
    X.row = E.al + a * AREA_COLS;
    X.I = X.row + 6;
    float o1, o2;
    area_draws(Q, i, k, a, o1, o2);
    const float ext = X.row[9];
    for (int c = 0; c < 3; ++c)
      target[c] = X.row[c] + X.row[11 + c] * (ext * o1) +
                  X.row[14 + c] * (ext * o2);
  } else {
    const int m = j - E.n_spot - E.n_area;
    X.kind = 2;
    X.I = E.mll + m * ML_LIGHT_COLS;
    const int f = ml_draws(Q, i, k, m, X.b1, X.b2);
    X.face = face >= 0 ? face : f;
    X.row = E.mlr + X.face * ML_ROW_COLS;
    const float* v = Q.g.tri + static_cast<int>(X.row[0]) * TRI_COLS;
    const float sq = sqrtf(X.b1);
    for (int c = 0; c < 3; ++c) {
      const float q = v[3 + c] * (1.0f - X.b2) + v[6 + c] * X.b2;
      target[c] = v[c] * (1.0f - sq) + q * sq;
    }
  }
  for (int c = 0; c < 3; ++c) X.tl[c] = target[c] - p[c];
  X.d2 = fmaxf(X.tl[0] * X.tl[0] + X.tl[1] * X.tl[1] + X.tl[2] * X.tl[2],
               1e-20f);
  X.inv = 1.0f / sqrtf(X.d2);
  for (int c = 0; c < 3; ++c) X.wi[c] = X.tl[c] * X.inv;
  if (X.kind == 0) {
    const float* L = X.row;
    const float cos_a = fminf(
        fmaxf(-(L[3] * X.wi[0] + L[4] * X.wi[1] + L[5] * X.wi[2]), -1.0f),
        1.0f);
    const float irr = 1.0f / X.d2;
    X.e = irr * spot_falloff(L, cos_a);
  } else if (X.kind == 1) {
    const float* A = X.row;
    X.e = A[10] * fabsf(A[3] * X.wi[0] + A[4] * X.wi[1] + A[5] * X.wi[2]) /
          X.d2;
  } else {
    X.e = X.row[1] * TWO_PI;
  }
}

// The adjoint of X.e for its cotangent ge: into wi (gwi) and d2 (g_d2).
// Spot: d e/d d2 = -e/d2, and between the cones d e/d cos a = 4 frac^3 /
// (d2 den) through cos a = clip(-(dir . wi)); area: d e/d d2 = -e/d2, d e/d
// wi = area sign(n . wi) n / d2; mesh: a constant.
__device__ __forceinline__ void ext_e_vjp(const ExtL& X, float ge, float* gwi,
                                          float& g_d2) {
  if (X.kind == 0) {
    const float* L = X.row;
    const float raw = -(L[3] * X.wi[0] + L[4] * X.wi[1] + L[5] * X.wi[2]);
    const float cos_a = fminf(fmaxf(raw, -1.0f), 1.0f);
    const float irr = 1.0f / X.d2;
    g_d2 -= ge * spot_falloff(L, cos_a) * irr / X.d2;
    const float x = (cos_a - L[9]) / L[11];
    if (!(cos_a >= 1.0f || cos_a < L[9]) && cos_a < L[10] && x >= 0.0f &&
        raw >= -1.0f && raw <= 1.0f) {
      const float g_cos = ge * irr * 4.0f * x * x * x / L[11];
      for (int c = 0; c < 3; ++c) gwi[c] -= g_cos * L[3 + c];
    }
  } else if (X.kind == 1) {
    const float* A = X.row;
    const float c = A[3] * X.wi[0] + A[4] * X.wi[1] + A[5] * X.wi[2];
    g_d2 -= ge * X.e / X.d2;
    const float sg = c > 0.0f ? 1.0f : (c < 0.0f ? -1.0f : 0.0f);
    const float g_c = ge / X.d2 * A[10] * sg;
    for (int j = 0; j < 3; ++j) gwi[j] += g_c * A[3 + j];
  }
}

// tl = target - p, d2 = max(tl . tl, 1e-20), wi = tl / sqrt(d2): the
// cotangent of tl from those of wi and d2
__device__ __forceinline__ void towards_vjp(const float* tl, float inv,
                                            float d2, const float* gwi,
                                            float g_d2, float* gtl) {
  const float g_inv = dot3(gwi, tl);
  g_d2 += g_inv * (-0.5f * inv / d2);
  const float s2 = tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2];
  for (int c = 0; c < 3; ++c)
    gtl[c] = gwi[c] * inv + (s2 > 1e-20f ? 2.0f * tl[c] * g_d2 : 0.0f);
}

// The adjoint of gi_direction (mega_common.cuh) in the normal n for the
// cotangent gg of the direction, into gn: through the final norm3, then
// v = unit(n x u), u = unit(r' x n) and r', n with one component set to 1
// (which one is stop-grad).  c = a x b gives a b x gc and b gc x a.
__device__ __forceinline__ void gi_direction_vjp(const float* n, float r1,
                                                 float r2, bool importance,
                                                 const float* gg, float* gn) {
  const float phi = 6.283185307179586f * r1;
  float sin_t, cos_t;
  if (importance) {
    sin_t = sqrtf(r2);
    cos_t = sqrtf(fmaxf(1.0f - r2, 0.0f));
  } else {
    cos_t = r2;
    sin_t = sqrtf(fmaxf(1.0f - r2 * r2, 0.0f));
  }
  const float ax = fabsf(n[0]), ay = fabsf(n[1]), az = fabsf(n[2]);
  const bool use_x = ax < ay && ax < az;
  const bool use_y = !(ax < ay) && ay < az;
  const bool use_z = !(use_x || use_y);
  const float rp[3] = {use_x ? 1.0f : n[0], use_y ? 1.0f : n[1],
                       use_z ? 1.0f : n[2]};
  float ur[3], u[3], vr[3], v[3];
  cross3(rp, n, ur);
  for (int c = 0; c < 3; ++c) u[c] = ur[c];
  norm3(u[0], u[1], u[2]);
  cross3(n, u, vr);
  for (int c = 0; c < 3; ++c) v[c] = vr[c];
  norm3(v[0], v[1], v[2]);
  const float sc = sin_t * cosf(phi), ss = sin_t * sinf(phi);
  float x[3];
  for (int c = 0; c < 3; ++c) x[c] = u[c] * sc + n[c] * cos_t + v[c] * ss;
  float gx[3], gu[3], gv[3], gvr[3], gur[3], grp[3], t[3];
  norm3_vjp(x, gg, gx);
  for (int c = 0; c < 3; ++c) {
    gu[c] = gx[c] * sc;
    gv[c] = gx[c] * ss;
    gn[c] += gx[c] * cos_t;
  }
  norm3_vjp(vr, gv, gvr);
  cross3(u, gvr, t);
  for (int c = 0; c < 3; ++c) gn[c] += t[c];
  cross3(gvr, n, t);
  for (int c = 0; c < 3; ++c) gu[c] += t[c];
  norm3_vjp(ur, gu, gur);
  cross3(n, gur, grp);
  cross3(gur, rp, t);
  for (int c = 0; c < 3; ++c) gn[c] += t[c];
  if (!use_x) gn[0] += grp[0];
  if (!use_y) gn[1] += grp[1];
  if (!use_z) gn[2] += grp[2];
}

// the RR reweight's probability clip(max w, 1e-4, 1) of the post-Beer weight
__device__ __forceinline__ float rr_prob(const float* w) {
  return fminf(fmaxf(fmaxf(w[0], fmaxf(w[1], w[2])), 1e-4f), 1.0f);
}

// ---- K2c: the step's kd on a face with a diffuse image texture ----

// The texture's part of a step (megabwd.py:835-883): the hit's
// barycentrics through the winner's vertices v (mega_tex.cuh's surface),
// uv = uv0 + beta (uv1 - uv0) + gamma (uv2 - uv0) before (xu, xv) and after
// tile_uv, the taps' texels in the pool and their weights (nearest: one
// tap of weight 1), and kd: the taps' value / 255, averaged with the
// material's kd under blend_kd; kd is the material's where the winner has
// no diffuse texture (slot -1).  The plain version's expressions, in its
// order (ops/megabwd.py::_texture_kd).
struct TexStep {
  int slot;
  bool bilinear, blend;
  float beta, gamma, xu, xv, u, v;
  int idx[4];
  float w[4], kd[3];
};

__device__ __forceinline__ void tex_step(const BwdParams& Q, int row,
                                         const float* o, const float* d,
                                         const float* m, TexStep& X) {
  X.slot = -1;
  for (int c = 0; c < 3; ++c) X.kd[c] = m[4 + c];
  if (row < 0) return;
  const float* q = Q.t.face + static_cast<size_t>(row) * mt::TEXF_COLS;
  X.slot = static_cast<int>(__ldg(q));
  if (X.slot < 0) return;
  const float* v = Q.g.tri + static_cast<size_t>(row) * TRI_COLS;
  const float e1x = v[0] - v[3], e1y = v[1] - v[4], e1z = v[2] - v[5];
  const float e2x = v[0] - v[6], e2y = v[1] - v[7], e2z = v[2] - v[8];
  const float bx = v[0] - o[0], by = v[1] - o[1], bz = v[2] - o[2];
  const float m0 = e2y * d[2] - d[1] * e2z;
  const float m1 = e2x * d[2] - d[0] * e2z;
  const float m2 = e2x * d[1] - d[0] * e2y;
  const float det = e1x * m0 - e1y * m1 + e1z * m2;
  const float safe = det == 0.0f ? 1.0f : det;
  X.beta = (bx * m0 - by * m1 + bz * m2) / safe;
  const float n0 = by * d[2] - d[1] * bz;
  const float n1 = bx * d[2] - d[0] * bz;
  const float n2 = bx * d[1] - d[0] * by;
  X.gamma = (e1x * n0 - e1y * n1 + e1z * n2) / safe;
  const float u0 = __ldg(q + 5), v0 = __ldg(q + 6);
  X.xu = u0 + X.beta * (__ldg(q + 7) - u0) + X.gamma * (__ldg(q + 9) - u0);
  X.xv = v0 + X.beta * (__ldg(q + 8) - v0) + X.gamma * (__ldg(q + 10) - v0);
  X.u = mt::tile_uv(X.xu);
  X.v = mt::tile_uv(X.xv);
  const int* T = Q.t.tint + X.slot * mt::TEXI_COLS;
  const int w = __ldg(T + 4), h = __ldg(T + 5), first = __ldg(T + 6);
  X.bilinear = __ldg(T + 1) != 0;
  X.blend = __ldg(T + 2) != 0;
  float tap[3];
  if (!X.bilinear) {
    X.idx[0] = first + mt::nearest(X.v, h) * w + mt::nearest(X.u, w);
    X.w[0] = 1.0f;
    const float* t = Q.t.texels + 3 * static_cast<size_t>(X.idx[0]);
    for (int c = 0; c < 3; ++c) tap[c] = __ldg(t + c);
  } else {
    const float fw = static_cast<float>(w), fh = static_cast<float>(h);
    const float fi = fminf(fmaxf(X.u * fw, 0.0f), fw - 1.0f);
    const float fj = fminf(fmaxf(X.v * fh, 0.0f), fh - 1.0f);
    const float p = floorf(fi), pq = floorf(fj);
    const float dx = fi - p, dy = fj - pq;
    const int p0 = static_cast<int>(p), q0 = static_cast<int>(pq);
    const int p1 = static_cast<int>(fminf(p + 1.0f, fw - 1.0f));
    const int q1 = static_cast<int>(fminf(pq + 1.0f, fh - 1.0f));
    X.idx[0] = first + q0 * w + p0;
    X.idx[1] = first + q0 * w + p1;
    X.idx[2] = first + q1 * w + p0;
    X.idx[3] = first + q1 * w + p1;
    X.w[0] = (1.0f - dx) * (1.0f - dy);
    X.w[1] = dx * (1.0f - dy);
    X.w[2] = (1.0f - dx) * dy;
    X.w[3] = dx * dy;
    float t[4][3];
    for (int k = 0; k < 4; ++k)
      for (int c = 0; c < 3; ++c)
        t[k][c] = __ldg(Q.t.texels + 3 * static_cast<size_t>(X.idx[k]) + c);
    for (int c = 0; c < 3; ++c)
      tap[c] = X.w[0] * t[0][c] + X.w[1] * t[1][c] + X.w[2] * t[2][c] +
               X.w[3] * t[3][c];
  }
  for (int c = 0; c < 3; ++c) {
    const float val = tap[c] * mt::INV255;
    X.kd[c] = X.blend ? (val + m[4 + c]) * 0.5f : val;
  }
}

// d clip(x, 0, hi) / dx as JAX's clip, min(max(x, 0), hi): 1 inside, 0
// outside, and each of max and min passes half at a tie
__device__ __forceinline__ float clip_slope(float x, float hi) {
  const float a = x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
  const float y = fmaxf(x, 0.0f);
  return a * (y < hi ? 1.0f : (y == hi ? 0.5f : 0.0f));
}

// d tile_uv(x) / dx: 1, or 0 where it returns the constant 1
__device__ __forceinline__ float tile_slope(float x) {
  return (x > 1.0001f && x - floorf(x) < 0.0001f) ? 0.0f : 1.0f;
}

// The adjoint of tex_step for the cotangent gkd of its kd: the taps'
// texels (g w_k / 255, g w_k / 510 under blend_kd) added into the pool's
// cotangent at tex (null: not asked for), the material's kd (g / 2 under
// blend_kd) into gm, and the barycentrics' (through the bilinear weights
// where the clip of u w to [0, w - 1] passes, tile_uv and uv; floor is a
// constant) into g_beta, g_gamma.  The taps' texels follow from the first
// tap's and the filter (the first tap fixes the image and the cell; two
// textures may share an image with different filters), so the warp's lanes
// are grouped by both and each group's lowest lane adds the group's sums.
__device__ __forceinline__ void tex_step_vjp(const BwdParams& Q, int row,
                                             const TexStep& X,
                                             const float* gkd, float* gm,
                                             float* tex, float& g_beta,
                                             float& g_gamma) {
  float gtap[3];
  for (int c = 0; c < 3; ++c) {
    const float gv = X.blend ? gkd[c] * 0.5f : gkd[c];
    if (X.blend) gm[3 + c] += gv;
    gtap[c] = gv * mt::INV255;
  }
  const int n_taps = X.bilinear ? 4 : 1;
  float gw[4], gt[12];
  for (int k = 0; k < 4; ++k)
    for (int c = 0; c < 3; ++c) gt[3 * k + c] = 0.0f;
  for (int k = 0; k < n_taps; ++k) {
    const size_t at = 3 * static_cast<size_t>(X.idx[k]);
    gw[k] = 0.0f;
    for (int c = 0; c < 3; ++c) {
      gw[k] += gtap[c] * __ldg(Q.t.texels + at + c);
      gt[3 * k + c] = gtap[c] * X.w[k];
    }
  }
  const unsigned long long key =
      (static_cast<unsigned long long>(X.idx[0]) << 1) | (X.bilinear ? 1u : 0u);
  if (tex != nullptr && warp_sum(key, gt))
    for (int k = 0; k < n_taps; ++k)
      for (int c = 0; c < 3; ++c)
        if (gt[3 * k + c] != 0.0f)
          atomicAdd(tex + 3 * static_cast<size_t>(X.idx[k]) + c, gt[3 * k + c]);
  g_beta = 0.0f;
  g_gamma = 0.0f;
  if (!X.bilinear) return;
  const int* T = Q.t.tint + X.slot * mt::TEXI_COLS;
  const float fw = static_cast<float>(__ldg(T + 4));
  const float fh = static_cast<float>(__ldg(T + 5));
  const float xi = X.u * fw, xj = X.v * fh;
  const float fi = fminf(fmaxf(xi, 0.0f), fw - 1.0f);
  const float fj = fminf(fmaxf(xj, 0.0f), fh - 1.0f);
  const float dx = fi - floorf(fi), dy = fj - floorf(fj);
  // w0 = (1 - dx)(1 - dy), w1 = dx (1 - dy), w2 = (1 - dx) dy, w3 = dx dy
  const float g_dx = (gw[1] - gw[0]) * (1.0f - dy) + (gw[3] - gw[2]) * dy;
  const float g_dy = (gw[2] - gw[0]) * (1.0f - dx) + (gw[3] - gw[1]) * dx;
  const float g_xu = g_dx * clip_slope(xi, fw - 1.0f) * fw * tile_slope(X.xu);
  const float g_xv = g_dy * clip_slope(xj, fh - 1.0f) * fh * tile_slope(X.xv);
  const float* q = Q.t.face + static_cast<size_t>(row) * mt::TEXF_COLS;
  const float u0 = __ldg(q + 5), v0 = __ldg(q + 6);
  g_beta = g_xu * (__ldg(q + 7) - u0) + g_xv * (__ldg(q + 8) - v0);
  g_gamma = g_xu * (__ldg(q + 9) - u0) + g_xv * (__ldg(q + 10) - v0);
}

// The chain of ray i: the forward sweep (the radiance into out; with kBwd
// each segment's record kept in local memory, and in K2a's primal written
// to Q.rec where it is not null), then with kBwd the reverse sweep.  kRev
// (K2a's reverse kernel) runs the reverse sweep alone, from the primal's
// records in Q.rec: it traces nothing.
template <bool kBwd, class G, bool kPt = false, bool kTex = false,
          bool kRev = false>
__device__ void diff_ray(const BwdParams& Q, const float* __restrict__ o,
                         const float* __restrict__ d, float* __restrict__ out,
                         int i, const Sinks& K) {
  static_assert(!kRev || (kBwd && !kPt && !kTex),
                "the reverse kernel is K2a's");
  using SegT = typename std::conditional<kPt, SegPt, Seg>::type;
  const Params& P = Q.g;
  const bool diel = (P.flags & FLAG_DIELECTRIC) != 0;
  const bool has_em = (P.flags & FLAG_EMISSIVE) != 0;
  const bool any_spec =
      (P.flags & (FLAG_MIRROR | FLAG_DIELECTRIC | FLAG_CONDUCTOR)) != 0;
  const bool has_amb = P.amb[0] != 0.0f || P.amb[1] != 0.0f || P.amb[2] != 0.0f;
  const float eps = P.eps;
  const int n_light = P.n_point + P.n_dir;
  // K2b: path tracing's switches (PT without NEE samples no direct light,
  // ambient included), the spot, area and mesh lights after the others
  const bool pt = kPt && (P.flags & FLAG_PT) != 0;
  const bool sample_direct = !pt || (P.flags & FLAG_NEE) != 0;
  const bool importance = (P.flags & FLAG_IMPORTANCE) != 0;
  const bool rr = (P.flags & FLAG_RR) != 0;
  const int n_ext = kPt ? Q.x.n_spot + Q.x.n_area + Q.x.n_ml : 0;
  SegT rec[kBwd && !kRev ? (kPt ? MAX_SEG : MAX_SEG_WHITTED) : 1];
  int n_seg = 0;
  if constexpr (kRev) {
    n_seg = __float_as_int(__ldg(rec_at(Q, i, Q.depth)));
  } else {
    SegT s;
    for (int c = 0; c < 3; ++c) {
      s.o[c] = o[3 * i + c];
      s.d[c] = d[3 * i + c];
      s.w[c] = 1.0f;
      s.ab[c] = 0.0f;
    }
    float med = 1.0f;
    float L[3] = {0.0f, 0.0f, 0.0f};
    Hit gh;  // K2b: the GI ray's hit, the next segment's where it is taken
    int gwin[2] = {-1, -1};
    bool reuse = false;
    for (int k = 0; k < Q.depth; ++k) {
      // ---- trace and topology (stop-grad) ----
      int win[2];
      Hit h;
      if (kPt && reuse) {
        h = gh;
        win[0] = gwin[0];
        win[1] = gwin[1];
      } else {
        h = trace<false, NoMotion, true, G>(P, s.o[0], s.o[1], s.o[2], s.d[0],
                                            s.d[1], s.d[2], NoMotion(), win);
      }
      s.row = win[0];
      s.sph = win[1];
      s.mat = h.hit ? h.mat : 0;
      s.ratio = 1.0f;
      s.vis = 0u;
      const float* m = P.mat + s.mat * MAT_COLS;
      const int type = static_cast<int>(m[0]);
      unsigned bits = h.hit ? HIT : 0u;
      if (h.hit && has_em && type == MAT_EMISSIVE) bits |= EMISSIVE;
      bool lit = h.hit && !(bits & EMISSIVE) && !(diel && med > 1.00001f);
      if constexpr (kPt) lit = lit && sample_direct;
      if (lit) bits |= LIT;
      if (k == 0 && !h.hit) bits |= MISS_PRIMARY;
      s.bits = bits;
      Geo g;
      step_geometry<false>(Q, s, k, h.t, g);
      const float* n = g.n;
      // K2c: kd of the winner's diffuse texture
      TexStep tx;
      const float* kd = m + 4;
      if constexpr (kTex) {
        tex_step(Q, h.hit ? s.row : -1, s.o, s.d, m, tx);
        kd = tx.kd;
      }
      // ---- K2b: the GI ray, traced before the light terms (NEE skips the
      // mesh light it hit); Russian roulette past max_depth on the post-Beer
      // weight (integrator.py:259-297) ----
      bool gi_would = false;
      float4 gdraw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float gd[3] = {0.0f, 0.0f, 0.0f}, gio[3] = {0.0f, 0.0f, 0.0f};
      if constexpr (kPt) {
        if (pt && k < Q.depth - 1) {
          gdraw = gi_draws(Q, i, k);
          bool gi_alive = h.hit && !(bits & EMISSIVE);
          if (rr && k >= P.max_depth && gdraw.z > rr_prob(g.wb))
            gi_alive = false;
          if (gi_alive) {
            gi_direction(n[0], n[1], n[2], gdraw.x, gdraw.y, importance, gd[0],
                         gd[1], gd[2]);
            for (int c = 0; c < 3; ++c) gio[c] = g.p[c] + n[c] * GI_EPS;
            gh = trace<true, NoMotion, true, G>(P, gio[0], gio[1], gio[2],
                                                gd[0], gd[1], gd[2],
                                                NoMotion(), gwin);
            gi_would = gh.hit;
            if (gh.hit && gh.ml >= 0) s.bits |= SKIP_ML << gh.ml;
          }
        }
      }
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
          shade_unit(wi, n, g.wo, m, kd, S);
          for (int c = 0; c < 3; ++c)
            seg[c] = seg[c] + (point ? g.wb[c] * row[3 + c] / d2
                                     : g.wb[c] * row[3 + c]) * S.v[c];
        }
        if constexpr (kPt) {
          for (int j = 0; j < n_ext; ++j) {
            const int mi = j - Q.x.n_spot - Q.x.n_area;
            if (mi >= 0 && (s.bits & (SKIP_ML << mi))) continue;
            ExtL X;
            ext_at(Q, i, k, j, -1, g.p, X);
            if (mi >= 0) s.ml_face[mi] = X.face;
            if (!light_visible<G>(P, 0, so, X.wi, X.d2, true)) continue;
            s.vis |= 1u << (n_light + j);
            Shade S;
            shade_unit(X.wi, n, g.wo, m, kd, S);
            for (int c = 0; c < 3; ++c)
              seg[c] = seg[c] + g.wb[c] * X.I[c] * X.e * S.v[c];
          }
        }
      }
      for (int c = 0; c < 3; ++c) L[c] = L[c] + seg[c];
      // ---- the child ----
      bool chain = false;
      float o2[3], d2v[3], w2[3], ab2[3] = {0.0f, 0.0f, 0.0f}, med2 = 1.0f;
      if (k < (kPt ? P.max_depth : Q.depth - 1) && any_spec && h.hit) {
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
      if constexpr (kPt) {
        // the GI child where the GI ray hit; with a specular child too, the
        // replayed coin picks one and its weight doubles (stochastic_spec_gi)
        if (gi_would) {
          const bool chain_spec = chain;
          chain = true;
          if (!chain_spec || gdraw.w < 0.5f) {
            s.bits |= GI;
            Shade S;
            shade_unit(gd, n, g.wo, m, kd, S);
            float fac = TWO_PI;
            if (rr && k >= P.max_depth) fac = TWO_PI * (1.0f / rr_prob(g.wb));
            for (int c = 0; c < 3; ++c) {
              o2[c] = gio[c];
              d2v[c] = gd[c];
              w2[c] = g.wb[c] * S.v[c] * fac;
              ab2[c] = 0.0f;
            }
            med2 = med;
          }
          if (chain_spec) {
            s.bits |= BOTH;
            for (int c = 0; c < 3; ++c) w2[c] = w2[c] * 2.0f;
          }
        }
        reuse = (s.bits & GI) != 0;
      }
      if (chain) s.bits |= CHAIN;
      if (kBwd) rec[n_seg] = s;
      if constexpr (!kBwd && !kPt && !kTex) {
        if (Q.rec != nullptr) store_seg(Q, i, n_seg, s);
      }
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
    if constexpr (!kBwd && !kPt && !kTex) {
      if (Q.rec != nullptr) *rec_at(Q, i, Q.depth) = __int_as_float(n_seg);
    }
  }  // the forward sweep
  if constexpr (!kBwd) return;

  // ---- reverse sweep: the last segment to the first ----
  float* sm_mat = K.sm;
  float* sm_pl = K.sm + P.n_mat * MAT_GRAD_COLS;
  float* sm_dl = sm_pl + 3 * P.n_point;
  float* sm_bg = sm_dl + 3 * P.n_dir;
  float gL[3], go2[3] = {0.0f, 0.0f, 0.0f}, gd2[3] = {0.0f, 0.0f, 0.0f},
               gw2[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) gL[c] = Q.gbar[3 * i + c];
  for (int k = n_seg - 1; k >= 0; --k) {
    SegT s_rec;
    if constexpr (kRev) s_rec = load_seg(Q, i, k);
    const SegT& s = kRev ? s_rec : rec[k];
    const float* m = P.mat + s.mat * MAT_COLS;
    Geo g;
    step_geometry<true>(Q, s, k, 0.0f, g);
    const float* n = g.n;
    float gm[MAT_GRAD_COLS];
    for (int j = 0; j < MAT_GRAD_COLS; ++j) gm[j] = 0.0f;
    // K2c: kd of the winner's diffuse texture, and its cotangent
    TexStep tx;
    const float* kd = m + 4;
    float* gkd = gm + 3;
    float gkd_t[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (kTex) {
      tex_step(Q, (s.bits & HIT) ? s.row : -1, s.o, s.d, m, tx);
      kd = tx.kd;
      gkd = gkd_t;
    }
    float gwb[3] = {0.0f, 0.0f, 0.0f}, gp[3] = {0.0f, 0.0f, 0.0f},
          gn[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f},
          go[3] = {0.0f, 0.0f, 0.0f}, gwo[3] = {0.0f, 0.0f, 0.0f};
    float gt = 0.0f;
    // the child
    bool gi_child = false;
    if constexpr (kPt) {
      if (s.bits & BOTH)
        for (int c = 0; c < 3; ++c) gw2[c] = gw2[c] * 2.0f;
      gi_child = (s.bits & GI) != 0;
    }
    if (gi_child) {
      // o2 = p + n GI_EPS, d2 = gi_direction(n), w2 = wb Shade(d2) fac,
      // fac = 2 pi (/ clip(max wb, 1e-4, 1) past max_depth under RR)
      const float4 gdraw = gi_draws(Q, i, k);
      float gdir[3];
      gi_direction(n[0], n[1], n[2], gdraw.x, gdraw.y, importance, gdir[0],
                   gdir[1], gdir[2]);
      Shade S;
      shade_unit(gdir, n, g.wo, m, kd, S);
      const bool tail = rr && k >= P.max_depth;
      const float mx = fmaxf(g.wb[0], fmaxf(g.wb[1], g.wb[2]));
      const float rs = tail ? 1.0f / rr_prob(g.wb) : 1.0f;
      const float fac = tail ? TWO_PI * rs : TWO_PI;
      float gv[3], ggd[3] = {0.0f, 0.0f, 0.0f}, gfac = 0.0f;
      for (int c = 0; c < 3; ++c) {
        gv[c] = gw2[c] * g.wb[c] * fac;
        gwb[c] += gw2[c] * S.v[c] * fac;
        gfac += gw2[c] * g.wb[c] * S.v[c];
      }
      shade_unit_vjp(gdir, n, m, kd, S, gv, gm, gkd, ggd, gn, gwo);
      for (int c = 0; c < 3; ++c) {
        ggd[c] += gd2[c];
        gp[c] += go2[c];
        gn[c] += go2[c] * GI_EPS;
      }
      gi_direction_vjp(n, gdraw.x, gdraw.y, importance, ggd, gn);
      if (tail && mx >= 1e-4f && mx <= 1.0f) {
        // the clip passes; max splits its cotangent among tied channels
        const float g_mx = -gfac * TWO_PI * rs * rs;
        const int ties = (g.wb[0] == mx) + (g.wb[1] == mx) + (g.wb[2] == mx);
        for (int c = 0; c < 3; ++c)
          if (g.wb[c] == mx) gwb[c] += g_mx / static_cast<float>(ties);
      }
    } else if (s.bits & CHAIN) {
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
    if (K.sc & SC_BG) {
      float gb[3];
      for (int c = 0; c < 3; ++c) gb[c] = gL[c] * g.wb[c];
      scatter_add((s.bits & MISS_PRIMARY) ? sm_bg : nullptr, gb);
    }
    for (int c = 0; c < 3; ++c) {
      if (s.bits & MISS_PRIMARY) gwb[c] += gL[c] * Q.bg[c];
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
        shade_unit(wi, n, g.wo, m, kd, S);
        float gv[3], gwi[3] = {0.0f, 0.0f, 0.0f}, gI[3];
        if (point) {
          float g_d2 = 0.0f;
          for (int c = 0; c < 3; ++c) {
            const float q = g.wb[c] * row[3 + c] / d2;
            const float gq = gL[c] * S.v[c];
            gv[c] = gL[c] * q;
            gwb[c] += gq / d2 * row[3 + c];
            gI[c] = gq / d2 * g.wb[c];
            g_d2 -= gq * q / d2;
          }
          if (K.sc & SC_PL) scatter_add(sm_pl + 3 * l, gI);
          shade_unit_vjp(wi, n, m, kd, S, gv, gm, gkd, gwi, gn, gwo);
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
            gI[c] = gq * g.wb[c];
          }
          if (K.sc & SC_DL) scatter_add(sm_dl + 3 * j, gI);
          shade_unit_vjp(wi, n, m, kd, S, gv, gm, gkd, nullptr, gn, gwo);
        }
      }
    }
    if constexpr (kPt) {
      float* sm_x = K.sm + shared_floats(P);  // spot, area, mesh: 3 each
      for (int j = 0; lit && j < n_ext; ++j) {
        if (!((s.vis >> (n_light + j)) & 1u)) continue;
        const int mi = j - Q.x.n_spot - Q.x.n_area;
        ExtL X;
        ext_at(Q, i, k, j, mi >= 0 ? s.ml_face[mi] : -1, g.p, X);
        Shade S;
        shade_unit(X.wi, n, g.wo, m, kd, S);
        float gv[3], gwi[3] = {0.0f, 0.0f, 0.0f}, ge = 0.0f, g_d2 = 0.0f,
                     gI[3];
        for (int c = 0; c < 3; ++c) {
          const float q = g.wb[c] * X.I[c];
          const float gq = gL[c] * S.v[c];
          gv[c] = gL[c] * (q * X.e);
          ge += gq * q;
          gwb[c] += gq * X.e * X.I[c];
          gI[c] = gq * X.e * g.wb[c];
        }
        const int sc_j = j < Q.x.n_spot ? SC_SL : mi < 0 ? SC_AL : SC_ML;
        if (K.sc & sc_j) scatter_add(sm_x + 3 * j, gI);
        shade_unit_vjp(X.wi, n, m, kd, S, gv, gm, gkd, gwi, gn, gwo);
        ext_e_vjp(X, ge, gwi, g_d2);
        float gtl[3];
        towards_vjp(X.tl, X.inv, X.d2, gwi, g_d2, gtl);
        for (int c = 0; c < 3; ++c) gp[c] -= gtl[c];
        if (X.kind == 2 && (K.sc & SC_TRI)) {
          // the sampled point through the face's corners, by row
          const int row = static_cast<int>(X.row[0]);
          const float sq = sqrtf(X.b1);
          float gv9[9];
          for (int c = 0; c < 3; ++c) {
            gv9[c] = gtl[c] * (1.0f - sq);
            gv9[3 + c] = gtl[c] * sq * (1.0f - X.b2);
            gv9[6 + c] = gtl[c] * sq * X.b2;
          }
          scatter_add(K.tri + row * 9, gv9);
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
    // K2c: the texture's kd into the texels, the material's kd and the
    // barycentrics
    float g_beta = 0.0f, g_gamma = 0.0f;
    if constexpr (kTex) {
      if (tx.slot >= 0)
        tex_step_vjp(Q, s.row, tx, gkd_t, gm,
                     (K.sc & SC_TEX) ? K.tex : nullptr, g_beta, g_gamma);
      else
        for (int c = 0; c < 3; ++c) gm[3 + c] += gkd_t[c];
    }
    // t and the normal through the hit
    if (s.bits & HIT) {
      if (s.row >= 0) {
        const TriStep& T = g.T;
        if (T.det != 0.0f) {
          const float g_num = gt / T.safe;
          float g_det = -gt * T.t / T.safe;
          float c1[3], c2[3], c3[3], c4[3], c5[3], c6[3];
          cross3(T.e2, T.b, c1);   // d num / d e1
          cross3(T.b, T.e1, c2);   // d num / d e2
          cross3(T.e1, T.e2, c3);  // d num / d b, d det / d d
          cross3(T.e2, s.d, c4);   // d det / d e1
          cross3(s.d, T.e1, c5);   // d det / d e2
          // K2c: beta = b . (e2 x d) / det, gamma = e1 . (b x d) / det
          float g_bn = 0.0f, g_gn = 0.0f;
          if constexpr (kTex) {
            cross3(T.b, s.d, c6);
            if (tx.slot >= 0) {
              g_bn = g_beta / T.safe;
              g_gn = g_gamma / T.safe;
              g_det -= (g_beta * tx.beta + g_gamma * tx.gamma) / T.safe;
            }
          }
          float gv9[9];
          for (int c = 0; c < 3; ++c) {
            float ge1 = g_num * c1[c] + g_det * c4[c];
            float ge2 = g_num * c2[c] + g_det * c5[c];
            float gb = g_num * c3[c];
            float gdd = g_det * c3[c];
            if constexpr (kTex) {
              ge1 += g_gn * c6[c];
              ge2 -= g_bn * c6[c];
              gb += g_bn * c4[c] + g_gn * c5[c];
              gdd -= g_bn * c1[c] + g_gn * c2[c];
            }
            gd[c] += gdd;
            go[c] -= gb;
            gv9[c] = ge1 + ge2 + gb;
            gv9[3 + c] = -ge1;
            gv9[6 + c] = -ge2;
          }
          if (K.sc & SC_TRI) scatter_add(K.tri + s.row * 9, gv9);
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
    if (K.sc & SC_MAT)
      scatter_add((s.bits & HIT) ? sm_mat + s.mat * MAT_GRAD_COLS : nullptr,
                  gm);
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

// The fwd+bwd's block sums in shared memory, in floats: the materials',
// lights' and background's, then the rows' where FLAG_TRI_SHARED
__host__ __device__ __forceinline__ int block_floats(int n_mat, int n_light,
                                                     int n_ext, int n_tri,
                                                     int flags) {
  return n_mat * MAT_GRAD_COLS + 3 * (n_light + n_ext) + 3 +
         ((flags & FLAG_TRI_SHARED) ? 9 * n_tri : 0);
}

// One ray a thread.  The fwd+bwd and the reverse kernel zero the block's
// sums, run the ray, and add each nonzero sum to the call's buffer with
// one global atomic.
template <bool kBwd, class G, bool kPt = false, bool kTex = false,
          bool kRev = false>
__device__ __forceinline__ void run(const BwdParams& Q,
                                    const float* __restrict__ o,
                                    const float* __restrict__ d,
                                    float* __restrict__ out) {
  extern __shared__ float sm[];
  if constexpr (kBwd) {
    const Params& P = Q.g;
    const int n_ext = kPt ? Q.x.n_spot + Q.x.n_area + Q.x.n_ml : 0;
    const int base = shared_floats(P);
    const int ns = base + 3 * n_ext;
    const int n_tri9 = (P.flags & FLAG_TRI_SHARED) ? 9 * P.n_tri : 0;
    const int total = ns + n_tri9;
    for (int j = threadIdx.x; j < total; j += blockDim.x) sm[j] = 0.0f;
    __syncthreads();
    Sinks K;
    K.sm = sm;
    K.tri = n_tri9 ? sm + ns : Q.d_tri;
    K.tex = Q.t.d_texels;
    K.sc = P.flags;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < Q.n) diff_ray<true, G, kPt, kTex, kRev>(Q, o, d, out, i, K);
    __syncthreads();
    // one global atomic per block and nonzero value
    const int n_mat = P.n_mat * MAT_GRAD_COLS, n_pl = 3 * P.n_point,
              n_dl = 3 * P.n_dir;
    for (int j = threadIdx.x; j < total; j += blockDim.x) {
      const float v = sm[j];
      if (v == 0.0f) continue;
      float* dst;
      if (j >= ns) {
        dst = Q.d_tri + (j - ns);
      } else if (kPt && j >= base) {
        const int jj = j - base, n_sl = 3 * Q.x.n_spot, n_al = 3 * Q.x.n_area;
        dst = jj < n_sl          ? Q.x.d_sl + jj
              : jj < n_sl + n_al ? Q.x.d_al + (jj - n_sl)
                                 : Q.x.d_ml + (jj - n_sl - n_al);
      } else {
        dst = j < n_mat                 ? Q.d_mat + j
              : j < n_mat + n_pl        ? Q.d_pl + (j - n_mat)
              : j < n_mat + n_pl + n_dl ? Q.d_dl + (j - n_mat - n_pl)
                                        : Q.d_bg + (j - n_mat - n_pl - n_dl);
      }
      atomicAdd(dst, v);
    }
  } else {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < Q.n) diff_ray<false, G, kPt, kTex>(Q, o, d, out, i, Sinks{});
  }
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_kernel(BwdParams Q, const float* __restrict__ o,
                       const float* __restrict__ d, float* __restrict__ out) {
  run<false, FlatChunks>(Q, o, d, out);
}

// K2c's fwd+bwd and K2a's reverse kernel at 4 blocks of 128 threads per SM
// (at most 128 registers): left to itself ptxas took 150 and 3 blocks for
// K2a's fwd+bwd, which ran 15% slower on the gauge scene on an H100, and
// 154 for the reverse kernel, which ran 7% slower (PERF.md)
constexpr int BWD_MIN_BLOCKS = 4;

__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_tree_kernel(BwdParams Q, const float* __restrict__ o,
                            const float* __restrict__ d,
                            float* __restrict__ out) {
  run<false, ChunkTree>(Q, o, d, out);
}

// K2a's reverse kernel: the reverse sweep of each ray from the primal's
// records, over the chunks and the tree alike (it traces nothing)
__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
mega_bwd_rev_kernel(BwdParams Q, const float* __restrict__ o,
                    const float* __restrict__ d, float* __restrict__ out) {
  run<true, FlatChunks, false, false, true>(Q, o, d, out);
}

// K2b's fwd+bwd asks ptxas for no blocks per SM: 1 to 4 blocks of 128
// threads ran within 2% of each other on the three path-traced scenes on an
// H100 (152 registers and no spills at 1; 128 and 92 B of spills at 4;
// PERF.md)
__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_pt_kernel(BwdParams Q, const float* __restrict__ o,
                          const float* __restrict__ d,
                          float* __restrict__ out) {
  run<false, FlatChunks, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_pt_kernel(BwdParams Q, const float* __restrict__ o,
                   const float* __restrict__ d, float* __restrict__ out) {
  run<true, FlatChunks, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_pt_tree_kernel(BwdParams Q, const float* __restrict__ o,
                               const float* __restrict__ d,
                               float* __restrict__ out) {
  run<false, ChunkTree, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_pt_tree_kernel(BwdParams Q, const float* __restrict__ o,
                        const float* __restrict__ d, float* __restrict__ out) {
  run<true, ChunkTree, true>(Q, o, d, out);
}

// K2c: the texture twins of K2a's (with K2a's launch bounds) and of K2b's
// (with K2b's)
__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_tex_kernel(BwdParams Q, const float* __restrict__ o,
                           const float* __restrict__ d,
                           float* __restrict__ out) {
  run<false, FlatChunks, false, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
mega_bwd_tex_kernel(BwdParams Q, const float* __restrict__ o,
                    const float* __restrict__ d, float* __restrict__ out) {
  run<true, FlatChunks, false, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_tex_tree_kernel(BwdParams Q, const float* __restrict__ o,
                                const float* __restrict__ d,
                                float* __restrict__ out) {
  run<false, ChunkTree, false, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
mega_bwd_tex_tree_kernel(BwdParams Q, const float* __restrict__ o,
                         const float* __restrict__ d,
                         float* __restrict__ out) {
  run<true, ChunkTree, false, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_pt_tex_kernel(BwdParams Q, const float* __restrict__ o,
                              const float* __restrict__ d,
                              float* __restrict__ out) {
  run<false, FlatChunks, true, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_pt_tex_kernel(BwdParams Q, const float* __restrict__ o,
                       const float* __restrict__ d, float* __restrict__ out) {
  run<true, FlatChunks, true, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_primal_pt_tex_tree_kernel(BwdParams Q, const float* __restrict__ o,
                                   const float* __restrict__ d,
                                   float* __restrict__ out) {
  run<false, ChunkTree, true, true>(Q, o, d, out);
}

__global__ void __launch_bounds__(THREADS)
mega_bwd_pt_tex_tree_kernel(BwdParams Q, const float* __restrict__ o,
                            const float* __restrict__ d,
                            float* __restrict__ out) {
  run<true, ChunkTree, true, true>(Q, o, d, out);
}

// ---- the refit of the boxes (no TPU counterpart: the JAX kernel keeps
// the initial pack's boxes) ----
//
// K2's tree keeps its topology, child codes and row order from the build;
// each call's vertices (tri_w, 9 floats a row) give its boxes.  Min and max
// do not round, so the boxes are exact in any order, and on the build's own
// vertices they are the built ones.  The work is small (at 32,768 faces:
// 8,192 leaf runs, some 11,000 child slots), so a launch is short and what
// bounds it is its few dependent steps; each pass is one load wide per
// thread.

// Pass 1: one thread per position p of the depth-first order of the leaf
// runs: run j = runs[p], rows j L .. min(j L + L, n_tri) - 1
__global__ void __launch_bounds__(THREADS)
mega_bwd_refit_runs_kernel(const float* __restrict__ tri_w, int n_tri,
                           int leaf_rows, const int* __restrict__ runs,
                           int n_runs, float* __restrict__ run_box) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_runs) return;
  const int first = __ldg(runs + p) * leaf_rows;
  const int last = min(first + leaf_rows, n_tri);
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int f = first; f < last; ++f) {
    const float* v = tri_w + static_cast<size_t>(f) * 9;
    for (int j = 0; j < 9; ++j) {
      const float x = __ldg(v + j);
      lo[j % 3] = fminf(lo[j % 3], x);
      hi[j % 3] = fmaxf(hi[j % 3], x);
    }
  }
  float* b = run_box + static_cast<size_t>(p) * 6;
  for (int c = 0; c < 3; ++c) {
    b[c] = lo[c];
    b[3 + c] = hi[c];
  }
}

// Pass 2: one warp per child slot (node * NODE_W + k) over its span
// (first, count) of pass 1's boxes, its lanes strided and then reduced by
// shuffles; the slot's six box words from them (count 0, no child: as
// built), its code and row count as built.
__global__ void __launch_bounds__(THREADS)
mega_bwd_refit_nodes_kernel(const float* __restrict__ run_box,
                            const int* __restrict__ spans,
                            const float* __restrict__ tree, int n_slots,
                            float* __restrict__ nodes) {
  const int slot = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (slot >= n_slots) return;  // the whole warp
  const int first = __ldg(spans + 2 * slot),
            count = __ldg(spans + 2 * slot + 1);
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int p = first + lane; p < first + count; p += 32) {
    const float* b = run_box + static_cast<size_t>(p) * 6;
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], b[c]);
      hi[c] = fmaxf(hi[c], b[3 + c]);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], off));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], off));
    }
  const int node = slot / NODE_W, k = slot % NODE_W;
  const size_t at = static_cast<size_t>(node) * NODE_COLS + k;
  if (lane < 8) {
    // words min x, y, z, max x, y, z, the code and the row count
    const float box = lane == 0   ? lo[0]
                      : lane == 1 ? lo[1]
                      : lane == 2 ? lo[2]
                      : lane == 3 ? hi[0]
                      : lane == 4 ? hi[1]
                                  : hi[2];
    nodes[at + lane * NODE_W] = lane < 6 && count > 0
                                    ? box
                                    : __ldg(tree + at + lane * NODE_W);
  }
}

// The chunk sweep's boxes: one warp per 128-row chunk (the rows below
// max(n_tri, 1): a scene without faces has one zero row, as built)
__global__ void __launch_bounds__(THREADS)
mega_bwd_refit_chunks_kernel(const float* __restrict__ tri_w, int n_tri,
                             int n_chunks, float* __restrict__ chunk) {
  const int ci = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ci >= n_chunks) return;  // the whole warp
  const int hi_row = min(ci * CHUNK + CHUNK, max(n_tri, 1));
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int f = ci * CHUNK + lane; f < hi_row; f += 32) {
    const float* v = tri_w + static_cast<size_t>(f) * 9;
    for (int j = 0; j < 9; ++j) {
      const float x = __ldg(v + j);
      lo[j % 3] = fminf(lo[j % 3], x);
      hi[j % 3] = fmaxf(hi[j % 3], x);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], off));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], off));
    }
  if (lane == 0) {
    float* b = chunk + static_cast<size_t>(ci) * 8;
    for (int c = 0; c < 3; ++c) {
      b[c] = lo[c];
      b[3 + c] = hi[c];
    }
    b[6] = 0.0f;
    b[7] = 0.0f;
  }
}

}  // namespace mb

// ---- C interface (loaded with ctypes) ----

// gbar null: the primal instantiation (the cotangent pointers unused), else
// the backward: K2a's reverse kernel, or K2b's and K2c's fwd+bwd; nodes: the
// tree, or null (the chunk sweep); ext: K2b's tables, or null for K2a; tex:
// K2c's, or null without textures.  consts = eps, ambient 3.  flags: the
// scene's switches, the backward's targets (SC_*) and the rows' sums kept
// per block (FLAG_TRI_SHARED).  rec: K2a's records, which its primal writes
// where not null and its reverse kernel reads (it must not be null there);
// null for K2b and K2c.  The cotangent buffers must be zeroed by the
// caller; a target not asked for stays so.
extern "C" int mega_bwd_launch(
    const float* o, const float* d, const float* gbar, float* out, int n,
    const float* tri, int n_tri, const float* chunk, int n_chunks,
    const float* nodes, const float* sph, int n_sph, const float* mat,
    int n_mat, const float* pl, int n_point, const float* dl, int n_dir,
    const float* bg, const float* consts, const float* ud, int depth,
    int max_depth, int flags, unsigned seed, unsigned step, float* d_tri,
    float* d_mat, float* d_pl, float* d_dl, float* d_bg, float* d_o,
    float* d_d, float* rec, const mb::BwdExt* ext, const mb::BwdTex* tex,
    void* stream) {
  const int n_ext = ext ? ext->n_spot + ext->n_area + ext->n_ml : 0;
  const bool k2a = ext == nullptr && tex == nullptr;
  if (n <= 0 || depth < 1 ||
      depth > (ext ? mb::MAX_SEG : mb::MAX_SEG_WHITTED) ||
      n_point + n_dir + n_ext > mb::VIS_BITS ||
      (ext && ext->n_ml > mb::MAX_ML) || (rec != nullptr && !k2a) ||
      (gbar != nullptr && k2a && rec == nullptr))
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
  Q.rec = rec;
  Q.n = n;
  Q.depth = depth;
  Q.seed = seed;
  Q.step = step;
  Q.x = ext ? *ext : mb::BwdExt{};
  Q.t = tex ? *tex : mb::BwdTex{};
  const int blocks = (n + mw::THREADS - 1) / mw::THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Kernel = void (*)(mb::BwdParams, const float*, const float*, float*);
  // [backward][K2b][K2c][tree]
  static const Kernel kernels[2][2][2][2] = {
      {{{mb::mega_bwd_primal_kernel, mb::mega_bwd_primal_tree_kernel},
        {mb::mega_bwd_primal_tex_kernel, mb::mega_bwd_primal_tex_tree_kernel}},
       {{mb::mega_bwd_primal_pt_kernel, mb::mega_bwd_primal_pt_tree_kernel},
        {mb::mega_bwd_primal_pt_tex_kernel,
         mb::mega_bwd_primal_pt_tex_tree_kernel}}},
      {{{mb::mega_bwd_rev_kernel, mb::mega_bwd_rev_kernel},
        {mb::mega_bwd_tex_kernel, mb::mega_bwd_tex_tree_kernel}},
       {{mb::mega_bwd_pt_kernel, mb::mega_bwd_pt_tree_kernel},
        {mb::mega_bwd_pt_tex_kernel, mb::mega_bwd_pt_tex_tree_kernel}}}};
  const Kernel kern = kernels[gbar != nullptr][ext != nullptr][tex != nullptr]
                             [nodes != nullptr];
  if (gbar == nullptr) {
    kern<<<blocks, mw::THREADS, 0, st>>>(Q, o, d, out);
    return static_cast<int>(cudaGetLastError());
  }
  if ((flags & mb::FLAG_TRI_SHARED) && !(flags & mb::SC_TRI))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(mb::block_floats(
      n_mat, n_point + n_dir, n_ext, n_tri, flags));
  // past 48 KB (some 700 materials, with the rows' 9 KB) the kernel must
  // opt in to the larger dynamic shared memory
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<blocks, mw::THREADS, smem, st>>>(Q, o, d, out);
  return static_cast<int>(cudaGetLastError());
}

// The refit of the boxes (ops/megabwd.py::refit): with nodes, the tree's
// (runs and spans as ops/megabwd.py::refit_spans gives them, and the built
// tree; run_box scratch of 6 floats per run); with chunk, the chunk sweep's.
extern "C" int mega_bwd_refit_launch(const float* tri_w, int n_tri,
                                     int leaf_rows, const int* runs,
                                     int n_runs, const int* spans,
                                     const float* tree, int n_nodes,
                                     float* run_box, float* nodes,
                                     float* chunk, int n_chunks,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = mw::THREADS;
  if (nodes != nullptr) {
    if (n_runs <= 0 || n_nodes <= 0 || leaf_rows < 1 || leaf_rows > 31 ||
        runs == nullptr || spans == nullptr || tree == nullptr ||
        run_box == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    mb::mega_bwd_refit_runs_kernel<<<(n_runs + T - 1) / T, T, 0, st>>>(
        tri_w, n_tri, leaf_rows, runs, n_runs, run_box);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long threads = 32LL * n_nodes * mw::NODE_W;
    mb::mega_bwd_refit_nodes_kernel<<<static_cast<int>((threads + T - 1) / T),
                                      T, 0, st>>>(run_box, spans, tree,
                                                  n_nodes * mw::NODE_W, nodes);
  }
  if (chunk != nullptr) {
    if (n_chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
    mb::mega_bwd_refit_chunks_kernel<<<(32 * n_chunks + T - 1) / T, T, 0,
                                       st>>>(tri_w, n_tri, n_chunks, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
