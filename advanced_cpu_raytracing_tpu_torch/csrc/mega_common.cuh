// mega_common.cuh — scene tables and ray queries shared by the megakernel
// variants (mega_whitted.cu: K1a, mega_pt.cu: K1b, K1c and K1d).
//
// The closest hit over BVH-ordered 128-face triangle chunks behind AABB
// slab culls plus analytic spheres, and the shadow query, of the TPU kernel
// advanced_cpu_raytracing_tpu/ops/pallas/megakernel.py::_kernel (tri_hit,
// sphere_hit, chunk_sweep, trace, shadow: lines 1362-1747).  The table
// layouts are those of ops/megakernel.py (TRI_COLS, SPH_COLS, MAT_COLS,
// LIGHT_COLS, MOTION_COLS).  The lanes of a warp sweep a chunk together, so
// a face row is one broadcast load through the read-only path, and a
// 98,304-face table (6 MB) stays in the 50 MB L2.  The queries take the
// scene's motion as a type: NoMotion (K1a, K1b) compiles to the static
// scene's code, Motion (K1c) moves each test's ray origin by +motion * tau
// before the test, as the TPU kernel does (lines 1379-1382, 1421-1425).
//
// They take the geometry as a type too.  FlatChunks sweeps the 128-face
// chunks in table order: the TPU kernel's layout, which keeps at most
// 98,304 faces in VMEM and sweeps a chunk across its 128 lanes.  On the
// card that sweep slab-tests every chunk box of the table for every query
// and runs all 128 face tests of each chunk the ray enters below t_best,
// in table order, so a closest hit cannot stop early and the lanes of a
// warp wait for the one that entered the most boxes: on the 32,768-face
// torus scenes of K1a and K1c it ran at 2.6-3.2% of its FP32 bound
// (PERF.md).  ChunkTree (K1e) walks a BVH instead, and the forward route
// takes it for every scene past one chunk (ops/megakernel.py::
// FWD_FLAT_MAX_FACES); FlatChunks stays for a scene of one chunk, whose
// sweep is one brute loop, and for K2's tables below 98,304 faces.  The
// tree (ops/megakernel.py::_tree_table) has leaves of at most 4
// consecutive rows and nodes of NODE_W = 4 children: a node is its
// children's boxes SoA and their references, 128 bytes, one cache line
// read as eight 16-byte loads, so a step costs one line where a binary
// node cost four dependent loads, and the tree is half as deep.  Each
// thread walks it with a stack of TREE_STACK entries in local memory
// (the host checks the tree's need: the most its walk can push); the
// children in reach are visited nearest first by entry distance.  The
// slab test keeps a box whose face plane the ray runs in.  The walk visits
// faces out of row order, so the closest hit keeps a child while its entry
// is <= t_best and takes a face at t < t_best, or at t == t_best from a
// lower row: the sequential sweep's winner, the lowest row among the
// closest faces, bit for bit.  Bound: the FP32 work of the box and face
// tests the walk does (ops/megakernel.py::TreeWalker counts them, 22 per
// box and 38 per face) above the bytes of what it reads once (the lines of
// the nodes visited, the vertices of the rows tested, the winners' rows);
// the walks of a warp still diverge, and each node load waits on the last.

#pragma once

#include <cuda_runtime.h>

namespace mw {

constexpr float BIG = 3.0e37f;  // "no hit" distance
constexpr int CHUNK = 128;      // faces per culling chunk
constexpr int TRI_COLS = 16;    // v0 v1 v2 (0:9) normal (9:12) mat (12)
                                // mesh light (13) emissive (14)
constexpr int SPH_COLS = 26;    // minv 3x4, nrm 3x3, center, radius, mat
constexpr int MAT_COLS = 22;    // type amb3 kd3 ks3 mirror3 phong ior k
                                // absorb3 emission3
constexpr int LIGHT_COLS = 6;   // pos|dir 3, intensity|radiance 3
constexpr int MAT_MIRROR = 1, MAT_DIELECTRIC = 2, MAT_CONDUCTOR = 3,
              MAT_EMISSIVE = 4;
constexpr int FLAG_MIRROR = 1, FLAG_DIELECTRIC = 2, FLAG_CONDUCTOR = 4;
constexpr int THREADS = 128;
constexpr int NODE_W = 4;        // children per tree node
constexpr int NODE_COLS = 8 * NODE_W;  // a tree node, 128 bytes: its
                                 // children's boxes SoA (min x, y, z, max x,
                                 // y, z: NODE_W f32 each), then per child an
                                 // int32 code (a node's row; ~(first row << 5
                                 // | row count) for a leaf; 0: no child) and
                                 // the row count the host reads
constexpr int TREE_STACK = 64;   // the walk's stack entries; the host checks
                                 // the tree's need

struct Params {
  const float* tri;
  int n_tri;
  const float* chunk;
  int n_chunks;
  const float* nodes;  // the tree (ChunkTree), or null
  const float* sph;
  int n_sph;
  const float* mat;
  int n_mat;
  const float* pl;
  int n_point;
  const float* dl;
  int n_dir;
  float eps, amb[3], bg[3];
  int max_depth, stack_k, max_iters, flags;
};

// The scene part of the launch arguments; consts = eps, ambient 3, bg 3.
inline Params make_params(const float* tri, int n_tri, const float* chunk,
                          int n_chunks, const float* nodes, const float* sph,
                          int n_sph,
                          const float* mat, int n_mat, const float* pl,
                          int n_point, const float* dl, int n_dir,
                          const float* consts, int max_depth, int stack_k,
                          int max_iters, int flags) {
  Params P;
  P.tri = tri;
  P.n_tri = n_tri;
  P.chunk = chunk;
  P.n_chunks = n_chunks;
  P.nodes = nodes;
  P.sph = sph;
  P.n_sph = n_sph;
  P.mat = mat;
  P.n_mat = n_mat;
  P.pl = pl;
  P.n_point = n_point;
  P.dl = dl;
  P.n_dir = n_dir;
  P.eps = consts[0];
  for (int k = 0; k < 3; ++k) {
    P.amb[k] = consts[1 + k];
    P.bg[k] = consts[4 + k];
  }
  P.max_depth = max_depth;
  P.stack_k = stack_k;
  P.max_iters = max_iters;
  P.flags = flags;
  return P;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  x *= inv;
  y *= inv;
  z *= inv;
}

// Philox4x32-10 (Random123): counter c, key (k0, k1); ops/rng.py holds
// its torch twin
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

// pow with the base clamped > 0 and C-style pow(0, 0) = 1
__device__ __forceinline__ float powmax(float base, float e) {
  const bool pos = base > 0.0f;
  const float val = expf(e * logf(pos ? base : 1.0f));
  return pos ? val : (e == 0.0f ? 1.0f : 0.0f);
}

// Axis-swap orthonormal basis (GetOrthonormalBasis, helperMath.cpp:59-85):
// u = unit(r' x n), v = unit(n x u), r' = n with its smallest component set
// to 1 (x only where strictly smallest, else y where below z, else z)
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

// The GI direction of the uniforms (r1, r2) about the unit normal n
// (ComputeGlobalIllumination, raytracer.cpp:143-173): phi = 2 pi r1, and
// theta = asin(sqrt(r2)) with importance sampling, else acos(r2); the
// plain versions' ops/megakernel.py::_gi_direction computes the same
__device__ __forceinline__ void gi_direction(float nx, float ny, float nz,
                                             float r1, float r2,
                                             bool importance, float& gdx,
                                             float& gdy, float& gdz) {
  const float phi = 6.283185307179586f * r1;
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
}

// A spot light's falloff at cos a, the cone tests in cosine space
// (spotLight.h:33-57): 0 outside the coverage cone and on its axis, ((cos a
// - cos(cov/2)) / (cos(fall/2) - cos(cov/2)))^4 between the cones, 1 inside
// the falloff cone; L is the light's row (cos(cov/2) 9, cos(fall/2) 10, the
// denominator 11)
__device__ __forceinline__ float spot_falloff(const float* L, float cos_a) {
  const float frac = fmaxf((cos_a - L[9]) / L[11], 0.0f);
  float scale = cos_a < L[10] ? frac * frac * frac * frac : 1.0f;
  if (cos_a >= 1.0f || cos_a < L[9]) scale = 0.0f;
  return scale;
}

// A static scene.
struct NoMotion {
  static constexpr bool kOn = false;
};

// A scene with motion blur: per-face world motion (n_tri, 3) and per-sphere
// object-space motion (n_sph, 3) at the ray's time tau; a table is null
// when none of its faces (spheres) moves, and its tests then skip the move.
struct Motion {
  static constexpr bool kOn = true;
  const float* tri;
  const float* sph;
  float tau;
};

// The origin of the test of face f: moved by +motion * tau (mesh.cpp:
// 167-170), the same as sweeping the face by -motion.
template <class M>
__device__ __forceinline__ void move_to_face(const M& mo, int f, float& px,
                                             float& py, float& pz) {
  if constexpr (M::kOn) {
    if (mo.tri != nullptr) {
      const float* m = mo.tri + 3 * f;
      px = px + __ldg(m) * mo.tau;
      py = py + __ldg(m + 1) * mo.tau;
      pz = pz + __ldg(m + 2) * mo.tau;
    }
  }
}

// Cramer's rule (Mesh::IntersectFace, src/mesh.cpp:201-236) for the face
// row r.  True when the ray hits it at 0 < t < t_max.  The barycentrics are
// computed only once t passes, which changes no value.
__device__ __forceinline__ bool tri_hit(const float* r, float px, float py,
                                        float pz, float vx, float vy,
                                        float vz, float t_max, float& t) {
  const float4 a = ld4(r);      // v0x v0y v0z v1x
  const float4 b = ld4(r + 4);  // v1y v1z v2x v2y
  const float v2z = __ldg(r + 8);
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = v0x - a.w, e1y = v0y - b.x, e1z = v0z - b.y;
  const float e2x = v0x - b.z, e2y = v0y - b.w, e2z = v0z - v2z;
  const float bx = v0x - px, by = v0y - py, bz = v0z - pz;
  const float m0 = e2y * vz - vy * e2z;
  const float m1 = e2x * vz - vx * e2z;
  const float m2 = e2x * vy - vx * e2y;
  const float det = e1x * m0 - e1y * m1 + e1z * m2;
  const float safe = det == 0.0f ? 1.0f : det;
  const float q0 = e2y * bz - by * e2z;
  const float q1 = e2x * bz - bx * e2z;
  const float q2 = e2x * by - bx * e2y;
  t = (e1x * q0 - e1y * q1 + e1z * q2) / safe;
  if (!(det != 0.0f && t > 0.0f && t < t_max)) return false;
  const float beta = (bx * m0 - by * m1 + bz * m2) / safe;
  const float n0 = by * vz - vy * bz;
  const float n1 = bx * vz - vx * bz;
  const float n2 = bx * vy - vx * by;
  const float gamma = (e1x * n0 - e1y * n1 + e1z * n2) / safe;
  return beta >= 0.0f && gamma >= 0.0f && beta + gamma <= 1.0f;
}

// tri_hit of face f (row r) at the origin that the motion gives it
template <class M>
__device__ __forceinline__ bool tri_hit_m(const M& mo, int f, const float* r,
                                          float px, float py, float pz,
                                          float vx, float vy, float vz,
                                          float t_max, float& t) {
  move_to_face(mo, f, px, py, pz);
  return tri_hit(r, px, py, pz, vx, vy, vz, t_max, t);
}

// Sphere::Intersect (src/sphere.cpp:31-72): the ray in object space, then
// the quadratic.  The unnormalised world normal (M^-T applied to the local
// hit minus the center) goes to nw* when asked for.  With motion, sphere
// si's local origin moves by +motion * tau.
template <class M = NoMotion>
__device__ __forceinline__ bool sphere_hit(const float* s, float px, float py,
                                           float pz, float vx, float vy,
                                           float vz, float& t, float* nw,
                                           const M& mo = M(), int si = 0) {
  float olx = s[0] * px + s[1] * py + s[2] * pz + s[3];
  float oly = s[4] * px + s[5] * py + s[6] * pz + s[7];
  float olz = s[8] * px + s[9] * py + s[10] * pz + s[11];
  if constexpr (M::kOn) {
    if (mo.sph != nullptr) {
      const float* m = mo.sph + 3 * si;
      olx = olx + m[0] * mo.tau;
      oly = oly + m[1] * mo.tau;
      olz = olz + m[2] * mo.tau;
    }
  }
  const float dlx = s[0] * vx + s[1] * vy + s[2] * vz;
  const float dly = s[4] * vx + s[5] * vy + s[6] * vz;
  const float dlz = s[8] * vx + s[9] * vy + s[10] * vz;
  const float ocx = olx - s[21], ocy = oly - s[22], ocz = olz - s[23];
  const float rad = s[24];
  const float a = dlx * dlx + dly * dly + dlz * dlz;
  const float b = 2.0f * (dlx * ocx + dly * ocy + dlz * ocz);
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float delta = b * b - 4.0f * a * cc;
  const float sq = sqrtf(fmaxf(delta, 0.0f));
  const float denom = a > 0.0f ? 2.0f * a : 1.0f;
  const float t1 = (-b + sq) / denom;
  const float t2 = (-b - sq) / denom;
  const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
  t = lo > 0.0f ? lo : hi;
  const bool valid = delta >= 0.0f && t > 0.0f && a > 0.0f;
  if (valid && nw != nullptr) {
    const float prx = ocx + t * dlx, pry = ocy + t * dly, prz = ocz + t * dlz;
    nw[0] = s[12] * prx + s[13] * pry + s[14] * prz;
    nw[1] = s[15] * prx + s[16] * pry + s[17] * prz;
    nw[2] = s[18] * prx + s[19] * pry + s[20] * prz;
  }
  return valid;
}

// One axis of a slab test: the distances at which the ray enters and
// leaves [lo, hi] along it.  A ray parallel to the axis (iv = +-inf) that
// lies on one of the two planes makes 0 * inf = NaN there; that plane then
// counts as not limiting the ray, so the chunk sweep and the
// walk keep every box the ray touches.
__device__ __forceinline__ void slab_axis(float lo, float hi, float p,
                                          float iv, float& t_in,
                                          float& t_out) {
  float t1 = (lo - p) * iv, t2 = (hi - p) * iv;
  const float inf = copysignf(__int_as_float(0x7f800000), iv);
  if (t1 != t1) t1 = -inf;
  if (t2 != t2) t2 = inf;
  t_in = fminf(t1, t2);
  t_out = fmaxf(t1, t2);
}

// Chunk AABB slab test (BoundingBox, shape.hpp:78-100) against the ray's
// current reject distance.  A ray in a face plane of the box keeps it
// (slab_axis); the TPU kernel's chunk_sweep drops such a box.
__device__ __forceinline__ bool slab(const float* box, float px, float py,
                                     float pz, float ivx, float ivy,
                                     float ivz, float t_b) {
  const float4 lo = ld4(box);      // min xyz, max x
  const float4 hi = ld4(box + 4);  // max yz, pad
  float tmin, tmax, t_in, t_out;
  slab_axis(lo.x, lo.w, px, ivx, tmin, tmax);
  slab_axis(lo.y, hi.x, py, ivy, t_in, t_out);
  tmin = fmaxf(tmin, t_in);
  tmax = fminf(tmax, t_out);
  slab_axis(lo.z, hi.y, pz, ivz, t_in, t_out);
  tmin = fmaxf(tmin, t_in);
  tmax = fminf(tmax, t_out);
  return tmax > 0.0f && tmax >= tmin && tmin < t_b;
}

// The geometry of trace and shadow: the 128-face chunks in table order,
// or the tree (K1e).
struct FlatChunks {
  static constexpr bool kTree = false;
};
struct ChunkTree {
  static constexpr bool kTree = true;
};

// The slab test of one child's box (its six planes): the ray's entry
// distance, or +inf where the ray misses the box.
__device__ __forceinline__ float slab_entry(float lox, float loy, float loz,
                                            float hix, float hiy, float hiz,
                                            float px, float py, float pz,
                                            float ivx, float ivy, float ivz) {
  float tmin, tmax, t_in, t_out;
  slab_axis(lox, hix, px, ivx, tmin, tmax);
  slab_axis(loy, hiy, py, ivy, t_in, t_out);
  tmin = fmaxf(tmin, t_in);
  tmax = fminf(tmax, t_out);
  slab_axis(loz, hiz, pz, ivz, t_in, t_out);
  tmin = fmaxf(tmin, t_in);
  tmax = fminf(tmax, t_out);
  return tmax > 0.0f && tmax >= tmin ? tmin : __int_as_float(0x7f800000);
}

// Word j of a 16-byte load (j known at compile time)
__device__ __forceinline__ float lane(const float4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane(const int4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The tree walk (K1e).  kAny: any face hit below tb (the shadow limit),
// skipping emissive faces with kSkipEmissive; returns at the first.  Else
// the closest hit: tb and best become the lowest row among the closest
// faces, as the sequential sweep finds it.  A node is one 128-byte line:
// its children's boxes, tested together, and those in reach visited
// nearest first (the others pushed, the farthest deepest).
template <bool kAny, bool kSkipEmissive, class M>
__device__ bool tree_walk(const Params& P, const M& mo, float px, float py,
                          float pz, float vx, float vy, float vz, float& tb,
                          int& best) {
  const float ivx = 1.0f / vx, ivy = 1.0f / vy, ivz = 1.0f / vz;
  const float inf = __int_as_float(0x7f800000);
  // the stack: a child's code and its entry distance
  int2 stk[TREE_STACK];
  int sp = 0;
  // in hand: node ref (cnt 0), or the leaf of rows ref .. ref + cnt - 1
  int ref = 0, cnt = 0;
  while (true) {
    if (cnt > 0) {
      for (int f = ref; f < ref + cnt; ++f) {
        const float* r = P.tri + f * TRI_COLS;
        float t;
        if constexpr (kAny) {
          if (tri_hit_m(mo, f, r, px, py, pz, vx, vy, vz, tb, t) &&
              !(kSkipEmissive && __ldg(r + 14) >= 0.5f))
            return true;
        } else {
          // t <= tb passes (the next float above tb > 0); at t == tb the
          // lower row wins
          if (tri_hit_m(mo, f, r, px, py, pz, vx, vy, vz,
                        __int_as_float(__float_as_int(tb) + 1), t) &&
              (t < tb || f < best)) {
            tb = t;
            best = f;
          }
        }
      }
    } else {
      const float4* nd =
          reinterpret_cast<const float4*>(P.nodes + ref * NODE_COLS);
      const int4* ni = reinterpret_cast<const int4*>(nd);
      constexpr int Q4 = NODE_W / 4;  // 16-byte words per component
      float t[NODE_W];
      int r[NODE_W];  // the children's codes
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        const float4 lx = __ldg(nd + q), ly = __ldg(nd + Q4 + q),
                     lz = __ldg(nd + 2 * Q4 + q), hx = __ldg(nd + 3 * Q4 + q),
                     hy = __ldg(nd + 4 * Q4 + q), hz = __ldg(nd + 5 * Q4 + q);
        const int4 cr = __ldg(ni + 6 * Q4 + q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t[4 * q + j] = slab_entry(lane(lx, j), lane(ly, j), lane(lz, j),
                                    lane(hx, j), lane(hy, j), lane(hz, j), px,
                                    py, pz, ivx, ivy, ivz);
          r[4 * q + j] = lane(cr, j);
        }
      }
#pragma unroll
      for (int k = 0; k < NODE_W; ++k)
        if (r[k] == 0 || (kAny ? !(t[k] < tb) : !(t[k] <= tb))) t[k] = inf;
      // nearest first: an insertion sort, stable on equal entries
#pragma unroll
      for (int k = 1; k < NODE_W; ++k) {
#pragma unroll
        for (int j = k; j > 0; --j) {
          if (t[j] < t[j - 1]) {
            const float tt = t[j];
            const int rr = r[j];
            t[j] = t[j - 1];
            r[j] = r[j - 1];
            t[j - 1] = tt;
            r[j - 1] = rr;
          }
        }
      }
      if (t[0] < inf) {
#pragma unroll
        for (int k = NODE_W - 1; k > 0; --k) {
          if (t[k] < inf) {
            stk[sp] = make_int2(r[k], __float_as_int(t[k]));
            ++sp;
          }
        }
        ref = r[0] < 0 ? ~r[0] >> 5 : r[0];
        cnt = r[0] < 0 ? ~r[0] & 31 : 0;
        continue;
      }
    }
    // pop the next entry still in reach
    int2 e;
    do {
      if (sp == 0) return false;
      e = stk[--sp];
    } while (kAny ? !(__int_as_float(e.y) < tb)
                  : !(__int_as_float(e.y) <= tb));
    ref = e.x < 0 ? ~e.x >> 5 : e.x;
    cnt = e.x < 0 ? ~e.x & 31 : 0;
  }
}

struct Hit {
  float t, nx, ny, nz;
  int mat;
  int ml;  // mesh light of the face hit, -1 for none (kMeshLight only)
  bool hit;
};

// Closest hit: faces in table order, then spheres in index order, each with
// the strict t < t_best test, so a tie keeps the earlier face.  With
// kMeshLight the winner's mesh-light id comes along; a sphere resets it.
// With kWin, win[0] names the winning face and win[1] the winning sphere
// (-1 where the other won or nothing was hit).  The chunk and node culls
// test the unmoved origin against boxes swept over the motion.
template <bool kMeshLight, class M = NoMotion, bool kWin = false,
          class G = FlatChunks>
__device__ Hit trace(const Params& P, float px, float py, float pz, float vx,
                     float vy, float vz, const M& mo = M(),
                     int* win = nullptr) {
  float tb = BIG;
  int best = -1;
  if (P.n_tri > 0) {
    if constexpr (G::kTree) {
      tree_walk<false, false>(P, mo, px, py, pz, vx, vy, vz, tb, best);
    } else if (P.n_chunks <= 1) {
      for (int f = 0; f < P.n_tri; ++f) {
        float t;
        if (tri_hit_m(mo, f, P.tri + f * TRI_COLS, px, py, pz, vx, vy, vz,
                      tb, t)) {
          tb = t;
          best = f;
        }
      }
    } else {
      const float ivx = 1.0f / vx, ivy = 1.0f / vy, ivz = 1.0f / vz;
      for (int ci = 0; ci < P.n_chunks; ++ci) {
        if (!slab(P.chunk + ci * 8, px, py, pz, ivx, ivy, ivz, tb)) continue;
        const int hi = min(ci * CHUNK + CHUNK, P.n_tri);
        for (int f = ci * CHUNK; f < hi; ++f) {
          float t;
          if (tri_hit_m(mo, f, P.tri + f * TRI_COLS, px, py, pz, vx, vy, vz,
                        tb, t)) {
            tb = t;
            best = f;
          }
        }
      }
    }
  }
  Hit h;
  h.nx = 0.0f;
  h.ny = 0.0f;
  h.nz = 1.0f;
  h.mat = 0;
  h.ml = -1;
  if (best >= 0) {
    const float* r = P.tri + best * TRI_COLS;
    h.nx = __ldg(r + 9);
    h.ny = __ldg(r + 10);
    h.nz = __ldg(r + 11);
    h.mat = static_cast<int>(__ldg(r + 12));
    if (kMeshLight) h.ml = static_cast<int>(__ldg(r + 13));
  }
  int best_sph = -1;
  for (int s = 0; s < P.n_sph; ++s) {
    const float* row = P.sph + s * SPH_COLS;
    float t, nw[3];
    if (sphere_hit(row, px, py, pz, vx, vy, vz, t, nw, mo, s) && t < tb) {
      tb = t;
      h.nx = nw[0];
      h.ny = nw[1];
      h.nz = nw[2];
      h.mat = static_cast<int>(row[25]);
      h.ml = -1;
      if constexpr (kWin) best_sph = s;
    }
  }
  if constexpr (kWin) {
    win[0] = best_sph >= 0 ? -1 : best;
    win[1] = best_sph;
  }
  h.t = tb;
  h.hit = tb < BIG * 0.5f;
  norm3(h.nx, h.ny, h.nz);
  return h;
}

// Any hit closer than `limit` along unit v (IsInShadow,
// src/raytracer.cpp:567-583); returns at the first blocker.  With
// kSkipEmissive, emissive faces cast no shadow (CastShadowRay,
// raytracer.cpp:590-593).
template <bool kSkipEmissive, class M = NoMotion, class G = FlatChunks>
__device__ bool shadow(const Params& P, float px, float py, float pz,
                       float vx, float vy, float vz, float limit,
                       const M& mo = M()) {
  if constexpr (G::kTree) {
    if (P.n_tri > 0) {
      float lim = limit;
      int none = -1;
      if (tree_walk<true, kSkipEmissive>(P, mo, px, py, pz, vx, vy, vz, lim,
                                         none))
        return true;
    }
  } else if (P.n_tri > 0) {
    float t;
    if (P.n_chunks <= 1) {
      for (int f = 0; f < P.n_tri; ++f) {
        const float* r = P.tri + f * TRI_COLS;
        if (tri_hit_m(mo, f, r, px, py, pz, vx, vy, vz, limit, t) &&
            !(kSkipEmissive && __ldg(r + 14) >= 0.5f))
          return true;
      }
    } else {
      const float ivx = 1.0f / vx, ivy = 1.0f / vy, ivz = 1.0f / vz;
      for (int ci = 0; ci < P.n_chunks; ++ci) {
        if (!slab(P.chunk + ci * 8, px, py, pz, ivx, ivy, ivz, limit))
          continue;
        const int hi = min(ci * CHUNK + CHUNK, P.n_tri);
        for (int f = ci * CHUNK; f < hi; ++f) {
          const float* r = P.tri + f * TRI_COLS;
          if (tri_hit_m(mo, f, r, px, py, pz, vx, vy, vz, limit, t) &&
              !(kSkipEmissive && __ldg(r + 14) >= 0.5f))
            return true;
        }
      }
    }
  }
  for (int s = 0; s < P.n_sph; ++s) {
    float t;
    if (sphere_hit(P.sph + s * SPH_COLS, px, py, pz, vx, vy, vz, t, nullptr,
                   mo, s) && t < limit)
      return true;
  }
  return false;
}

}  // namespace mw
