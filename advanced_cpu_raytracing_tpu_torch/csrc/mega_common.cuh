// mega_common.cuh — scene tables and ray queries shared by the megakernel
// variants (mega_whitted.cu: K1a, mega_pt.cu: K1b).
//
// The closest hit over BVH-ordered 128-face triangle chunks behind AABB
// slab culls plus analytic spheres, and the shadow query, of the TPU kernel
// advanced_cpu_raytracing_tpu/ops/pallas/megakernel.py::_kernel (tri_hit,
// sphere_hit, chunk_sweep, trace, shadow: lines 1362-1747).  The table
// layouts are those of ops/megakernel.py (TRI_COLS, SPH_COLS, MAT_COLS,
// LIGHT_COLS).  The lanes of a warp sweep a chunk together, so a face row is
// one broadcast load through the read-only path, and a 98,304-face table
// (6 MB) stays in the 50 MB L2.

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

struct Params {
  const float* tri;
  int n_tri;
  const float* chunk;
  int n_chunks;
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
                          int n_chunks, const float* sph, int n_sph,
                          const float* mat, int n_mat, const float* pl,
                          int n_point, const float* dl, int n_dir,
                          const float* consts, int max_depth, int stack_k,
                          int max_iters, int flags) {
  Params P;
  P.tri = tri;
  P.n_tri = n_tri;
  P.chunk = chunk;
  P.n_chunks = n_chunks;
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

// pow with the base clamped > 0 and C-style pow(0, 0) = 1
__device__ __forceinline__ float powmax(float base, float e) {
  const bool pos = base > 0.0f;
  const float val = expf(e * logf(pos ? base : 1.0f));
  return pos ? val : (e == 0.0f ? 1.0f : 0.0f);
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

// Sphere::Intersect (src/sphere.cpp:31-72): the ray in object space, then
// the quadratic.  The unnormalised world normal (M^-T applied to the local
// hit minus the center) goes to nw* when asked for.
__device__ __forceinline__ bool sphere_hit(const float* s, float px, float py,
                                           float pz, float vx, float vy,
                                           float vz, float& t, float* nw) {
  const float olx = s[0] * px + s[1] * py + s[2] * pz + s[3];
  const float oly = s[4] * px + s[5] * py + s[6] * pz + s[7];
  const float olz = s[8] * px + s[9] * py + s[10] * pz + s[11];
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

// Chunk AABB slab test (BoundingBox, shape.hpp:78-100) against the ray's
// current reject distance.
__device__ __forceinline__ bool slab(const float* box, float px, float py,
                                     float pz, float ivx, float ivy,
                                     float ivz, float t_b) {
  const float4 lo = ld4(box);      // min xyz, max x
  const float4 hi = ld4(box + 4);  // max yz, pad
  float t1 = (lo.x - px) * ivx, t2 = (lo.w - px) * ivx;
  float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
  t1 = (lo.y - py) * ivy;
  t2 = (hi.x - py) * ivy;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  t1 = (lo.z - pz) * ivz;
  t2 = (hi.y - pz) * ivz;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  return tmax > 0.0f && tmax >= tmin && tmin < t_b;
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
template <bool kMeshLight>
__device__ Hit trace(const Params& P, float px, float py, float pz, float vx,
                     float vy, float vz) {
  float tb = BIG;
  int best = -1;
  if (P.n_tri > 0) {
    if (P.n_chunks <= 1) {
      for (int f = 0; f < P.n_tri; ++f) {
        float t;
        if (tri_hit(P.tri + f * TRI_COLS, px, py, pz, vx, vy, vz, tb, t)) {
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
          if (tri_hit(P.tri + f * TRI_COLS, px, py, pz, vx, vy, vz, tb, t)) {
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
  for (int s = 0; s < P.n_sph; ++s) {
    const float* row = P.sph + s * SPH_COLS;
    float t, nw[3];
    if (sphere_hit(row, px, py, pz, vx, vy, vz, t, nw) && t < tb) {
      tb = t;
      h.nx = nw[0];
      h.ny = nw[1];
      h.nz = nw[2];
      h.mat = static_cast<int>(row[25]);
      h.ml = -1;
    }
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
template <bool kSkipEmissive>
__device__ bool shadow(const Params& P, float px, float py, float pz,
                       float vx, float vy, float vz, float limit) {
  if (P.n_tri > 0) {
    float t;
    if (P.n_chunks <= 1) {
      for (int f = 0; f < P.n_tri; ++f) {
        const float* r = P.tri + f * TRI_COLS;
        if (tri_hit(r, px, py, pz, vx, vy, vz, limit, t) &&
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
          if (tri_hit(r, px, py, pz, vx, vy, vz, limit, t) &&
              !(kSkipEmissive && __ldg(r + 14) >= 0.5f))
            return true;
        }
      }
    }
  }
  for (int s = 0; s < P.n_sph; ++s) {
    float t;
    if (sphere_hit(P.sph + s * SPH_COLS, px, py, pz, vx, vy, vz, t, nullptr)
        && t < limit)
      return true;
  }
  return false;
}

}  // namespace mw
