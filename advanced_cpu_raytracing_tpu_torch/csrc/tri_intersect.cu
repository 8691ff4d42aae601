// tri_intersect.cu — the dense closest hit (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// advanced_cpu_raytracing_tpu/ops/pallas/tri_intersect.py::_kernel (lines
// 39-107, launched by tri_closest_hit_pallas through pl.pallas_call at line
// 161): every ray against every work item of a small scene (at most 2,048,
// scene/pack.py BRUTE_FORCE_MAX_ITEMS) by Cramer's rule, keeping per ray the
// nearest valid hit: t, the item's index, beta and gamma; t = +inf and index
// -1 where nothing is hit.  The wavefront integrator's brute-force closest
// hits and shadow queries go through it (ops/traverse.py::_brute_tri_best).
// The plain version beside it is ops/tri_intersect.py::tri_closest_hit_ref.
//
// Design.  One ray a thread, 128 threads per block, the grid over the
// rays.  The wrapper builds the item table once per call
// (ops/tri_intersect.py::item_table): 16 floats a row, v0, e1 = v0 - v1,
// e2 = v0 - v2 (the subtractions the TPU kernel does), the motion row and
// padding, so a row is three 16-byte loads.  The table is staged through
// shared memory in tiles of TILE rows; every thread folds a tile's items in
// ascending order into its ray's running minimum (a shared-memory
// broadcast: all lanes read the same row).  One ray a thread
// measured fastest on an H100 once the tests reject early: 2, 4 and 8 rays
// a thread, which read an item once for several tests, ran 3%, 9% and 54%
// slower (PERF.md).  Motion is a template parameter: with it, the origin of
// each test is o + motion * time, in the order of the JAX jnp route
// (ops/traverse.py:123-125), which the TPU kernel cannot take.
//
// Dividing only where a division can change the answer.  A test computes
// the determinant det and the three numerators of beta, gamma and t as the
// TPU kernel does; the TPU kernel then divides each by det (IEEE, div.rn)
// and keeps the item where det != 0, beta >= 0, gamma >= 0,
// beta + gamma <= 1, t > 0, and t < the ray's best t.  Most items fail.
// Here, where |det| lies in [2^-125, 2^125], one approximate reciprocal
// R = rcp.approx(det) (relative error below 2^-22) and three products
// A = rn(num * R) first reject an item when
//   A_beta < -S, A_gamma < -S, A_t < -S  (S = 2^-100),
//   rn(A_beta + A_gamma) > 1 + 2^-16, or A_t > rn(rn(t_best (1 + 2^-18)) + S),
// and det == 0 rejects it outright.  Only the items left are divided, in
// the TPU kernel's order, and tested exactly.  The rejection never drops an
// item the exact test keeps.  With q = num / det in the reals, R normal and
// rn's relative error 2^-24 (absolute 2^-150 below the normal range),
// A = q (1 + d)(1 + e) + h with |d| < 2^-22, |e| <= 2^-24, |h| <= 2^-150, or
// A = +-inf where |q| overflows.  So:
//  - A < -S gives q < -2^-101, whose IEEE quotient is negative: beta >= 0
//    (likewise gamma >= 0, t > 0) fails.  A quotient that underflows to -0
//    (|q| <= 2^-150, a denormal numerator or a huge det) has |A| <= 2^-149
//    and is never rejected: -0 >= 0 holds, and the exact test decides.
//  - rn(A_beta + A_gamma) > 1 + 2^-16 with both exact quotients >= -0
//    (else the sign tests already fail) gives q_beta + q_gamma > 1 + 2^-17,
//    and the rounded quotients' rounded sum exceeds 1.
//  - A_t > rn(rn(t_best (1 + 2^-18)) + S) gives q_t > t_best, so the IEEE
//    quotient, rounded from above a float, is >= t_best: not strictly
//    nearer, and the earlier item keeps a tie.
//  - NaN numerators or determinants compare false and fall through to the
//    exact test; outside the |det| range nothing is rejected but det == 0.
// The survivors run the unchanged expressions, so t, index, beta and gamma
// equal the plain version's bit for bit.
//
// Bound.  FP32 work on the CUDA cores: 61 operations per ray x item test
// (the 3 differences of b, 27 products and differences of the three cross
// terms, 15 of the three determinants, 3 IEEE divisions, beta + gamma and
// 7 comparisons; 6 more with motion), against 40 bytes of rays in and
// results out per ray (52 with motion): operations bound it.  Built with
// -fmad=false (no FMA), the FP32 pipe issues at most half the 67 TFLOP/s
// that bound assumes.

#include <cuda_runtime.h>

namespace k3 {

constexpr int THREADS = 128;
constexpr int TILE = 256;    // items per shared-memory tile (16 KB)
constexpr int COLS = 16;     // v0 0:3, e1 3:6, e2 6:9, motion 9:12, pad
constexpr float BIG = 3.0e38f;  // the TPU kernel's "no hit" (_INF)
// the rejection's margins (header): S, and the ranges it trusts
constexpr float SLACK = 7.888609052210118e-31f;     // 2^-100
constexpr float SUM_HI = 1.0000152587890625f;       // 1 + 2^-16
constexpr float T_HI = 1.000003814697265625f;       // 1 + 2^-18
constexpr float DET_LO = 2.350988701644575e-38f;    // 2^-125
constexpr float DET_HI = 4.253529586511731e+37f;    // 2^125

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ti;
};

struct Best {
  float t, beta, gamma, thr;  // thr: the rejection's bound on t (header)
  int idx;
};

// One ray x item test: the determinant and beta's numerator first, then
// gamma's, then t's, each rejected as soon as its approximate quotient
// allows (the header's argument); the survivors divided and tested as the
// TPU kernel does.  Rays of a warp are neighbours, so they mostly leave at
// the same stage.
template <bool kMotion>
__device__ __forceinline__ void test_item(const float4& a, const float4& b,
                                          const float4& c, int k,
                                          const Ray& R, Best& B) {
  // v0x v0y v0z e1x | e1y e1z e2x e2y | e2z mx my mz
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  float px = R.ox, py = R.oy, pz = R.oz;
  if (kMotion) {
    px = R.ox + c.y * R.ti;
    py = R.oy + c.z * R.ti;
    pz = R.oz + c.w * R.ti;
  }
  const float bx = a.x - px, by = a.y - py, bz = a.z - pz;
  // det[e1 | e2 | d] (tri_intersect.py:70-74) and beta's numerator
  const float m0 = e2y * R.dz - R.dy * e2z;
  const float m1 = e2x * R.dz - R.dx * e2z;
  const float m2 = e2x * R.dy - R.dx * e2y;
  const float det = e1x * m0 - e1y * m1 + e1z * m2;
  if (det == 0.0f) return;
  const float b_num = bx * m0 - by * m1 + bz * m2;
  const float ad = fabsf(det);
  const bool approx = ad >= DET_LO && ad <= DET_HI;
  const float rc = approx ? rcp_approx(det) : 0.0f;
  const float ab = b_num * rc;
  if (approx && ab < -SLACK) return;
  const float n0 = by * R.dz - R.dy * bz;
  const float n1 = bx * R.dz - R.dx * bz;
  const float n2 = bx * R.dy - R.dx * by;
  const float g_num = e1x * n0 - e1y * n1 + e1z * n2;
  const float ag = g_num * rc;
  if (approx && (ag < -SLACK || ab + ag > SUM_HI)) return;
  const float q0 = e2y * bz - by * e2z;
  const float q1 = e2x * bz - bx * e2z;
  const float q2 = e2x * by - bx * e2y;
  const float t_num = e1x * q0 - e1y * q1 + e1z * q2;
  const float at = t_num * rc;
  if (approx && (at < -SLACK || at > B.thr)) return;
  const float safe = det;  // != 0 here: the TPU kernel's guard is a no-op
  const float beta = b_num / safe;
  const float gamma = g_num / safe;
  const float t = t_num / safe;
  if (beta >= 0.0f && gamma >= 0.0f && beta + gamma <= 1.0f && t > 0.0f &&
      t < B.t) {
    B.t = t; B.idx = k; B.beta = beta; B.gamma = gamma;
    B.thr = t * T_HI + SLACK;
  }
}

template <bool kMotion>
__global__ void __launch_bounds__(THREADS)
tri_intersect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float4* __restrict__ items,
                     const float* __restrict__ tau, int n, int w,
                     float* __restrict__ t_out, int* __restrict__ idx_out,
                     float* __restrict__ beta_out,
                     float* __restrict__ gamma_out) {
  __shared__ float4 tab[TILE * (COLS / 4)];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  Ray ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f};
  if (i < n)
    ray = Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
              d[3 * i + 2], kMotion ? tau[i] : 0.0f};
  Best best{BIG, 0.0f, 0.0f, BIG * T_HI + SLACK, -1};
  for (int base = 0; base < w; base += TILE) {
    const int m = min(TILE, w - base);
    __syncthreads();
    for (int q = threadIdx.x; q < m * (COLS / 4); q += THREADS)
      tab[q] = items[base * (COLS / 4) + q];
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4 a = tab[j * 4], b = tab[j * 4 + 1], c = tab[j * 4 + 2];
      test_item<kMotion>(a, b, c, base + j, ray, best);
    }
  }
  if (i < n) {
    t_out[i] = best.idx < 0 ? __int_as_float(0x7f800000) : best.t;
    idx_out[i] = best.idx;
    beta_out[i] = best.beta;
    gamma_out[i] = best.gamma;
  }
}

}  // namespace k3

// items: the (w, 16) table of ops/tri_intersect.py::item_table, 16-byte
// aligned; tau null: no motion (the table's motion columns unread).
// Returns cudaGetLastError() after the launch.
extern "C" int tri_intersect_launch(const float* o, const float* d,
                                    const float* items, const float* tau,
                                    int n, int w, float* t, int* idx,
                                    float* beta, float* gamma, void* stream) {
  if (n <= 0 || w < 0 || reinterpret_cast<size_t>(items) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + k3::THREADS - 1) / k3::THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* tab = reinterpret_cast<const float4*>(items);
  if (tau != nullptr)
    k3::tri_intersect_kernel<true><<<blocks, k3::THREADS, 0, st>>>(
        o, d, tab, tau, n, w, t, idx, beta, gamma);
  else
    k3::tri_intersect_kernel<false><<<blocks, k3::THREADS, 0, st>>>(
        o, d, tab, tau, n, w, t, idx, beta, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tri_intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
