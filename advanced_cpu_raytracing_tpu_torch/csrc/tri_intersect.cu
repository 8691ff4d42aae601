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
// Design.  One thread per ray, 256 per block, the grid over the rays.  The
// TPU kernel holds the whole table in VMEM and folds one item per loop step
// into (8,128) ray planes; here the table is staged through shared memory
// in tiles of 256 items (12 floats each: v0, e1 = v0 - v1, e2 = v0 - v2 and
// the motion row; 12 KB), each loaded by one thread of the block, and every
// thread folds the tile's items in ascending order into a running minimum
// in registers.  All threads of a warp read the same item at once: a
// shared-memory broadcast.  The TPU's padding of the rays to 1,024 and of
// the table to 8 items is not needed.  With a motion table (per item) and a
// time per ray, the origin of each test is o + motion * time, in the order
// of the JAX jnp route (ops/traverse.py:123-125), which the TPU kernel
// cannot take.
//
// Bound.  FP32 work on the CUDA cores: 61 operations per ray x item test
// (the 3 differences of b, 27 products and differences of the three cross
// terms, 15 of the three determinants, 3 IEEE divisions, beta + gamma and
// 7 comparisons; 6 more with motion), against 40 bytes of rays in and
// results out per ray (52 with motion): operations bound it.  Built with
// -fmad=false and IEEE division, it computes the plain version's
// arithmetic in its order, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace k3 {

constexpr int THREADS = 256;
constexpr int TILE = 256;  // items per shared-memory tile
constexpr int COLS = 12;   // v0 0:3, e1 3:6, e2 6:9, motion 9:12
constexpr float BIG = 3.0e38f;  // the TPU kernel's "no hit" (_INF)

__global__ void __launch_bounds__(THREADS)
tri_intersect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ v0, const float* __restrict__ v1,
                     const float* __restrict__ v2,
                     const float* __restrict__ motion,
                     const float* __restrict__ tau, int n, int w,
                     float* __restrict__ t_out, int* __restrict__ idx_out,
                     float* __restrict__ beta_out,
                     float* __restrict__ gamma_out) {
  __shared__ float tab[TILE * COLS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float ti = 0.0f;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    if (motion != nullptr) ti = tau[i];
  }
  float t_best = BIG, b_best = 0.0f, g_best = 0.0f;
  int i_best = -1;
  for (int base = 0; base < w; base += TILE) {
    __syncthreads();
    const int k = base + threadIdx.x;
    if (threadIdx.x < TILE && k < w) {
      float* row = tab + threadIdx.x * COLS;
      const float ax = v0[3 * k], ay = v0[3 * k + 1], az = v0[3 * k + 2];
      row[0] = ax; row[1] = ay; row[2] = az;
      row[3] = ax - v1[3 * k]; row[4] = ay - v1[3 * k + 1];
      row[5] = az - v1[3 * k + 2];
      row[6] = ax - v2[3 * k]; row[7] = ay - v2[3 * k + 1];
      row[8] = az - v2[3 * k + 2];
      if (motion != nullptr) {
        row[9] = motion[3 * k]; row[10] = motion[3 * k + 1];
        row[11] = motion[3 * k + 2];
      }
    }
    __syncthreads();
    const int m = min(TILE, w - base);
    for (int j = 0; j < m; ++j) {
      const float* row = tab + j * COLS;
      float px = ox, py = oy, pz = oz;
      if (motion != nullptr) {
        px = ox + row[9] * ti; py = oy + row[10] * ti; pz = oz + row[11] * ti;
      }
      const float e1x = row[3], e1y = row[4], e1z = row[5];
      const float e2x = row[6], e2y = row[7], e2z = row[8];
      const float bx = row[0] - px, by = row[1] - py, bz = row[2] - pz;
      // det[e1 | e2 | d] (tri_intersect.py:70-74)
      const float m0 = e2y * dz - dy * e2z;
      const float m1 = e2x * dz - dx * e2z;
      const float m2 = e2x * dy - dx * e2y;
      const float det = e1x * m0 - e1y * m1 + e1z * m2;
      const float safe = det == 0.0f ? 1.0f : det;
      const float beta = (bx * m0 - by * m1 + bz * m2) / safe;
      const float n0 = by * dz - dy * bz;
      const float n1 = bx * dz - dx * bz;
      const float n2 = bx * dy - dx * by;
      const float gamma = (e1x * n0 - e1y * n1 + e1z * n2) / safe;
      const float q0 = e2y * bz - by * e2z;
      const float q1 = e2x * bz - bx * e2z;
      const float q2 = e2x * by - bx * e2y;
      const float t = (e1x * q0 - e1y * q1 + e1z * q2) / safe;
      const bool valid = det != 0.0f && beta >= 0.0f && gamma >= 0.0f &&
                         beta + gamma <= 1.0f && t > 0.0f;
      if (valid && t < t_best) {
        t_best = t; i_best = base + j; b_best = beta; g_best = gamma;
      }
    }
  }
  if (live) {
    t_out[i] = i_best < 0 ? __int_as_float(0x7f800000) : t_best;
    idx_out[i] = i_best;
    beta_out[i] = b_best;
    gamma_out[i] = g_best;
  }
}

}  // namespace k3

// motion and tau null: no motion.  Returns cudaGetLastError() after the
// launch.
extern "C" int tri_intersect_launch(const float* o, const float* d,
                                    const float* v0, const float* v1,
                                    const float* v2, const float* motion,
                                    const float* tau, int n, int w, float* t,
                                    int* idx, float* beta, float* gamma,
                                    void* stream) {
  if (n <= 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + k3::THREADS - 1) / k3::THREADS;
  k3::tri_intersect_kernel<<<blocks, k3::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      o, d, v0, v1, v2, motion, tau, n, w, t, idx, beta, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tri_intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
