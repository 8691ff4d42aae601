// philox_draws.cu — the wavefront draw source's Philox uniforms for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  It was added for ops/rng.py::PhiloxDraws on a
// CUDA device, whose torch twin (rng.philox4x32 on int64 tensors, the
// 32-bit products split into 16-bit limbs) issues about 225 elementwise
// launches for one call: the progressive preview's jitter
// (render/progressive.py) paid them on the host every pass while the card
// sat idle.  Here one launch computes the same words with mw::philox, the
// Philox4x32-10 that K1 and K2 draw with (csrc/mega_common.cuh).
//
// Each thread computes one Philox block of one ray: counter (ray0 + i,
// c1, c2, block) with c1 = iteration + 1 and c2 = site * 256 + light, key
// (k0, k1) = the low 32 bits of (seed, sample); word j of block b is draw
// 4 b + j of the ray, (x >> 9) * 2^-23.  The first n draws of each ray go
// to row i of a contiguous (r, n) f32 output.  With kScale each uniform is
// mapped to [lo, hi) as ops/rng.py::_scale maps it, in its order and in
// f32: u * (hi - lo), then + lo, then the max with lo (-fmad=false keeps the
// product and the sum apart).
//
// Bound: bytes.  The kernel reads nothing and writes 4 r n bytes; the 20
// 32-bit multiplies of a block are a few hundred integer operations, far
// below the card's rate for the bytes written.  At the preview's 640,000
// rays x 2 draws that is 5.1 MB, 1.5 us at 3.35 TB/s.  Neighbouring threads
// write neighbouring draws, so the stores coalesce.

#include "mega_common.cuh"

namespace pd {

constexpr int THREADS = 256;

template <bool kScale>
__global__ void __launch_bounds__(THREADS)
philox_draws_kernel(float* __restrict__ out, unsigned long long n_items,
                    int n, int n_blocks, unsigned ray0, unsigned c1,
                    unsigned c2, unsigned k0, unsigned k1, float span,
                    float lo) {
  const unsigned long long t =
      static_cast<unsigned long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n_items) return;
  const unsigned long long i = t / n_blocks;
  const int b = static_cast<int>(t - i * n_blocks);
  const uint4 w = mw::philox(
      make_uint4(ray0 + static_cast<unsigned>(i), c1, c2,
                 static_cast<unsigned>(b)),
      k0, k1);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  float* row = out + i * n + 4 * b;
  const int m = min(4, n - 4 * b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < m) {
      float u = static_cast<float>(words[j] >> 9) * (1.0f / 8388608.0f);
      if (kScale) u = fmaxf(u * span + lo, lo);
      row[j] = u;
    }
  }
}

}  // namespace pd

// out: r x n f32, contiguous.  ray0 + r must not pass 2^32 (the ray's
// counter word); scale 0 leaves the uniforms in [0, 1), else they are
// mapped by span = hi - lo and lo.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int philox_draws_launch(float* out, long long r, int n,
                                   unsigned ray0, unsigned c1, unsigned c2,
                                   unsigned k0, unsigned k1, int scale,
                                   float span, float lo, void* stream) {
  if (r <= 0 || n < 1 || static_cast<unsigned long long>(ray0) + r > (1ULL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (n + 3) / 4;
  const unsigned long long n_items =
      static_cast<unsigned long long>(r) * n_blocks;
  const unsigned long long grid = (n_items + pd::THREADS - 1) / pd::THREADS;
  if (grid > 0x7FFFFFFFULL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale)
    pd::philox_draws_kernel<true><<<static_cast<unsigned>(grid), pd::THREADS,
                                    0, st>>>(out, n_items, n, n_blocks, ray0,
                                             c1, c2, k0, k1, span, lo);
  else
    pd::philox_draws_kernel<false><<<static_cast<unsigned>(grid), pd::THREADS,
                                     0, st>>>(out, n_items, n, n_blocks, ray0,
                                              c1, c2, k0, k1, span, lo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* philox_draws_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
