// bigtex_gather.cu — the big-texture gather probe (K4) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel tools/probe_bigtex.py::_kernel (lines 31-69,
// launched by run through pl.pallas_call at line 84): per lane, the sum of
// `taps` entries of a flat f32 table gathered by index,
//
//     out[lane] = tab[idx[0][lane]] + tab[idx[1][lane]] + ...
//
// added left to right in tap order, as the TPU kernel's
// functools.reduce(jnp.add, ...) at line 68 adds its per-tap sums (each of
// which is its one served tap added into a zero).  The plain version beside
// it is ops/bigtex_gather.py::gather_sum_ref.
//
// Design.  The TPU cannot gather from HBM lane by lane, so its kernel takes
// the lowest unserved row of a block, copies a window of `wn` table rows into
// VMEM by DMA, serves the taps that fall in it, and loops until every lane is
// served.  A GPU thread loads any address, so none of that schedule is
// carried over (no window, no served masks, no loop until served): one thread
// per lane, 256 a block, loads its `taps` indices (tap-major, so a warp's
// loads of one tap are coalesced), reads each table entry through the
// read-only cache (__ldg) and adds them in tap order.  An index outside the
// table, which the TPU kernel would never serve (its loop would not end),
// gives NaN here and reads nothing.
//
// Bound.  Bytes: each index read once (4 B a tap and lane), each output
// written once (4 B a lane), and each 32-byte sector of the table that the
// indices touch read once; one addition a tap is far below the FP32 rate.
// Coherent indices (a block's lanes within a few rows) share sectors through
// L1 and L2; scattered ones pay a sector a tap.

#include <cuda_runtime.h>

namespace k4 {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bigtex_gather_kernel(const int* __restrict__ idx, const float* __restrict__ tab,
                     long long n_lanes, int taps, long long n_tab,
                     float* __restrict__ out) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (lane >= n_lanes) return;
  float acc = 0.0f;
  bool inside = true;
  for (int k = 0; k < taps; ++k) {
    const long long i = idx[k * n_lanes + lane];
    if (i < 0 || i >= n_tab) {
      inside = false;
      continue;
    }
    const float v = __ldg(tab + i);
    acc = k == 0 ? v : acc + v;
  }
  out[lane] = inside ? acc : __int_as_float(0x7fc00000);
}

}  // namespace k4

// idx (taps, n_lanes) int32, tab n_tab f32, out n_lanes f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int bigtex_gather_launch(const int* idx, const float* tab,
                                    long long n_lanes, int taps,
                                    long long n_tab, float* out,
                                    void* stream) {
  if (n_lanes <= 0 || taps <= 0 || n_tab <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_lanes + k4::THREADS - 1) / k4::THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k4::bigtex_gather_kernel<<<static_cast<unsigned>(blocks), k4::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      idx, tab, n_lanes, taps, n_tab, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bigtex_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
