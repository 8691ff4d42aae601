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
// it is ops/bigtex_gather.py::gather_sum_ref; the kernel equals it bit for
// bit.  An index outside the table, which the TPU kernel would never serve
// (its loop would not end), makes its lane NaN and reads nothing.
//
// Bound.  Bytes: each index read once (4 B a tap and lane), each output
// written once (4 B a lane), and each 32-byte sector of the table that the
// indices touch read once; one addition a tap is far below the FP32 rate.
// A thread that loads one table entry by address moves a whole 32-byte
// sector from L2 to its SM: at the probe's frame size (10,240,000 lanes, 4
// taps, 64-row windows of a 201 MB table) that is 1,311 MB of sectors for
// 160 MB of distinct ones, in random order.
//
// Design.  The TPU kernel copies a window of `wn` table rows into VMEM by
// DMA, serves the taps that fall in it and loops until every lane is
// served.  Here the same idea pays for the card's reason, without the loop:
// a block serves one group of GROUP = 1,024 consecutive lanes (in the
// probe's (taps, blocks, 8, 128) layout, one TPU block: the lanes that
// share a base row), 4 lanes a thread, the indices loaded 16 bytes a thread
// where the layout allows.  A block reduction (warp min/max, then shared
// memory) finds the group's lowest and highest in-range index.  If that
// span, rounded out to 16 bytes, is at most `window_bytes`, one thread
// copies it into shared memory by one TMA bulk copy
// (cp.async.bulk ... mbarrier::complete_tx) and the block waits on the
// mbarrier: one request of 32 KB in place of ~4,096 sector requests, each
// table byte of the window moved from L2 once.  Every tap then reads shared
// memory.  A group whose span is wider (or that has no in-range index)
// reads each tap through the read-only cache (__ldg) as a direct group;
// window_bytes = 0 sends every group direct.  Indices are read with
// __ldcs and the output written with __stcs (evict first), so the 205 MB of
// streams at the frame size do not push table lines out of the 50 MB L2.
// Where the table is larger than L2 the wrapper also asks for the groups in
// window order (bigtex_keys_kernel and bigtex_order_kernel below, ~7 us at
// 10,000 groups): two groups whose windows overlap are otherwise thousands
// of blocks apart, and each reads the shared rows from HBM (the windows sum
// to 328 MB at the frame size, the touched sectors to 160 MB).
// The rounding out to 16 bytes may copy up to 12 bytes on either side of
// the touched entries, inside the 16-byte-aligned chunks that hold them (so
// inside the table's allocation); no lane reads them.  The wrapper sends a
// table that is not 16-byte aligned, and more than MAX_TAPS taps (whose
// indices a thread does not hold), direct.  Measured on an H100 (PERF.md
// §6, tools/k4_design.py): a persistent grid with two window
// buffers, and plain loads and stores for the streams, were slower.

#include <cuda_runtime.h>

#include <climits>

namespace k4 {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;                  // lanes a thread
constexpr int GROUP = THREADS * PER_THREAD;    // lanes a block: 1,024
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TAPS = 4;                    // taps held in registers
constexpr int ORDER_THREADS = 1024;
constexpr int BUCKETS = 2 * ORDER_THREADS;
constexpr int KEYS = 8;  // keys a thread of the order kernel loads at once
// groups whose order the order kernel stages in shared memory (128 KB)
constexpr int ORDER_STAGED = 32768;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a thread's 4 lanes of tap k: 16 bytes at once where the plane allows
__device__ __forceinline__ void load_tap(const int* __restrict__ p,
                                         bool full, bool vec, int n_valid,
                                         int (&v)[PER_THREAD]) {
  if (full && vec) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      v[j] = j < n_valid ? __ldcs(p + j) : -1;
  }
}

// The order in which the gather's blocks take the groups: by the bucket
// (table entry >> shift, at most BUCKETS of them) of each group's first
// index, a stand-in for its window's start, so that groups whose windows
// overlap run at about the same time and share their rows in L2.  Two small
// kernels: bigtex_keys_kernel reads one index a group across the card (one
// SM alone cannot keep enough of those scattered loads in flight) and
// writes its bucket; bigtex_order_kernel, one block, makes a histogram of
// the buckets in shared memory, scans it and places each group after the
// groups of lower buckets (within a bucket in any order), in shared memory
// where the order fits (up to ORDER_STAGED groups), so that it is written
// out coalesced.
__global__ void bigtex_keys_kernel(const int* __restrict__ idx,
                                   long long n_groups, long long n_tab,
                                   int shift, int* __restrict__ keys) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (g >= n_groups) return;
  const long long i = __ldg(idx + g * GROUP);
  keys[g] =
      static_cast<int>((i < 0 ? 0 : i >= n_tab ? n_tab - 1 : i) >> shift);
}

__global__ void __launch_bounds__(ORDER_THREADS)
bigtex_order_kernel(const int* __restrict__ keys, long long n_groups,
                    int* __restrict__ order) {
  extern __shared__ int staged[];  // the order, when it fits
  __shared__ int start[BUCKETS];
  __shared__ int warp_sum[ORDER_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // each pass loads KEYS keys a thread before it uses any
  auto pass = [&](auto&& use) {
    for (long long g0 = t; g0 < n_groups; g0 += KEYS * ORDER_THREADS) {
      int b[KEYS];
#pragma unroll
      for (int u = 0; u < KEYS; ++u) {
        const long long g = g0 + u * ORDER_THREADS;
        b[u] = g < n_groups ? keys[g] : -1;
      }
#pragma unroll
      for (int u = 0; u < KEYS; ++u)
        if (b[u] >= 0) use(g0 + u * ORDER_THREADS, b[u]);
    }
  };
  for (int b = t; b < BUCKETS; b += ORDER_THREADS) start[b] = 0;
  __syncthreads();
  pass([&](long long, int b) { atomicAdd(&start[b], 1); });
  __syncthreads();
  // each thread scans its BUCKETS / ORDER_THREADS = 2 buckets
  const int c0 = start[2 * t], c1 = start[2 * t + 1];
  int s = c0 + c1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += y;
  }
  if (lane == 31) warp_sum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  const int first = s - c0 - c1 + (warp > 0 ? warp_sum[warp - 1] : 0);
  start[2 * t] = first;
  start[2 * t + 1] = first + c0;
  __syncthreads();
  if (n_groups <= ORDER_STAGED) {
    // placed in shared memory, then written out coalesced
    pass([&](long long g, int b) {
      staged[atomicAdd(&start[b], 1)] = static_cast<int>(g);
    });
    __syncthreads();
    for (int g = t; g < n_groups; g += ORDER_THREADS) order[g] = staged[g];
  } else {
    pass([&](long long g, int b) {
      order[atomicAdd(&start[b], 1)] = static_cast<int>(g);
    });
  }
}

// idx (taps, n_lanes) int32 tap-major; vec: the planes and out allow
// 16-byte accesses; order (or null): the group of each block; paths (or
// null): groups served through a window and directly, added into.
__global__ void __launch_bounds__(THREADS)
bigtex_gather_kernel(const int* __restrict__ idx,
                     const float* __restrict__ tab, long long n_lanes,
                     int taps, long long n_tab, int window_bytes, bool vec,
                     const int* __restrict__ order, float* __restrict__ out,
                     int* __restrict__ paths) {
  extern __shared__ __align__(128) float win[];
  __shared__ __align__(8) unsigned long long bar;
  __shared__ int s_lo[WARPS], s_hi[WARPS];
  __shared__ long long s_w0;

  const int t = threadIdx.x;
  const long long lane0 =
      static_cast<long long>(order ? order[blockIdx.x] : blockIdx.x) * GROUP +
      PER_THREAD * t;
  const long long left = n_lanes - lane0;
  const int n_valid = left >= PER_THREAD ? PER_THREAD
                      : left > 0         ? static_cast<int>(left)
                                         : 0;
  const bool full = n_valid == PER_THREAD;

  int v[MAX_TAPS][PER_THREAD];
#pragma unroll
  for (int k = 0; k < MAX_TAPS; ++k)
    if (k < taps)
      load_tap(idx + k * n_lanes + lane0, full, vec, n_valid, v[k]);

  // the window: the group's in-range span, or -1 (direct)
  long long w0 = -1;
  if (window_bytes > 0) {
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int k = 0; k < MAX_TAPS; ++k)
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        if (k < taps && v[k][j] >= 0 && v[k][j] < n_tab) {
          lo = min(lo, v[k][j]);
          hi = max(hi, v[k][j]);
        }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((t & 31) == 0) {
      s_lo[t >> 5] = lo;
      s_hi[t >> 5] = hi;
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        lo = min(lo, s_lo[w]);
        hi = max(hi, s_hi[w]);
      }
      long long first = -1;
      if (hi >= 0) {
        const long long a = lo & ~3LL, b = (hi + 4LL) & ~3LL;
        const long long bytes = 4 * (b - a);
        if (bytes <= window_bytes) {
          first = a;
          const unsigned mb = smem_addr(&bar);
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
              ::"r"(mb), "r"(static_cast<unsigned>(bytes))
              : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global"
              ".mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
              ::"r"(smem_addr(win)), "l"(tab + a),
              "r"(static_cast<unsigned>(bytes)), "r"(mb)
              : "memory");
        }
      }
      s_w0 = first;
      if (paths) atomicAdd(paths + (first >= 0 ? 0 : 1), 1);
    }
    __syncthreads();
    w0 = s_w0;
    if (w0 >= 0) {
      unsigned done = 0;
      while (!done)
        asm volatile(
            "{ .reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            "selp.u32 %0, 1, 0, p; }"
            : "=r"(done)
            : "r"(smem_addr(&bar))
            : "memory");
    }
  } else if (paths && t == 0) {
    atomicAdd(paths + 1, 1);
  }

  // the sums, in tap order
  float acc[PER_THREAD];
  bool inside[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    acc[j] = 0.0f;
    inside[j] = true;
  }
  auto add_tap = [&](int k, const int (&u)[PER_THREAD]) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = u[j];
      if (i < 0 || i >= n_tab) {
        inside[j] = false;
        continue;
      }
      const float x = w0 >= 0 ? win[i - w0] : __ldg(tab + i);
      acc[j] = k == 0 ? x : acc[j] + x;
    }
  };
#pragma unroll
  for (int k = 0; k < MAX_TAPS; ++k)
    if (k < taps) add_tap(k, v[k]);
  for (int k = MAX_TAPS; k < taps; ++k) {
    int u[PER_THREAD];
    load_tap(idx + k * n_lanes + lane0, full, vec, n_valid, u);
    add_tap(k, u);
  }

  float r[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    r[j] = inside[j] ? acc[j] : __int_as_float(0x7fc00000);
  if (full && vec) {
    __stcs(reinterpret_cast<float4*>(out + lane0),
           make_float4(r[0], r[1], r[2], r[3]));
  } else {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (j < n_valid) __stcs(out + lane0 + j, r[j]);
  }
}

}  // namespace k4

namespace {

// each kernel's dynamic shared-memory limit as set on each device (0: not
// set; the default allows 48 KB less the kernel's static shared memory)
int gather_limit[64], order_limit[64];

template <typename Kernel>
cudaError_t allow_shared(Kernel* kernel, int (&limit)[64], int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= limit[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess)
    limit[dev] = bytes;
  else
    cudaGetLastError();  // a refused limit is returned, not left for the next
                         // launch's check
  return e;
}

}  // namespace

// idx (taps, n_lanes) int32, tab n_tab f32, out n_lanes f32; window_bytes a
// multiple of 16 (0: every group direct); order null (the groups in grid
// order) or an int32 scratch of two entries a group, the keys and the order
// that the order kernels write first; paths null or int32[2].  Returns the
// CUDA error of the launches (or of raising the kernel's shared-memory
// limit), 0 if none.
extern "C" int bigtex_gather_launch(const int* idx, const float* tab,
                                    long long n_lanes, int taps,
                                    long long n_tab, int window_bytes,
                                    int* order, float* out, int* paths,
                                    void* stream) {
  if (n_lanes <= 0 || taps <= 0 || n_tab <= 0 || window_bytes < 0 ||
      window_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_lanes + k4::GROUP - 1) / k4::GROUP;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (taps > k4::MAX_TAPS) window_bytes = 0;
  cudaError_t e =
      allow_shared(k4::bigtex_gather_kernel, gather_limit, window_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = n_lanes % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(idx) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(out) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (order) {
    int shift = 0;
    while (((n_tab - 1) >> shift) >= k4::BUCKETS) ++shift;
    int* keys = order;
    order += blocks;
    k4::bigtex_keys_kernel<<<static_cast<unsigned>((blocks + 255) / 256), 256,
                             0, st>>>(idx, blocks, n_tab, shift, keys);
    const int staged =
        blocks <= k4::ORDER_STAGED ? 4 * static_cast<int>(blocks) : 0;
    e = allow_shared(k4::bigtex_order_kernel, order_limit, staged);
    if (e != cudaSuccess) return static_cast<int>(e);
    k4::bigtex_order_kernel<<<1, k4::ORDER_THREADS, staged, st>>>(keys, blocks,
                                                                order);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k4::bigtex_gather_kernel<<<static_cast<unsigned>(blocks), k4::THREADS,
                             window_bytes, st>>>(
      idx, tab, n_lanes, taps, n_tab, window_bytes, vec, order, out, paths);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's registers, static shared memory and resident blocks an SM
// at `window_bytes` of dynamic shared memory, into info[3].
extern "C" int bigtex_gather_info(int window_bytes, int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, k4::bigtex_gather_kernel);
  if (e == cudaSuccess)
    e = allow_shared(k4::bigtex_gather_kernel, gather_limit, window_bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, k4::bigtex_gather_kernel, k4::THREADS, window_bytes);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.sharedSizeBytes);
  info[2] = blocks;
  return static_cast<int>(e);
}

extern "C" const char* bigtex_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
