"""Design measurements of K4, the big-texture probe's gather-sum
(``csrc/bigtex_gather.cu``).

    python -m advanced_cpu_raytracing_tpu_torch.tools.k4_design \\
        [--reps 32] [--parent-src PATH]
    [PYTHONPATH=CHECKOUT] python \\
        advanced_cpu_raytracing_tpu_torch/tools/k4_design.py --host

On the card (it raises without one), for the probe's frame-size
configuration (``tools/probe_bigtex.py::FRAME``) and the JAX probe's sweep
over spread 8, 64 and 256, each design's device time per launch
(torch.profiler over ``reps`` launches back to back) and, at the frame
size, its time with L2 flushed (a 256 MB write before each launch; CUDA
events, the median of ``reps``), taken in turns (the list, then the list
reversed):

- ``direct``: the kernel as it is, ``window_bytes`` = 0 (every group reads
  its taps through ``__ldg``);
- ``window``: (a), the kernel as it is at ``WINDOW_BYTES``, the groups in
  grid order;
- ``window_plain_streams``: (a) with the index planes read by ``__ldg`` and
  the output stored plainly, in place of ``__ldcs`` / ``__stcs``;
- ``persistent``: (b), a grid of as many blocks as fit at once, each
  walking groups ``blockIdx.x + i * gridDim.x`` with two window buffers:
  the next group's indices and bulk copy are started before the current
  group is served;
- ``ordered``: (c), (a) with the groups taken in window order (the order
  kernel first), as ``gather_sum`` launches it where the table exceeds L2,
  and ``ordered_<bytes>`` the same at other window sizes;
  ``direct_ordered`` every group direct in that order;
  ``ordered_exact`` the groups sorted by their first index
  (``torch.argsort``, outside the timed launch) and no order kernel;
- ``parent`` (with ``--parent-src``): an earlier commit's
  ``csrc/bigtex_gather.cu`` with its one-lane-a-thread interface.

``--host``: the launch path of the package it imports, for each of the
probe's configurations: µs a ``gather_sum`` call over 1,000 calls without
a synchronise, against the CUDA events around them, beside
``torch.empty`` of the output alone and ``embedding_bag``.  Run by path
with an earlier checkout first on ``PYTHONPATH``, it times that one's.

The variants that change the source are built from a copy of
``csrc/bigtex_gather.cu`` edited here (``EDITS``), under
``build/k4_design/``, each with the same C interface.  Every design's output
is held to ``gather_sum_ref`` bit for bit, NaN lanes alike.  Each line
names the card and its power limit, and each design its registers, static
shared memory and resident blocks an SM.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from advanced_cpu_raytracing_tpu_torch.ops import _build
from advanced_cpu_raytracing_tpu_torch.ops import bigtex_gather as k4
from advanced_cpu_raytracing_tpu_torch.tools import probe_bigtex

OUT = _build.BUILD_DIR.parent / "k4_design"

KERNEL_HEAD = """__global__ void __launch_bounds__(THREADS)
bigtex_gather_kernel("""
KERNEL_END = "}  // namespace k4"
# (b): the kernel in a persistent form with two window buffers (taps <= 4)
PERSISTENT = r"""__global__ void __launch_bounds__(THREADS)
bigtex_gather_kernel(const int* __restrict__ idx,
                     const float* __restrict__ tab, long long n_lanes,
                     int taps, long long n_tab, int window_bytes, bool vec,
                     const int* __restrict__ order, float* __restrict__ out,
                     int* __restrict__ paths) {
  extern __shared__ __align__(128) float win[];
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ int s_lo[WARPS], s_hi[WARPS];
  __shared__ long long s_w0[2];
  const int t = threadIdx.x;
  const long long n_groups = (n_lanes + GROUP - 1) / GROUP;
  const int wf = window_bytes / 4;
  if (t == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_addr(&bar[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int cur[MAX_TAPS][PER_THREAD], nxt[MAX_TAPS][PER_THREAD];
  unsigned phase = 0;
  auto lanes = [&](long long g, long long& lane0, int& n_valid) {
    lane0 = g * GROUP + PER_THREAD * t;
    const long long left = n_lanes - lane0;
    n_valid = left >= PER_THREAD ? PER_THREAD
              : left > 0         ? static_cast<int>(left)
                                 : 0;
  };
  // group g's indices into v and its window's bulk copy into buffer b
  auto fetch = [&](long long g, int (&v)[MAX_TAPS][PER_THREAD], int b) {
    long long lane0;
    int n_valid;
    lanes(g, lane0, n_valid);
    const bool full = n_valid == PER_THREAD;
#pragma unroll
    for (int k = 0; k < MAX_TAPS; ++k)
      if (k < taps)
        load_tap(idx + k * n_lanes + lane0, full, vec, n_valid, v[k]);
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
      for (int w = 1; w < WARPS; ++w) {
        lo = min(lo, s_lo[w]);
        hi = max(hi, s_hi[w]);
      }
      long long first = -1;
      if (hi >= 0) {
        const long long a = lo & ~3LL, e = (hi + 4LL) & ~3LL;
        const long long bytes = 4 * (e - a);
        if (bytes <= window_bytes) {
          first = a;
          const unsigned mb = smem_addr(&bar[b]);
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
              ::"r"(mb), "r"(static_cast<unsigned>(bytes)) : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global"
              ".mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
              ::"r"(smem_addr(win + b * wf)), "l"(tab + a),
              "r"(static_cast<unsigned>(bytes)), "r"(mb) : "memory");
        }
      }
      s_w0[b] = first;
      if (paths) atomicAdd(paths + (first >= 0 ? 0 : 1), 1);
    }
    __syncthreads();
  };
  // group g's sums from buffer b (or directly)
  auto serve = [&](long long g, const int (&v)[MAX_TAPS][PER_THREAD],
                   int b) {
    long long lane0;
    int n_valid;
    lanes(g, lane0, n_valid);
    const long long w0 = s_w0[b];
    if (w0 >= 0) {
      const unsigned par = (phase >> b) & 1u;
      unsigned done = 0;
      while (!done)
        asm volatile(
            "{ .reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p; }"
            : "=r"(done) : "r"(smem_addr(&bar[b])), "r"(par) : "memory");
      phase ^= 1u << b;
    }
    const float* w = win + b * wf;
    float acc[PER_THREAD], r[PER_THREAD];
    bool inside[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      acc[j] = 0.0f;
      inside[j] = true;
    }
#pragma unroll
    for (int k = 0; k < MAX_TAPS; ++k) {
      if (k >= taps) continue;
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int i = v[k][j];
        if (i < 0 || i >= n_tab) {
          inside[j] = false;
          continue;
        }
        const float x = w0 >= 0 ? w[i - w0] : __ldg(tab + i);
        acc[j] = k == 0 ? x : acc[j] + x;
      }
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      r[j] = inside[j] ? acc[j] : __int_as_float(0x7fc00000);
    if (n_valid == PER_THREAD && vec) {
      __stcs(reinterpret_cast<float4*>(out + lane0),
             make_float4(r[0], r[1], r[2], r[3]));
    } else {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        if (j < n_valid) __stcs(out + lane0 + j, r[j]);
    }
  };
  long long g = blockIdx.x;
  int b = 0;
  fetch(g, cur, 0);
  while (true) {
    const long long gn = g + gridDim.x;
    if (gn < n_groups) fetch(gn, nxt, b ^ 1);
    serve(g, cur, b);
    if (gn >= n_groups) break;
#pragma unroll
    for (int k = 0; k < MAX_TAPS; ++k)
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) cur[k][j] = nxt[k][j];
    g = gn;
    b ^= 1;
  }
}

"""
# the design's source edits: (old text, new text); "persistent" also
# replaces the kernel (PERSISTENT)
EDITS = {
    "window_plain_streams": [
        ("const int4 q = __ldcs(reinterpret_cast<const int4*>(p));",
         "const int4 q = __ldg(reinterpret_cast<const int4*>(p));"),
        ("v[j] = j < n_valid ? __ldcs(p + j) : -1;",
         "v[j] = j < n_valid ? __ldg(p + j) : -1;"),
        ("__stcs(reinterpret_cast<float4*>(out + lane0),\n"
         "           make_float4(r[0], r[1], r[2], r[3]));",
         "*reinterpret_cast<float4*>(out + lane0) =\n"
         "           make_float4(r[0], r[1], r[2], r[3]);"),
        ("if (j < n_valid) __stcs(out + lane0 + j, r[j]);",
         "if (j < n_valid) out[lane0 + j] = r[j];")],
    # the order given, not computed: groups sorted by their first index
    "exact_order": [("  if (order) {\n    int shift = 0;",
                     "  if (false) {\n    int shift = 0;")],
    "persistent": [
        ("  k4::bigtex_gather_kernel<<<static_cast<unsigned>(blocks), "
         "k4::THREADS,\n                             window_bytes, st>>>(",
         "  int sms = 0, per_sm = 0;\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);\n"
         "  if (allow_shared(k4::bigtex_gather_kernel, gather_limit,\n"
         "                   2 * window_bytes) != cudaSuccess) return 1;\n"
         "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
         "      &per_sm, k4::bigtex_gather_kernel, k4::THREADS,\n"
         "      2 * window_bytes);\n"
         "  const long long grid = blocks < (long long)sms * per_sm ? blocks\n"
         "                         : (long long)sms * per_sm;\n"
         "  k4::bigtex_gather_kernel<<<static_cast<unsigned>(grid), "
         "k4::THREADS,\n"
         "                             2 * window_bytes, st>>>(")],
}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def variant_source(name: str) -> str:
    src = (_build.CSRC / f"{k4.LIBRARY}.cu").read_text()
    if name == "persistent":
        head = src.index(KERNEL_HEAD)
        src = src[:head] + PERSISTENT + src[src.index(KERNEL_END):]
    for old, new in EDITS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: edit target not in the source: "
                               f"{old!r}")
        src = src.replace(old, new)
    return src


def build_variants(names) -> dict:
    """One library per edited source, built side by side."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(name))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn, (restype, argtypes) in _build._SIGNATURES[k4.LIBRARY].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def parent_library(src: Path):
    """An earlier commit's K4 (one lane a thread; no window, no paths)."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "libparent.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.bigtex_gather_launch.restype = ctypes.c_int
    lib.bigtex_gather_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def launcher(lib, window_bytes, ordered=False, parent=False, preset=None):
    """fn(idx, tab) -> out through ``lib``'s launch, the groups in window
    order (the order kernel first) if ``ordered``, or in the order of the
    int32 tensor ``preset`` (for a source that does not compute it)."""
    def fn(idx, tab):
        out = torch.empty(idx.shape[1:], dtype=torch.float32,
                          device=idx.device)
        stream = torch.cuda.current_stream().cuda_stream
        head = (idx.data_ptr(), tab.data_ptr(), out.numel(), idx.shape[0],
                tab.numel())
        if parent:
            rc = lib.bigtex_gather_launch(*head, out.data_ptr(), stream)
        else:
            order = (torch.empty(2 * -(-out.numel() // k4.GROUP),
                                 dtype=torch.int32, device=idx.device)
                     if ordered else preset)
            rc = lib.bigtex_gather_launch(
                *head, window_bytes,
                None if order is None else order.data_ptr(), out.data_ptr(),
                None, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return fn


def info(lib, window_bytes) -> dict:
    out = (ctypes.c_int * 3)()
    if lib.bigtex_gather_info(window_bytes, out):
        raise RuntimeError("bigtex_gather_info failed")
    return {"registers": out[0], "static_shared_bytes": out[1],
            "blocks_per_sm": out[2]}


def device_ms(fn, reps: int) -> dict:
    """Device time per call of the K4 kernels (names holding "bigtex"),
    in all and by kernel (the two order kernels and the gather),
    torch.profiler over ``reps`` calls after one, each kernel averaged over
    the launches the profile caught."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile may catch no kernel: take it again
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages()
                if r.device_type == DeviceType.CUDA and "bigtex" in r.key
                and r.count]
        if rows:
            break
    else:
        raise AssertionError("the profiler caught no K4 kernel")
    return {"total": sum(r.device_time_total / r.count for r in rows) / 1e3,
            **{next(k for k in ("keys", "order", "gather") if k in r.key):
               r.device_time_total / r.count / 1e3 for r in rows}}


def host_path(reps: int = 1000) -> None:
    """``--host``: for each of the probe's configurations, µs a call of
    ``gather_sum`` over ``reps`` calls without a synchronise (the host's
    enqueue), the same calls' CUDA-event time, and the same for
    ``torch.empty`` of the output alone and for ``embedding_bag``."""
    dev = torch.device("cuda")
    card = card_line()

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return {"host_us": host, "events_us": a.elapsed_time(b) / reps * 1e3}

    for cfg, _ in probe_bigtex.CONFIGS:
        idx, tab = probe_bigtex.make_inputs(cfg["n_rows"], cfg["taps"],
                                            cfg["spread"], cfg["blocks"],
                                            seed=0, device=dev)
        bags = idx.reshape(idx.shape[0], -1).T.contiguous()
        column = tab.reshape(-1, 1)
        print(json.dumps({
            "config": cfg, "card": card, "package": str(Path(
                k4.__file__).resolve().parents[1]),
            "gather_sum": per_call(lambda: k4.gather_sum(idx, tab)),
            "empty": per_call(lambda: torch.empty(
                idx.shape[1:], dtype=torch.float32, device=dev)),
            "embedding_bag": per_call(
                lambda: torch.nn.functional.embedding_bag(bags, column,
                                                          mode="sum"))}),
              flush=True)
        del idx, tab, bags, column


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", action="store_true",
                    help="time the launch path of the package imported "
                         "(run by path with an earlier checkout first on "
                         "PYTHONPATH to time that one)")
    ap.add_argument("--reps", type=int, default=32)
    ap.add_argument("--parent-src", type=Path, default=None,
                    help="an earlier commit's csrc/bigtex_gather.cu, timed "
                         "beside the designs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_design: needs a CUDA card")
    if args.host:
        host_path()
        return 0
    dev = torch.device("cuda")
    card = card_line()
    shipped = k4._lib()
    libs = build_variants(EDITS)
    w = k4.WINDOW_BYTES
    designs = {
        "direct": (launcher(shipped, 0), info(shipped, 0)),
        "window": (launcher(shipped, w), info(shipped, w)),
        "window_plain_streams": (launcher(libs["window_plain_streams"], w),
                                 info(libs["window_plain_streams"], w)),
        "persistent": (launcher(libs["persistent"], w),
                       info(libs["persistent"], 2 * w)),
        "ordered": (launcher(shipped, w, ordered=True), info(shipped, w)),
        "direct_ordered": (launcher(shipped, 0, ordered=True),
                           info(shipped, 0))}
    for ww in (16384, 65536, 131072):
        designs[f"ordered_{ww}"] = (launcher(shipped, ww, ordered=True),
                                    info(shipped, ww))
    if args.parent_src is not None:
        designs["parent"] = (launcher(parent_library(args.parent_src), 0,
                                      parent=True), {})
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    reps = args.reps

    def flushed_ms(fn):
        fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for i, (a, b) in enumerate(ev):
            flush.fill_(float(i))
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in ev)[reps // 2]

    for cfg in (probe_bigtex.FRAME, *probe_bigtex.SWEEP):
        idx, tab = probe_bigtex.make_inputs(cfg["n_rows"], cfg["taps"],
                                            cfg["spread"], cfg["blocks"],
                                            seed=15, device=dev)
        ref = k4.gather_sum_ref(idx, tab)
        nan = torch.isnan(ref)
        frame = cfg is probe_bigtex.FRAME
        first = idx.reshape(idx.shape[0], -1)[0, ::k4.GROUP]
        designs["ordered_exact"] = (
            launcher(libs["exact_order"], w,
                     preset=torch.argsort(first).to(torch.int32)),
            info(libs["exact_order"], w))
        rows = {}
        # in turns: the list, then the list reversed
        for name in (*designs, *reversed(designs)):
            fn, _ = designs[name]
            torch.full_like(ref, 7.0)  # freed: the next output's poison
            got = fn(idx, tab)
            torch.cuda.synchronize()
            if not (torch.equal(torch.isnan(got), nan)
                    and torch.equal(got[~nan], ref[~nan])):
                raise AssertionError(f"{name} on {cfg}: differs from "
                                     f"gather_sum_ref")
            row = rows.setdefault(name, {"ms": [], "device_ms": []})
            if frame:
                row["ms"].append(flushed_ms(lambda: fn(idx, tab)))
            row["device_ms"].append(device_ms(lambda: fn(idx, tab), reps))
        tr = probe_bigtex.traffic(idx, tab.numel())
        plan = k4.gather_plan_ref(idx, tab.numel(), w)
        print(json.dumps({
            "config": cfg, "card": card,
            "timing": ("ms: one launch after a 256 MB write, CUDA events, "
                       f"median of {reps}; " if frame else "") +
                      f"device_ms: torch.profiler over {reps} launches back "
                      "to back",
            "bound_ms": tr["bound_ms"], "window_bytes": tr["window_bytes"],
            "window_groups": plan["counts"][0],
            "designs": {name: {**rows[name], **designs[name][1]}
                        for name in designs}}), flush=True)
        del idx, tab, ref, nan
    return 0


if __name__ == "__main__":
    sys.exit(main())
