"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. probe: the card's name and power limit, torch's CUDA version, nvcc;
  2. build the Whitted megakernel from csrc/mega_whitted.cu with nvcc;
  3. hold the kernel against its plain torch version on 65,536 primary
     rays of scenes/whitted_conductors.xml (1 spp, no DoF);
  4. the main path: render_camera on scenes/whitted_conductors.xml at
     800x800, 16 spp, depth 6, u8 clamp on the device — the launch counter
     must rise by 16; the PNG goes to a temporary directory; one warm-up
     frame, then the median of 3 timed frames (Mpaths/s, paths = w*h*spp);
  5. the kernel at the main path's shape (the 640,000 rays of one sample):
     time per launch, the plain version's time and error on the same rays,
     and the least time the card needs for the counted FP32 work.
Then the kernels line, the card line and, last, the result line.  Any
failed check raises and ends the run with a non-zero exit code; without a
CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "whitted_conductors.xml"
KERNEL_SRC = "advanced_cpu_raytracing_tpu_torch/csrc/mega_whitted.cu"
REPLACES = "advanced_cpu_raytracing_tpu/ops/pallas/megakernel.py:912"

# tolerance of the kernel against its plain version (radiance units, the
# reference's 0..255 scale): only fp contraction and reassociation at
# silhouettes may differ — the bound of the JAX package's own kernel test
MEAN_TOL, Q999_TOL = 0.01, 0.5

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# FP32 operations per test, counted in csrc/mega_whitted.cu: a ray x
# triangle test up to its t test (the part every test runs), a chunk slab
# test, a sphere test (object-space ray + quadratic)
TRI_FLOPS, SLAB_FLOPS, SPHERE_FLOPS = 38, 22, 66


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check_close(got: torch.Tensor, ref: torch.Tensor, what: str) -> dict:
    diff = (got - ref).abs().flatten().double()
    err = {"max_abs_err": float(diff.max()),
           "mean_abs_err": float(diff.mean()),
           "q999_abs_err": float(torch.quantile(diff, 0.999))}
    if not (torch.isfinite(got).all() and err["mean_abs_err"] < MEAN_TOL
            and err["q999_abs_err"] < Q999_TOL):
        raise AssertionError(f"{what}: kernel disagrees with plain: {err}")
    return err


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from advanced_cpu_raytracing_tpu_torch.ops import _build
    from advanced_cpu_raytracing_tpu_torch.ops.megakernel import (
        mega_trace,
        mega_trace_ref,
    )
    from advanced_cpu_raytracing_tpu_torch.post.writers import write_png
    from advanced_cpu_raytracing_tpu_torch.render import renderer
    from advanced_cpu_raytracing_tpu_torch.render.camera import (
        build_camera,
        generate_rays,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. probe
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit("probe", card=card, torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc.stdout.strip().splitlines()[-1],
         device_count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    _build.load("mega_whitted")
    log = _build.BUILD_LOG["mega_whitted"]
    emit("build", kernel="mega_whitted", seconds=time.perf_counter() - t0,
         cached=log["cached"],
         ptxas=[ln for ln in log["ptxas"].splitlines() if "registers" in ln
                or "spill" in ln])

    cfg = load_scene(str(SCENE))
    pack = pack_scene(cfg, device=dev)
    cam_cfg = cfg.cameras[0]
    opts = renderer.options_for_camera(cfg, cam_cfg)
    mc, tri_tab, chunk_tab = renderer._mega_build_cached(pack, opts, dev)
    cam = build_camera(cam_cfg, device=dev)
    w, h = cam_cfg.width, cam_cfg.height

    # 3. kernel vs plain on 65,536 primary rays (1 spp, no DoF)
    rng = np.random.default_rng(0)
    n = 65536
    px = torch.as_tensor(rng.uniform(0, w, n).astype(np.float32), device=dev)
    py = torch.as_tensor(rng.uniform(0, h, n).astype(np.float32), device=dev)
    o, d = generate_rays(cam, px, py)
    o, d = o.contiguous(), d.contiguous()
    got = mega_trace(mc, tri_tab, chunk_tab, o, d)
    torch.cuda.synchronize()
    ref = mega_trace_ref(mc, tri_tab, chunk_tab, o, d)
    err = check_close(got, ref, "65,536 primary rays")
    emit("kernel_vs_plain", rays=n, **err, mean_tol=MEAN_TOL, q999_tol=Q999_TOL)

    # 4. the main path: a 16-spp 800x800 frame through render_camera
    spp = cam_cfg.num_samples
    mega_trace.launches = 0
    img = renderer.render_camera(pack, cfg, cam_cfg, seed=0, ldr=True,
                                 device=dev)
    launches = mega_trace.launches
    if launches != spp:
        raise AssertionError(f"main path launched the kernel {launches} times,"
                             f" expected {spp}")
    if img.shape != (h, w, 3) or img.dtype != np.uint8 or not (
            5.0 < float(img.mean()) < 250.0):
        raise AssertionError(f"bad frame: {img.shape} {img.dtype} "
                             f"mean {img.mean()}")
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    write_png(str(out_dir / cam_cfg.image_name), img)
    hdr = renderer.render_camera(pack, cfg, cam_cfg, seed=1, device=dev)
    if not np.isfinite(hdr).all():
        raise AssertionError("non-finite radiance in the 16-spp frame")

    def frame(seed):
        return renderer.render_camera(pack, cfg, cam_cfg, seed=seed, ldr=True,
                                      device=dev)

    frame(2)  # warm-up
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame(3 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    frame_s = sorted(times)[1]
    paths = w * h * spp

    # 5. the kernel at the main path's shape: one sample's 640,000 rays
    idx = torch.arange(w * h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    jit = torch.rand((w * h, 2), generator=gen, device=dev) / math.isqrt(spp)
    o, d = generate_rays(cam, (idx % w).float() + jit[:, 0],
                         (idx // w).float() + jit[:, 1])
    o, d = o.contiguous(), d.contiguous()
    got = mega_trace(mc, tri_tab, chunk_tab, o, d)
    kernel_ms = cuda_ms(lambda: mega_trace(mc, tri_tab, chunk_tab, o, d), 5)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = mega_trace_ref(mc, tri_tab, chunk_tab, o, d, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_close(got, ref, "640,000 rays of one sample")
    flops = (stats.get("tri_tests", 0) * TRI_FLOPS
             + stats.get("slab_tests", 0) * SLAB_FLOPS
             + stats.get("sphere_tests", 0) * SPHERE_FLOPS)
    n_bytes = (o.numel() + d.numel() + got.numel()) * 4 + sum(
        t.numel() * 4 for t in (tri_tab, chunk_tab, mc.spheres, mc.materials,
                                mc.point_lights, mc.dir_lights))
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_BYTES_S * 1e3
    emit("main_path", scene=SCENE.name, width=w, height=h, spp=spp,
         depth=cfg.max_recursion_depth, launches=launches,
         frame_s_median=frame_s, frame_s_all=times,
         mpaths_per_s=paths / frame_s / 1e6, kernel_ms_per_launch=kernel_ms,
         png=str(out_dir / cam_cfg.image_name), card=card)
    emit("kernel_at_main_shape", rays=w * h, kernel_ms=kernel_ms,
         plain_ms=plain_ms, flops=flops, bytes=n_bytes, ops_ms=ops_ms,
         bytes_ms=bytes_ms, **err, **stats, card=card)

    print(json.dumps({"kernels": [{
        "name": "mega_whitted", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": err["max_abs_err"], "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
