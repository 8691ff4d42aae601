"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. probe: the card's name and power limit, torch's CUDA version, nvcc;
  2. build both megakernel variants, one nvcc each, started together:
     csrc/mega_whitted.cu (K1a) and csrc/mega_pt.cu (K1b), with ptxas's
     register and spill lines;
  3. K1a against its plain torch version on 65,536 primary rays of
     scenes/whitted_conductors.xml (1 spp, no DoF);
  4. the Whitted main path: render_camera on scenes/whitted_conductors.xml
     at 800x800, 16 spp, depth 6, u8 clamp on the device — with the launch
     counters set to 0 before it, K1a must launch 16 times and K1b never;
     the PNG goes to a temporary directory; one warm-up frame, then the
     median of 3 timed frames (Mpaths/s, paths = w*h*spp);
  5. K1a at its main path's shape (the 640,000 rays of one sample): time
     per launch, the plain version's time and error on the same rays, and
     the least time the card needs for the counted FP32 work;
  6. K1b against its plain version on 65,536 primary rays in both draw
     modes (a table from a torch.Generator, and Philox) on
     scenes/feat_pt.xml, feat_pt_rr.xml, feat_pt_spec.xml and feat_pt.xml
     without its <Renderer> (Whitted + LightMesh);
  7. the path-tracing main path: render_camera on scenes/feat_pt.xml at
     800x800, 16 spp, depth 4, NEE + importance sampling, u8 clamp on the
     device — with the counters set to 0 before it, K1b must launch 16
     times and K1a never; one warm-up frame, then the median of 3 timed
     frames; then one frame each of feat_pt_rr.xml (16 spp) and
     feat_pt_spec.xml (1 spp), checked finite and sane;
  8. K1b at its main path's shape (640,000 rays of one sample, Philox):
     time per launch, the plain version's time and error on the same rays
     and draws, and the bound of the counted FP32 work.
Then the kernels line, the card line and, last, the result line.  Any
failed check raises and ends the run with a non-zero exit code; without a
CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SCENES = ROOT / "scenes"
WHITTED_SCENE = SCENES / "whitted_conductors.xml"
PT_SCENE = SCENES / "feat_pt.xml"
SOURCES = {"mega_whitted": "advanced_cpu_raytracing_tpu_torch/csrc/mega_whitted.cu",
           "mega_pt": "advanced_cpu_raytracing_tpu_torch/csrc/mega_pt.cu"}
REPLACES = "advanced_cpu_raytracing_tpu/ops/pallas/megakernel.py:912"

# K1a against its plain version (radiance units, the reference's 0..255
# scale): only fp contraction and reassociation at silhouettes may differ —
# the bound of the JAX package's own kernel test
MEAN_TOL, Q999_TOL = 0.01, 0.5
# K1b against its plain version on the same draws: a last-ulp difference
# (libdevice sinf/cosf/expf against torch's) can flip a Russian-roulette
# kill or a GI hit and change that ray by a whole path, so a few rays may
# differ: 99.5% of them within 1e-3 + 1e-3 |ref|, batch means within 1%
PT_ATOL = PT_RTOL = 1e-3
PT_FRAC, PT_MEAN_REL = 0.995, 0.01

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# FP32 operations per test, counted in csrc/mega_common.cuh: a ray x
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


def check_close_pt(got: torch.Tensor, ref: torch.Tensor, what: str) -> dict:
    diff = (got - ref).abs()
    within = (diff <= PT_ATOL + PT_RTOL * ref.abs()).all(dim=1)
    m_got, m_ref = float(got.double().mean()), float(ref.double().mean())
    err = {"max_abs_err": float(diff.max()),
           "frac_within": float(within.double().mean()),
           "mean": m_got, "plain_mean": m_ref}
    if not (torch.isfinite(got).all() and err["frac_within"] >= PT_FRAC
            and abs(m_got - m_ref) <= PT_MEAN_REL * abs(m_ref)):
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


def bound(stats: dict, n_bytes: int) -> dict:
    """The least time for the counted FP32 work and the bytes moved."""
    flops = (stats.get("tri_tests", 0) * TRI_FLOPS
             + stats.get("slab_tests", 0) * SLAB_FLOPS
             + stats.get("sphere_tests", 0) * SPHERE_FLOPS)
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    return {"flops": flops, "bytes": n_bytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from advanced_cpu_raytracing_tpu_torch.ops import _build
    from advanced_cpu_raytracing_tpu_torch.ops import megakernel as mk
    from advanced_cpu_raytracing_tpu_torch.ops.rng import philox_table
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
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))

    # 1. probe
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit("probe", card=card, torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc.stdout.strip().splitlines()[-1],
         device_count=torch.cuda.device_count())

    # 2. build both variants in parallel
    t0 = time.perf_counter()
    _build.build_all(list(SOURCES))
    for name in SOURCES:
        log = _build.BUILD_LOG[name]
        emit("build", kernel=name, seconds=log["seconds"], cached=log["cached"],
             wall_seconds_all=time.perf_counter() - t0,
             ptxas=[ln for ln in log["ptxas"].splitlines() if "registers" in ln
                    or "spill" in ln or "stack frame" in ln])

    def scene(path_or_xml, name=None):
        if name is not None:  # an XML text: write it beside nothing else
            path = out_dir / name
            path.write_text(path_or_xml)
            path_or_xml = path
        cfg = load_scene(str(path_or_xml))
        pack = pack_scene(cfg, device=dev)
        cam_cfg = cfg.cameras[0]
        opts = renderer.options_for_camera(cfg, cam_cfg)
        tabs = renderer._mega_build_cached(pack, opts, dev)
        return cfg, pack, cam_cfg, tabs, build_camera(cam_cfg, device=dev)

    def primary_rays(cam_cfg, cam, n, seed=0):
        rng = np.random.default_rng(seed)
        px = torch.as_tensor(rng.uniform(0, cam_cfg.width, n).astype(np.float32),
                             device=dev)
        py = torch.as_tensor(rng.uniform(0, cam_cfg.height, n).astype(np.float32),
                             device=dev)
        o, d = generate_rays(cam, px, py)
        return o.contiguous(), d.contiguous()

    def sample_rays(cam_cfg, cam, spp):
        """The rays of one jittered sample of the whole frame."""
        w, h = cam_cfg.width, cam_cfg.height
        idx = torch.arange(w * h, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        jit = torch.rand((w * h, 2), generator=gen, device=dev) / math.isqrt(spp)
        o, d = generate_rays(cam, (idx % w).float() + jit[:, 0],
                             (idx // w).float() + jit[:, 1])
        return o.contiguous(), d.contiguous()

    def main_path(pack, cfg, cam_cfg, kernel: str, what: str) -> dict:
        """One checked u8 frame with the counters at 0 before it, then a
        warm-up and the median of 3 timed frames."""
        spp = cam_cfg.num_samples
        for k in mk.LAUNCHES:
            mk.LAUNCHES[k] = 0
        img = renderer.render_camera(pack, cfg, cam_cfg, seed=0, ldr=True,
                                     device=dev)
        launches = dict(mk.LAUNCHES)
        want = {k: (spp if k == kernel else 0) for k in mk.LAUNCHES}
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, expected {want}")
        w, h = cam_cfg.width, cam_cfg.height
        if img.shape != (h, w, 3) or img.dtype != np.uint8 or not (
                5.0 < float(img.mean()) < 250.0):
            raise AssertionError(f"{what}: bad frame: {img.shape} {img.dtype} "
                                 f"mean {img.mean()}")
        png = out_dir / f"{kernel}_{cam_cfg.image_name}"
        write_png(str(png), img)
        hdr = renderer.render_camera(pack, cfg, cam_cfg, seed=1, device=dev)
        if not np.isfinite(hdr).all():
            raise AssertionError(f"{what}: non-finite radiance")

        def frame(seed):
            return renderer.render_camera(pack, cfg, cam_cfg, seed=seed,
                                          ldr=True, device=dev)

        frame(2)  # warm-up
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(3 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        frame_s = sorted(times)[1]
        return dict(width=w, height=h, spp=spp, depth=cfg.max_recursion_depth,
                    launches=launches[kernel], frame_s_median=frame_s,
                    frame_s_all=times, mpaths_per_s=w * h * spp / frame_s / 1e6,
                    u8_mean=float(img.mean()), png=str(png), card=card)

    def table_bytes(mc, tabs):
        return sum(t.numel() * 4 for t in (
            *tabs[:2], mc.spheres, mc.materials, mc.point_lights,
            mc.dir_lights, mc.ml_faces, mc.ml_lights))

    kernels = []

    # ---- K1a: the Whitted path ----
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(WHITTED_SCENE)

    # 3. kernel vs plain on 65,536 primary rays (1 spp, no DoF)
    o, d = primary_rays(cam_cfg, cam, 65536)
    got = mk.mega_trace(mc, tri_tab, chunk_tab, o, d)
    torch.cuda.synchronize()
    ref = mk.mega_trace_ref(mc, tri_tab, chunk_tab, o, d)
    err = check_close(got, ref, "K1a, 65,536 primary rays")
    emit("kernel_vs_plain", kernel="mega_whitted", scene=WHITTED_SCENE.name,
         rays=65536, **err, mean_tol=MEAN_TOL, q999_tol=Q999_TOL)

    # 4. the Whitted main path
    mp = main_path(pack, cfg, cam_cfg, "mega_whitted", "Whitted main path")
    emit("main_path", kernel="mega_whitted", scene=WHITTED_SCENE.name, **mp)

    # 5. K1a at the main path's shape: one sample's 640,000 rays
    o, d = sample_rays(cam_cfg, cam, cam_cfg.num_samples)
    got = mk.mega_trace(mc, tri_tab, chunk_tab, o, d)
    kernel_ms = cuda_ms(lambda: mk.mega_trace(mc, tri_tab, chunk_tab, o, d), 5)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = mk.mega_trace_ref(mc, tri_tab, chunk_tab, o, d, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_close(got, ref, "K1a, 640,000 rays of one sample")
    bd = bound(stats, (o.numel() + d.numel() + got.numel()) * 4
               + table_bytes(mc, (tri_tab, chunk_tab)))
    emit("kernel_at_main_shape", kernel="mega_whitted", rays=o.shape[0],
         kernel_ms=kernel_ms, plain_ms=plain_ms, **bd, **err, **stats, card=card)
    kernels.append({
        "name": "mega_whitted", "route": "cuda", "source": SOURCES["mega_whitted"],
        "replaces": REPLACES, "launches": mp["launches"],
        "max_abs_err": err["max_abs_err"], "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
        "library_ms": None})

    # ---- K1b: the path-tracing path ----
    # 6. kernel vs plain on 65,536 primary rays, both draw modes
    pt_xml = PT_SCENE.read_text()
    variants = [
        ("feat_pt.xml", PT_SCENE, None),
        ("feat_pt_rr.xml", SCENES / "feat_pt_rr.xml", None),
        ("feat_pt_spec.xml", SCENES / "feat_pt_spec.xml", None),
        ("feat_pt.xml, Whitted + LightMesh",
         re.sub(r"<Renderer>.*?</RendererParams>", "", pt_xml, flags=re.S),
         "whitted_meshlight.xml"),
    ]
    for label, src, name in variants:
        _, _, v_cam_cfg, (vmc, vtri, vchunk), vcam = scene(src, name)
        if vmc.kernel != "mega_pt":
            raise AssertionError(f"{label}: routed to {vmc.kernel}")
        o, d = primary_rays(v_cam_cfg, vcam, 65536, seed=1)
        rows = vmc.max_iters * vmc.n_draws
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        for mode, draws in (
                ("table", torch.rand((rows, o.shape[0]), generator=gen,
                                     device=dev)),
                ("philox", None)):
            got = mk.mega_trace(vmc, vtri, vchunk, o, d, draws=draws, seed=9,
                                sample=3)
            torch.cuda.synchronize()
            if draws is None:
                draws = philox_table(9, 3, o.shape[0], vmc.max_iters,
                                     vmc.n_draws, device=dev)
            ref = mk.mega_trace_ref(vmc, vtri, vchunk, o, d, draws=draws)
            err = check_close_pt(got, ref, f"K1b, {label}, {mode}")
            emit("kernel_vs_plain", kernel="mega_pt", scene=label, draws=mode,
                 rays=o.shape[0], max_iters=vmc.max_iters, stack_k=vmc.stack_k,
                 n_draws=vmc.n_draws, **err, atol=PT_ATOL, rtol=PT_RTOL,
                 frac_tol=PT_FRAC, mean_rel_tol=PT_MEAN_REL)
        del draws

    # 7. the path-tracing main path, then one frame of RR and of specular PT
    cfg, pack, cam_cfg, (mc, tri_tab, chunk_tab), cam = scene(PT_SCENE)
    mp = main_path(pack, cfg, cam_cfg, "mega_pt", "path-tracing main path")
    emit("main_path", kernel="mega_pt", scene=PT_SCENE.name, **mp)
    for name in ("feat_pt_rr.xml", "feat_pt_spec.xml"):
        v_cfg, v_pack, v_cam_cfg, _, _ = scene(SCENES / name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hdr = renderer.render_camera(v_pack, v_cfg, v_cam_cfg, seed=0,
                                     device=dev)
        frame_s = time.perf_counter() - t0
        ldr = renderer.ldr_from_radiance(hdr)
        if not (np.isfinite(hdr).all() and hdr.min() >= 0.0
                and 5.0 < float(ldr.mean()) < 250.0):
            raise AssertionError(f"{name}: bad frame: finite "
                                 f"{np.isfinite(hdr).all()}, min {hdr.min()}, "
                                 f"u8 mean {ldr.mean()}")
        write_png(str(out_dir / f"mega_pt_{name}.png"), ldr)
        emit("frame", kernel="mega_pt", scene=name, spp=v_cam_cfg.num_samples,
             frame_s=frame_s, u8_mean=float(ldr.mean()),
             radiance_mean=float(hdr.mean()), card=card)

    # 8. K1b at the main path's shape: one sample's 640,000 rays, Philox
    o, d = sample_rays(cam_cfg, cam, cam_cfg.num_samples)
    got = mk.mega_trace(mc, tri_tab, chunk_tab, o, d, seed=0, sample=0)
    kernel_ms = cuda_ms(
        lambda: mk.mega_trace(mc, tri_tab, chunk_tab, o, d, seed=0, sample=0), 5)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draws = philox_table(0, 0, o.shape[0], mc.max_iters, mc.n_draws, device=dev)
    ref = mk.mega_trace_ref(mc, tri_tab, chunk_tab, o, d, draws=draws,
                            stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = check_close_pt(got, ref, "K1b, 640,000 rays of one sample")
    bd = bound(stats, (o.numel() + d.numel() + got.numel()) * 4
               + table_bytes(mc, (tri_tab, chunk_tab)))
    emit("kernel_at_main_shape", kernel="mega_pt", rays=o.shape[0],
         kernel_ms=kernel_ms, plain_ms=plain_ms, **bd, **err, **stats, card=card)
    kernels.append({
        "name": "mega_pt", "route": "cuda", "source": SOURCES["mega_pt"],
        "replaces": REPLACES, "launches": mp["launches"],
        "max_abs_err": err["max_abs_err"], "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
        "library_ms": None})

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
