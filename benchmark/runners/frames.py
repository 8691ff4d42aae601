"""Whole frames in a closed loop: ``render/renderer.py::render_camera(...,
ldr=True)`` frame after frame, each ending in the u8 image on the host, as
the CLI and a render farm ask for them.  Frame i renders with the seed
``frame_seed(seed, i)``.

The check: after the window, a sample of the frames drawn from the seed
(two by reservoir sampling, and the last), at ``check_pixels`` pixels
drawn from the seed; the reference renders those pixels again from the
scene file, with the frame's jitter, and the u8 values are compared.  The
window keeps no whole frame: of each only the sampled pixels' values.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.harness import Run, Sample, sample_pixels

CHECK_FRAMES = 2  # frames kept by reservoir sampling, besides the last
COUNT_STRIDE = 61  # the roofline's count: every 61st pixel of a frame


def frame_seed(seed: int, i: int) -> int:
    return (int(seed) << 16) | (i & 0xFFFF)


def sizes(run: Run) -> tuple[int, int, int]:
    """(width, height, spp) of the frames."""
    c = run.config
    return (run.overrides.get("width", c["width"]),
            run.overrides.get("height", c["height"]),
            run.overrides.get("spp", run.traffic["spp"])
            if "spp" in run.traffic else 1)


def program_scene(run: Run):
    """The program's scene, tables and camera, timed as ``tables``."""
    from advanced_cpu_raytracing_tpu_torch.render import renderer
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    dev = torch.device(run.device)
    w, h, _ = sizes(run)
    with run.spans("tables"):
        cfg = load_scene(str(run.scene_path()))
        cam = cfg.cameras[0]
        cam.width, cam.height = w, h
        pack = pack_scene(cfg, device=dev)
        renderer._mega_build_cached(pack, renderer.options_for_camera(
            cfg, cam), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return cfg, cam, pack


def reference_tables(run: Run, dtype=torch.float32):
    ref = run.reference()
    sc = ref.load(run.scene_path())
    sc.camera.width, sc.camera.height, _ = sizes(run)
    return ref.tables(sc, run.device, dtype)


def setup(run: Run) -> dict:
    from advanced_cpu_raytracing_tpu_torch.render import renderer

    cfg, cam, pack = program_scene(run)
    _, _, spp = sizes(run)
    with run.spans("warmup"):
        for i in (0xFFFF, 0xFFFE):
            renderer.render_camera(pack, cfg, cam, seed=frame_seed(
                run.seed, i), spp=spp, ldr=True, device=run.device)
    return {"cfg": cfg, "cam": cam, "pack": pack}


def render_frame(run: Run, st: dict, fs: int) -> np.ndarray:
    from advanced_cpu_raytracing_tpu_torch.render import renderer

    return renderer.render_camera(st["pack"], st["cfg"], st["cam"], seed=fs,
                                  spp=sizes(run)[2], ldr=True,
                                  device=run.device)


def window(run: Run, st: dict) -> dict:
    w, h, spp = sizes(run)
    n_pix = run.overrides.get("pixels", run.traffic["check_pixels"])
    sample = Sample(run.seed, CHECK_FRAMES, sample_pixels(run.seed, w * h,
                                                          n_pix))
    times = []
    end = time.perf_counter() + run.seconds
    i = 0
    while True:
        fs = frame_seed(run.seed, i)
        with run.spans("frame"):
            a = time.perf_counter()
            img = render_frame(run, st, fs)
            b = time.perf_counter()
        times.append(b - a)
        sample.offer((i, fs), img)
        i += 1
        if b >= end:
            break
    return {"units": i, "unit": "frame", "times": times,
            "paths": i * w * h * spp, "sample": sample}


def answers(run: Run, st: dict, work: dict) -> dict:
    """The program's u8 values at the sampled pixels of the kept frames."""
    sample = work.pop("sample")
    out = [{"frame": i, "seed": fs, "pixels": sample.pixels, "u8": vals}
           for (i, fs), vals in sample.answers()]
    st.clear()
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    return {"frames": out}


def reference_answers(run: Run, ans: dict, dtype=torch.float32) -> dict:
    """The reference's u8 values at the same pixels of the same frames,
    in ``dtype``."""
    ref = run.reference()
    tb = reference_tables(run, dtype)
    w, h, spp = sizes(run)
    n_cells = max(math.isqrt(max(spp, 1)), 1)
    out = []
    for f in ans["frames"]:
        pix = torch.as_tensor(f["pixels"], device=run.device)
        jit = ref.frame_jitter(f["seed"], w * h, n_cells * n_cells,
                               run.device)[:, pix]
        col = ref.multisample(tb, pix, jit, n_cells)
        out.append({**f, "u8": ref.to_u8(col).cpu().numpy()})
    return {"frames": out}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers judged: the mean |du8| over the sampled channels, and
    the share of channels that differ by more than 2."""
    d = np.concatenate([np.abs(a["u8"].astype(np.int64)
                               - b["u8"].astype(np.int64)).ravel()
                        for a, b in zip(prog["frames"], ref["frames"])])
    return {"u8_mean_abs": float(d.mean()),
            "u8_over2_share": float((d > 2).mean())}


def checked(prog: dict) -> int:
    return len(prog["frames"])


def counts(run: Run, ans: dict) -> dict:
    """The reference's closest-hit and shadow queries of the window's first
    frame's rays, counted on every ``COUNT_STRIDE``th pixel and scaled to
    the frame, per launch of the kernel (one launch a sample)."""
    ref = run.reference()
    tb = reference_tables(run)
    w, h, spp = sizes(run)
    n_cells = max(math.isqrt(max(spp, 1)), 1)
    pix = torch.arange(0, w * h, COUNT_STRIDE, device=run.device)
    jit = ref.frame_jitter(frame_seed(run.seed, 0), w * h,
                           n_cells * n_cells, run.device)[:, pix]
    ref.multisample(tb, pix, jit, n_cells)
    scale = w * h / pix.shape[0] / (n_cells * n_cells)
    return {"queries": (tb.counts.closest + tb.counts.shadow) * scale,
            "rays": w * h}
