"""An interactive preview: ``render/progressive.py::ProgressiveRenderer``,
one sample pass at a time over the whole image, the mean image read to the
host after every pass, as a viewer that refreshes each pass does.  One
renderer, seeded with the run's seed, runs through the window.

The check: after the window, a sample of the passes' images drawn from the
seed (two by reservoir sampling, and the last), at ``check_pixels``
pixels drawn from the seed; the reference traces those pixels' passes
again from the scene file, with each pass's Philox jitter, and the mean
radiance is compared.  The window keeps no whole image: of each only the
sampled pixels' values.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.runners.frames import program_scene, reference_tables, sizes
from benchmark.harness import Run, Sample, sample_pixels

CHECK_PASSES = 2
COUNT_STRIDE = 61


def setup(run: Run) -> dict:
    from advanced_cpu_raytracing_tpu_torch.render.progressive import (
        ProgressiveRenderer,
    )

    cfg, cam, pack = program_scene(run)
    with run.spans("warmup"):
        warm = ProgressiveRenderer(pack, cfg, cam, seed=run.seed + 1,
                                   device=run.device)
        for _ in range(2):
            warm.step()
            warm.image
        del warm
    r = ProgressiveRenderer(pack, cfg, cam, seed=run.seed, device=run.device)
    return {"renderer": r}


def window(run: Run, st: dict) -> dict:
    r = st["renderer"]
    w, h, _ = sizes(run)
    n_pix = run.overrides.get("pixels", run.traffic["check_pixels"])
    sample = Sample(run.seed, CHECK_PASSES, sample_pixels(run.seed, w * h,
                                                          n_pix))
    times = []
    end = time.perf_counter() + run.seconds
    i = 0
    while True:
        with run.spans("pass"):
            a = time.perf_counter()
            r.step()
            img = r.image
            b = time.perf_counter()
        times.append(b - a)
        sample.offer(i, img)
        i += 1
        if b >= end:
            break
    return {"units": i, "unit": "pass", "times": times, "paths": i * w * h,
            "sample": sample}


def answers(run: Run, st: dict, work: dict) -> dict:
    """The program's mean radiance at the sampled pixels after the kept
    passes."""
    sample = work.pop("sample")
    out = [{"pass": i, "rgb": vals} for i, vals in sample.answers()]
    st.clear()
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    return {"pixels": sample.pixels, "passes": out}


def reference_answers(run: Run, ans: dict, dtype=torch.float32) -> dict:
    tb = reference_tables(run, dtype)
    pix = torch.as_tensor(ans["pixels"], device=run.device)
    means = run.reference().progressive_mean(
        tb, run.seed, pix, [p["pass"] for p in ans["passes"]])
    return {"pixels": ans["pixels"],
            "passes": [{"pass": p["pass"],
                        "rgb": means[p["pass"]].float().cpu().numpy()}
                       for p in ans["passes"]]}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers judged: the mean |d| of the sampled channels over their
    mean |reference|, and the share of channels that differ by more than
    0.5 (of 255)."""
    a = np.concatenate([p["rgb"].ravel() for p in prog["passes"]])
    b = np.concatenate([p["rgb"].ravel() for p in ref["passes"]])
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    d = np.where(np.isfinite(d), d, np.inf)
    return {"mean_rel": float(d.mean() / max(np.abs(b).mean(), 1e-30)),
            "over_half_share": float((d > 0.5).mean())}


def checked(prog: dict) -> int:
    return len(prog["passes"])


def counts(run: Run, ans: dict) -> dict:
    """The reference's queries of one pass's rays (pass 1: jittered),
    counted on every ``COUNT_STRIDE``th pixel and scaled to the image, per
    launch (one a pass)."""
    tb = reference_tables(run)
    w, h, _ = sizes(run)
    pix = torch.arange(0, w * h, COUNT_STRIDE, device=run.device)
    run.reference().progressive_mean(tb, run.seed, pix, [1])
    scale = w * h / pix.shape[0] / 2  # passes 0 and 1
    return {"queries": (tb.counts.closest + tb.counts.shadow) * scale,
            "rays": w * h}
