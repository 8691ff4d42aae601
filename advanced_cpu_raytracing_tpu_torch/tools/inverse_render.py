"""Inverse rendering through the differentiable render's kernels: the port
of the JAX package's ``tools/inverse_render.py``.

    python -m advanced_cpu_raytracing_tpu_torch.tools.inverse_render \\
        [--texture] [--steps N] [--spp S] [--res W] [--lr X] [--image PATH] \\
        [--device cuda|cpu] [--out PATH]

Adam over ``ops/megabwd.py::make_diff_render`` toward target images that
the same render makes at the true parameters, the loss
mean(((img - target) / 255)^2) of S fixed stratified sample grids of the
res x res pixel grid (one fixed jitter per cell from
``np.random.default_rng(7)``, no depth of field), one value-and-grad and
one Adam step per grid, each step's loss the mean over the grids.

* ``gauge`` (the default): the port's gauge scene
  (``scene/feature_scenes.py::gauge_scene_xml``: scenes/
  whitted_conductors.xml with a known directional anchor light, for the
  JAX tool's absent cornellbox-conductors), fields ``mat_diffuse`` and
  ``pl_intensity``, started at 0.45x and 1.7x the truth; kernel K2a.
* ``--texture``: inverse texture recovery on the JAX tool's texture scene
  (``texture_inverse_scene_xml``: a 64x64 bilinear ``replace_kd`` texture on
  a tilted quad), field ``img_atlas``, started at flat grey + N(0, 20)
  noise of seed 3; kernel K2c.  ``--image PATH`` (not in the JAX tool)
  puts another image in the texture's place, as the 1024x1024
  ``scenes/textures/floor_tiles.png`` past the JAX kernel's 4,096-texel cap.

As in the JAX tool: the parameters move in a per-field normalized space (u
= p / max|p_true|), so that one rate serves fields of any magnitude (the
JAX tool gives vertices a 30x smaller rate; no mode here optimizes them),
and entries whose gradient is exactly zero at the truth on every grid (against
targets scaled by 0.9) are unobservable and reported apart.
``torch.optim.Adam`` takes optax's place.  It prints the loss every 10
steps and one JSON summary line (loss history, recovery errors, image and
texture PSNR, wall seconds, steps/s and rays/s of the timed loop), and
writes the summary to ``--out`` (default ``build/inverse_render_<mode>.json``
beside the package, a directory git ignores).  Runs on the card unless
given ``--device cpu`` (the plain version: small sizes only).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.diff.params import extract_params
from advanced_cpu_raytracing_tpu_torch.ops.megabwd import make_diff_render
from advanced_cpu_raytracing_tpu_torch.render.camera import (
    build_camera,
    generate_rays,
)
from advanced_cpu_raytracing_tpu_torch.render.renderer import options_for_camera
from advanced_cpu_raytracing_tpu_torch.scene.feature_scenes import (
    gauge_scene_xml,
    texture_inverse_scene_xml,
)
from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
FIELDS = {"gauge": ("mat_diffuse", "pl_intensity"), "texture": ("img_atlas",)}


def _scene(mode: str, n_tex: int, image, work_dir: Path) -> str:
    if mode == "texture":
        return texture_inverse_scene_xml(n_tex, image=image, out_dir=work_dir)
    return gauge_scene_xml(work_dir, ROOT / "scenes")


def _start(mode: str, true: dict) -> dict:
    """The JAX tool's perturbation: the texture flat grey + N(0, 20) noise
    of seed 3; else kd x 0.45 and the light x 1.7."""
    if mode == "texture":
        a = true["img_atlas"]
        noise = np.random.default_rng(3).normal(0, 20, tuple(a.shape))
        return {"img_atlas": torch.full_like(a, 128.0) + torch.as_tensor(
            noise.astype(np.float32), device=a.device)}
    return {"mat_diffuse": true["mat_diffuse"] * 0.45,
            "pl_intensity": true["pl_intensity"] * 1.7}


def sample_grids(cam_cfg, cam, res: int, spp: int, dev):
    """The rays of ``spp`` fixed jitters of the res x res pixel grid over
    the camera's image (the reference's stratified cells, main.cpp:44-76,
    one fixed sample per cell so that the target and the optimization see
    the same points)."""
    n = res * res
    ys, xs = np.divmod(np.arange(n, dtype=np.int64), res)
    sx, sy = cam_cfg.width / res, cam_cfg.height / res
    jit = np.random.default_rng(7).uniform(0, 1, (spp, 2)).astype(np.float32)
    rays = []
    for s in range(spp):
        px = torch.as_tensor(((xs + jit[s, 0]) * sx).astype(np.float32),
                             device=dev)
        py = torch.as_tensor(((ys + jit[s, 1]) * sy).astype(np.float32),
                             device=dev)
        o, d = generate_rays(cam, px, py)
        rays.append((o.contiguous(), d.contiguous()))
    return rays


def run(mode: str = "gauge", steps: int = 60, spp: int = 4, res: int = 800,
        lr: float = 5e-3, image=None, n_tex: int = 64, device=None,
        log=print) -> dict:
    """One inverse-rendering run; returns the summary (see the module
    docstring).  ``mode`` is ``gauge`` or ``texture``; ``n_tex`` the size of
    the authored texture."""
    dev = resolve_device(device)
    fields = FIELDS[mode]
    with tempfile.TemporaryDirectory(prefix="acrt_inverse_") as work:
        cfg = load_scene(_scene(mode, n_tex, image, Path(work)))
        pack = pack_scene(cfg, device=dev)
    cam_cfg = cfg.cameras[0]
    cam = build_camera(cam_cfg, device=dev)
    opts = options_for_camera(cfg, cam_cfg)
    render = make_diff_render(pack, opts, device=dev)
    rays = sample_grids(cam_cfg, cam, res, spp, dev)
    true = {k: v.detach().to(dev, torch.float32).clone()
            for k, v in extract_params(pack, fields).items()}
    with torch.no_grad():
        targets = [render(true, o, d) for o, d in rays]
    scales = {k: torch.clamp(v.abs().max(), min=1e-3) for k, v in true.items()}

    def to_p(u):
        return {k: u[k] * scales[k] for k in u}

    def loss_fn(u, o, d, target):
        return torch.mean(((render(to_p(u), o, d) - target) / 255.0) ** 2)

    # observability: entries whose gradient at the truth, against targets
    # scaled by 0.9, is exactly zero on every grid have no footprint in
    # these images
    u_true = {k: (v / scales[k]).requires_grad_(True) for k, v in true.items()}
    gsum = {k: torch.zeros_like(v) for k, v in true.items()}
    for (o, d), target in zip(rays, targets):
        grads = torch.autograd.grad(loss_fn(u_true, o, d, target * 0.9),
                                    list(u_true.values()))
        for k, g in zip(u_true, grads):
            gsum[k] += g.abs()
    observable = {k: v > 1e-12 for k, v in gsum.items()}

    start = _start(mode, true)
    u = {k: (v / scales[k]).detach().clone().requires_grad_(True)
         for k, v in start.items()}
    adam = torch.optim.Adam([u[k] for k in fields], lr=lr)
    history = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        total = torch.zeros((), device=dev)
        for (o, d), target in zip(rays, targets):
            adam.zero_grad(set_to_none=True)
            loss = loss_fn(u, o, d, target)
            loss.backward()
            adam.step()
            total = total + loss.detach()
        history.append(float(total) / spp)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i}: loss {history[-1]:.6g}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    params = {k: v.detach() for k, v in to_p(u).items()}

    def real(k, x):
        """The real texel region of image 0 (the atlas pads to Hmax x
        Wmax); other fields as they are."""
        if k != "img_atlas":
            return x
        return x[0, :int(pack.img_h[0]), :int(pack.img_w[0])]

    def max_rel_err(k, mask=None):
        a, b = params[k], true[k]
        if mask is not None:
            if not bool(mask[k].any()):
                return 0.0
            a = torch.where(mask[k], a, b)
        a, b = real(k, a), real(k, b)
        return float((a - b).abs().max() / torch.clamp(b.abs().max(), min=1e-6))

    with torch.no_grad():
        final = render(params, *rays[0])
    mse = float(torch.mean((final - targets[0]) ** 2))
    summary = {
        "mode": mode,
        "scene": {"gauge": "whitted_conductors.xml + a known directional "
                           "anchor (gauge-broken)",
                  "texture": f"authored {n_tex}x{n_tex} bilinear replace_kd "
                             "quad (inverse texture recovery)"
                  if image is None else f"{Path(image).name} as a bilinear "
                                        "replace_kd quad"}[mode],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "resolution": [res, res], "spp": spp, "steps": steps, "lr": lr,
        "fields": list(fields), "variant": render.bc.variant,
        "wall_s": wall, "steps_per_s": steps / wall,
        "rays_per_s": steps * spp * res * res / wall,
        "loss_first": history[0], "loss_last": history[-1],
        "loss_history": history,
        "max_rel_err": {k: max_rel_err(k) for k in fields},
        "max_rel_err_observable": {k: max_rel_err(k, observable)
                                   for k in fields},
        "unobservable_entries": {k: int((~real(k, observable[k])).sum())
                                 for k in fields},
        "image_psnr_db": 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12)),
    }
    if mode == "texture":
        tex_mse = float(torch.mean((real("img_atlas", params["img_atlas"])
                                    - real("img_atlas", true["img_atlas"]))
                                   ** 2))
        summary["texture_mse"] = tex_mse
        summary["texture_psnr_db"] = 10.0 * np.log10(
            255.0 ** 2 / max(tex_mse, 1e-12))
        summary["texels"] = int(pack.img_w[0]) * int(pack.img_h[0])
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Inverse rendering through the differentiable render "
                    "(the JAX package's tools/inverse_render.py).")
    ap.add_argument("--texture", action="store_true",
                    help="inverse texture recovery (field img_atlas)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--image", default=None,
                    help="texture mode: this image in place of the authored "
                         "64x64 texture (not an option of the JAX tool; "
                         "e.g. scenes/textures/floor_tiles.png, 1024x1024)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain version)")
    ap.add_argument("--out", default=None,
                    help="where to write the summary (default build/"
                         "inverse_render_<mode>.json beside the package)")
    args = ap.parse_args(argv)
    mode = "texture" if args.texture else "gauge"
    summary = run(mode, args.steps, args.spp, args.res, args.lr, args.image,
                  device=args.device, log=lambda s: print(s, flush=True))
    print(json.dumps(summary), flush=True)
    out = Path(args.out) if args.out else (ROOT / "build"
                                           / f"inverse_render_{mode}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
