"""CLI entry point:
``python -m advanced_cpu_raytracing_tpu_torch.cli.render scene.xml``.

Matches the reference's main program (src/main.cpp:132-202): renders every
camera in the scene; tonemapped cameras emit both ``<name>.hdr`` (raw
radiance) and ``<name w/o ext>.png``; others emit the clamped LDR png;
prints total wall-clock at the end.  Renders on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Whitted and path tracer (CUDA)")
    parser.add_argument("scene", help="XML scene file")
    parser.add_argument("--out-dir", default=".", help="output directory")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--spp", type=int, default=None,
                        help="override per-camera NumSamples")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="render on the CUDA card (default) or the CPU")
    args = parser.parse_args(argv)

    from advanced_cpu_raytracing_tpu_torch.post.tonemap import reinhard_tonemap
    from advanced_cpu_raytracing_tpu_torch.post.writers import write_hdr, write_png
    from advanced_cpu_raytracing_tpu_torch.render.renderer import (
        ldr_from_radiance,
        render_camera,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene
    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    if not os.path.exists(args.scene):
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = load_scene(args.scene)
    start = time.perf_counter()
    pack = pack_scene(cfg, device=args.device)

    for cam_cfg in cfg.cameras:
        print(f"Resolution: {cam_cfg.width}x{cam_cfg.height}, "
              f"samples: {cam_cfg.num_samples}")
        img = render_camera(pack, cfg, cam_cfg, seed=args.seed, spp=args.spp,
                            device=args.device)
        base = os.path.join(args.out_dir, cam_cfg.image_name)
        stem = base[: base.rfind(".")] if "." in os.path.basename(base) else base
        if cam_cfg.tonemap is not None:
            tm = cam_cfg.tonemap
            ldr = reinhard_tonemap(img, key_value=tm.key_value,
                                   burn_percent=tm.burn_percent,
                                   saturation=tm.saturation, gamma=tm.gamma,
                                   device=args.device)
            write_hdr(base if base.endswith(".hdr") else stem + ".hdr",
                      np.nan_to_num(img))
            write_png(stem + ".png", ldr)
        else:
            write_png(stem + ".png", ldr_from_radiance(img))
        print(f"wrote {stem}.png")

    elapsed = time.perf_counter() - start
    print(f"Rendering took: {elapsed}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
