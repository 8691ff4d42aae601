"""CLI entry point:
``python -m advanced_cpu_raytracing_tpu_torch.cli.render scene.xml``.

Matches the reference's main program (src/main.cpp:132-202): renders every
camera in the scene; tonemapped cameras emit both ``<name>.hdr`` (raw
radiance) and ``<name w/o ext>.png``; others emit the clamped LDR png;
prints total wall-clock at the end.  Renders on the CUDA card unless
``--device cpu``.  A scene inside the megakernel's envelope
(``ops/megakernel.py::mega_missing``: Whitted or path traced, with point,
directional, spot, area, mesh and environment lights, the pluggable BRDFs,
roughness, motion blur, DoF, and image and Perlin textures in every decal
mode) renders through the megakernel; any other (two environment lights,
textures with a BRDF or motion, depth above 10, ...) through the wavefront
integrator, in lane tiles of ``--tile`` rays.

``--shard`` splits every camera's pixels over the ranks of a
``torch.distributed`` process group (``parallel/``): under ``torchrun``
(one process per card, NCCL), or alone as a group of one rank.  Each
camera then goes through ``render_camera_sharded`` and the sharded
tonemap, and rank 0 alone writes the files and prints:

    torchrun --nproc-per-node 4 -m advanced_cpu_raytracing_tpu_torch.cli.render scene.xml --shard
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
    parser.add_argument("--tile", type=int, default=None,
                        help="the wavefront's lane tile size (rays)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="render on the CUDA card (default) or the CPU")
    parser.add_argument("--shard", action="store_true",
                        help="shard pixels over the ranks of a "
                             "torch.distributed group (torchrun; scene "
                             "replicated)")
    args = parser.parse_args(argv)

    from advanced_cpu_raytracing_tpu_torch.scene.xml_parser import load_scene

    if not os.path.exists(args.scene):
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 1
    cfg = load_scene(args.scene)
    if not args.shard:
        return _render_all(args, cfg, None)
    import torch.distributed as dist

    from advanced_cpu_raytracing_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_device_mesh,
    )

    made = initialize_distributed(device=args.device)
    try:
        return _render_all(args, cfg, make_device_mesh(device=args.device))
    finally:
        if made:
            dist.destroy_process_group()


def _render_all(args, cfg, mesh) -> int:
    """Every camera of ``cfg``: through ``render_camera``, or with a
    ``mesh`` sharded over its ranks, rank 0 alone writing and printing."""
    from advanced_cpu_raytracing_tpu_torch.post.tonemap import (
        reinhard_tonemap,
        reinhard_tonemap_sharded,
    )
    from advanced_cpu_raytracing_tpu_torch.post.writers import write_hdr, write_png
    from advanced_cpu_raytracing_tpu_torch.render.renderer import (
        ldr_from_radiance,
        render_camera,
    )
    from advanced_cpu_raytracing_tpu_torch.parallel.shard_render import (
        render_camera_sharded,
    )
    from advanced_cpu_raytracing_tpu_torch.scene.pack import pack_scene

    lead = mesh is None or mesh.get_local_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    if lead:
        os.makedirs(args.out_dir, exist_ok=True)
    start = time.perf_counter()
    pack = pack_scene(cfg, device=args.device)

    for cam_cfg in cfg.cameras:
        say(f"Resolution: {cam_cfg.width}x{cam_cfg.height}, "
            f"samples: {cam_cfg.num_samples}")
        if cam_cfg.renderer_params.path_tracing:
            say(f"Path tracing is enabled for: {cam_cfg.image_name}")
        if mesh is None:
            img = render_camera(pack, cfg, cam_cfg, seed=args.seed,
                                spp=args.spp, device=args.device,
                                tile_size=args.tile)
        else:
            img = render_camera_sharded(pack, cfg, cam_cfg, mesh=mesh,
                                        seed=args.seed, spp=args.spp,
                                        tile_size=args.tile,
                                        device=args.device)
        base = os.path.join(args.out_dir, cam_cfg.image_name)
        stem = base[: base.rfind(".")] if "." in os.path.basename(base) else base
        if cam_cfg.tonemap is not None:
            tm = cam_cfg.tonemap
            kw = dict(key_value=tm.key_value, burn_percent=tm.burn_percent,
                      saturation=tm.saturation, gamma=tm.gamma,
                      device=args.device)
            ldr = (reinhard_tonemap(img, **kw) if mesh is None
                   else reinhard_tonemap_sharded(img, mesh, **kw))
            if lead:
                write_hdr(base if base.endswith(".hdr") else stem + ".hdr",
                          np.nan_to_num(img))
                write_png(stem + ".png", ldr)
        elif lead:
            write_png(stem + ".png", ldr_from_radiance(img))
        say(f"wrote {stem}.png")

    elapsed = time.perf_counter() - start
    say(f"Rendering took: {elapsed}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
