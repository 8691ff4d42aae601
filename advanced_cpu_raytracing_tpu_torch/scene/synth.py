"""Synthetic scene generators for scale testing (the port's copy of the
JAX package's ``scene/synth.py``, numpy only).

The reference ships no scene above ~78k faces (ton_Roosendaal), yet its
per-mesh BVH handles any face count (src/mesh.cpp:23-156).  These builders
produce arbitrarily large geometry, so the megakernel's tree over the work
items (past ``ops/megakernel.py::FLAT_MAX_FACES``) can be exercised and
measured.
"""

from __future__ import annotations

import numpy as np

from advanced_cpu_raytracing_tpu_torch.scene.types import (
    CameraCfg,
    DecalMode,
    ImageCfg,
    MaterialCfg,
    MeshCfg,
    PointLightCfg,
    SceneConfig,
    TextureCfg,
)


def terrain_scene(n: int = 513, width: int = 640, height: int = 480,
                  seed: int = 0, max_depth: int = 1,
                  textured: bool = False) -> SceneConfig:
    """A rolling heightfield of 2*(n-1)^2 triangles under one point light.

    n = 513 -> 524,288 faces (past the 98,304 faces of the flat chunk
    sweep); the height function is a fixed sum of sines, so scenes are
    reproducible across hosts without RNG.  ``textured`` drapes a
    procedural 96x96 bilinear replace_kd image over the whole field."""
    xs = np.linspace(-8.0, 8.0, n, dtype=np.float64)
    zs = np.linspace(-16.0, 0.0, n, dtype=np.float64)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    h = (0.35 * np.sin(1.7 * gx + 0.5) * np.cos(1.3 * gz)
         + 0.2 * np.sin(3.1 * gx - 2.0 * gz)
         + 0.1 * np.sin(7.3 * gz + 2.2))
    verts = np.stack([gx, h, gz], axis=-1).reshape(-1, 3).astype(np.float32)

    idx = np.arange(n * n, dtype=np.int32).reshape(n, n)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[1:, :-1].reshape(-1)
    c = idx[1:, 1:].reshape(-1)
    d = idx[:-1, 1:].reshape(-1)
    faces = np.concatenate([
        np.stack([a, b, c], axis=-1),
        np.stack([a, c, d], axis=-1),
    ]).astype(np.int32)

    cfg = SceneConfig(
        background_color=np.array([20.0, 24.0, 40.0]),
        max_recursion_depth=max_depth,
        ambient_light=np.array([20.0, 20.0, 20.0]),
    )
    cfg.materials.append(MaterialCfg(
        id=1,
        ambient=np.array([1.0, 1.0, 1.0]),
        diffuse=np.array([0.55, 0.6, 0.45]),
        specular=np.array([0.2, 0.2, 0.2]),
        phong_exponent=15.0,
    ))
    cfg.point_lights.append(PointLightCfg(
        id=1, position=np.array([4.0, 9.0, -4.0]),
        intensity=np.array([1800.0, 1750.0, 1650.0])))
    cfg.cameras.append(CameraCfg(
        id=1, position=np.array([0.0, 3.2, 2.5]),
        up=np.array([0.0, 1.0, 0.0]), near_distance=1.0,
        width=width, height=height, image_name="terrain.png",
        gaze_dir=np.array([0.0, -0.45, -1.0]),
        near_plane=np.array([-1.0, 1.0, -0.75, 0.75]),
    ))
    if textured:
        # per-vertex UVs span [0, 1] over the field; tiled 6x in the
        # texture sampler via coordinates > 1 (mesh.cpp:382-389 tiling)
        u = ((gx - gx.min()) / (gx.max() - gx.min()) * 6.0)
        v = ((gz - gz.min()) / (gz.max() - gz.min()) * 6.0)
        uvs = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)
        ty, tx = np.mgrid[0:96, 0:96] / 96.0
        tex = np.stack([
            90 + 120 * np.sin(12.0 * tx) * np.cos(9.0 * ty),
            110 + 80 * ((np.floor(tx * 8) + np.floor(ty * 8)) % 2),
            60 + 150 * ty,
        ], axis=-1).clip(0, 255).astype(np.float32)
        cfg.images.append(ImageCfg(id=1, path="<synthetic>", is_hdr=False,
                                   data=tex))
        cfg.textures.append(TextureCfg(
            id=1, kind="image", decal=DecalMode.REPLACE_KD, image_id=1,
            interpolation="bilinear"))
        cfg.meshes.append(MeshCfg(
            id=1, material_id=1, vertices=verts, faces=faces,
            uv_indices=faces, uvs=uvs, textures=[1],
        ))
    else:
        cfg.meshes.append(MeshCfg(
            id=1, material_id=1, vertices=verts, faces=faces,
            uv_indices=None, uvs=None,
        ))
    return cfg
