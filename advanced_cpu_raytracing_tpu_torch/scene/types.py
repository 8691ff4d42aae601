"""Typed host-side scene model produced by the XML parser.

This is the framework's equivalent of the reference's ``Scene`` god-object
(src/scene.h:32-89) — but as plain dataclasses holding numpy data, fully
decoupled from the device-side ``ScenePack`` (scene/pack.py) that the
renderer consumes.  IDs keep the reference's 1-based XML id space; resolution
to dense indices happens at pack time.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class MaterialType(enum.IntEnum):
    # Mirrors src/material.hpp:14-20.
    DEFAULT = 0
    MIRROR = 1
    DIELECTRIC = 2
    CONDUCTOR = 3
    EMISSIVE = 4


class BrdfType(enum.IntEnum):
    # The five pluggable models parsed by parseBRDFs (src/parser.cpp:870-982).
    PHONG = 0
    MODIFIED_PHONG = 1
    BLINN_PHONG = 2
    MODIFIED_BLINN_PHONG = 3
    TORRANCE_SPARROW = 4


class DecalMode(enum.IntEnum):
    # src/texture.h:9-18 plus replace_background (parser.cpp:181-185).
    REPLACE_KD = 0
    BLEND_KD = 1
    REPLACE_KS = 2
    REPLACE_NORMAL = 3
    BUMP_NORMAL = 4
    REPLACE_ALL = 5
    REPLACE_BACKGROUND = 6


DECAL_FROM_STRING = {
    "replace_kd": DecalMode.REPLACE_KD,
    "blend_kd": DecalMode.BLEND_KD,
    "replace_ks": DecalMode.REPLACE_KS,
    "replace_normal": DecalMode.REPLACE_NORMAL,
    "bump_normal": DecalMode.BUMP_NORMAL,
    "replace_all": DecalMode.REPLACE_ALL,
    "replace_background": DecalMode.REPLACE_BACKGROUND,
}


@dataclass
class BrdfCfg:
    id: int
    kind: BrdfType
    exponent: float
    normalized: bool = False  # "normalized" attr (modified variants)
    kd_fresnel: bool = False  # "kdfresnel" attr (TorranceSparrow)


@dataclass
class MaterialCfg:
    # Defaults follow parseMaterials (src/parser.cpp:1109-1278).
    id: int
    type: MaterialType = MaterialType.DEFAULT
    ambient: np.ndarray = field(default_factory=lambda: np.zeros(3))
    diffuse: np.ndarray = field(default_factory=lambda: np.zeros(3))
    specular: np.ndarray = field(default_factory=lambda: np.zeros(3))
    mirror: np.ndarray = field(default_factory=lambda: np.zeros(3))
    phong_exponent: float = 1.0
    refractive_index: float = 1.0
    absorption_coefficient: np.ndarray = field(default_factory=lambda: np.zeros(3))
    conductor_absorption_index: float = 0.0
    roughness: float = 0.0
    radiance: np.ndarray = field(default_factory=lambda: np.zeros(3))
    brdf_id: int | None = None


@dataclass
class PointLightCfg:
    id: int
    position: np.ndarray
    intensity: np.ndarray


@dataclass
class DirectionalLightCfg:
    id: int
    direction: np.ndarray  # normalized at construction (directionalLight.h:20)
    radiance: np.ndarray


@dataclass
class SpotLightCfg:
    id: int
    position: np.ndarray
    direction: np.ndarray  # normalized (spotLight.h:26)
    intensity: np.ndarray
    coverage_angle_deg: float
    falloff_angle_deg: float


@dataclass
class AreaLightCfg:
    id: int
    position: np.ndarray
    normal: np.ndarray  # stored raw, as the reference does (areaLight.h:23)
    radiance: np.ndarray
    extent: float  # "Size"; area = extent^2 (areaLight.h:26)


@dataclass
class EnvironmentLightCfg:
    id: int
    image_id: int  # SphericalDirectionalLight ImageId (parser.cpp:243-245)


@dataclass
class ImageCfg:
    id: int
    path: str
    is_hdr: bool  # .exr -> HDR float data (parser.cpp:103-111)
    data: np.ndarray | None = None  # (H, W, 3) float32; LDR kept in 0..255


@dataclass
class TextureCfg:
    id: int
    kind: str  # "image" | "perlin"
    decal: DecalMode
    # image-texture params (parser.cpp:139-186)
    image_id: int | None = None
    interpolation: str = "nearest"  # parser default (parser.cpp:147)
    normalizer: float = 255.0
    bump_factor: float = 1.0
    # perlin params (parser.cpp:187-219)
    noise_scale: float = 1.0
    noise_conversion: str = "linear"


@dataclass
class TonemapCfg:
    # Defaults per parseTonemapper (src/parser.cpp:828-869).
    operator: str = "Photographic"
    key_value: float = 0.18
    burn_percent: float = 1.0
    saturation: float = 1.0
    gamma: float = 2.2


@dataclass
class RendererParamsCfg:
    # src/rendererParams.h:6-26, parsed at parser.cpp:1589-1628.
    path_tracing: bool = False
    importance_sampling: bool = False
    next_event_estimation: bool = False
    russian_roulette: bool = False


@dataclass
class CameraCfg:
    id: int
    position: np.ndarray
    up: np.ndarray
    near_distance: float
    width: int
    height: int
    image_name: str
    # lookAt mode (camera.cpp:25-48)
    is_look_at: bool = False
    gaze_point: np.ndarray | None = None  # GazePoint (or Gaze used as a point)
    fov_y_deg: float | None = None
    # near-plane mode (camera.cpp:5-24)
    gaze_dir: np.ndarray | None = None
    near_plane: np.ndarray | None = None  # l, r, b, t
    num_samples: int = 1
    focus_distance: float = 0.0
    aperture_size: float = 0.0
    renderer_params: RendererParamsCfg = field(default_factory=RendererParamsCfg)
    tonemap: TonemapCfg | None = None


@dataclass
class MeshCfg:
    """A triangle mesh object (Mesh / LightMesh / Triangle all lower to this).

    Vertices are either shared scene vertex_data (inline Faces, 1-based ids +
    vertexOffset, src/parser.cpp:1380-1390) or private PLY data; the parser
    resolves everything to private 0-based arrays here.
    """

    id: int
    material_id: int
    vertices: np.ndarray  # (V, 3) float
    faces: np.ndarray  # (F, 3) int, 0-based into `vertices`
    uv_indices: np.ndarray | None  # (F, 3) int into `uvs`, or None
    uvs: np.ndarray | None  # (U, 2) float
    transform_ops: list = field(default_factory=list)  # [('t'|'s'|'r', payload)]
    motion_blur: np.ndarray | None = None  # (3,) velocity or None
    textures: list[int] = field(default_factory=list)  # texture ids
    is_light: bool = False
    radiance: np.ndarray | None = None  # LightMesh Radiance (parser.cpp:1303-1308)


@dataclass
class MeshInstanceCfg:
    id: int
    base_mesh_id: int  # may point at another instance; resolved at parse
    reset_transform: bool = False
    material_id: int | None = None  # None -> inherit base (parser.cpp:400-410)
    transform_ops: list = field(default_factory=list)
    motion_blur: np.ndarray | None = None
    textures: list[int] = field(default_factory=list)


@dataclass
class SphereCfg:
    id: int
    material_id: int
    center: np.ndarray  # resolved from center vertex id (sphere.hpp:14-17)
    radius: float
    transform_ops: list = field(default_factory=list)
    motion_blur: np.ndarray | None = None
    textures: list[int] = field(default_factory=list)


@dataclass
class SceneConfig:
    """Parsed scene — the framework's config system (SURVEY.md section 5)."""

    background_color: np.ndarray = field(default_factory=lambda: np.zeros(3))
    shadow_ray_epsilon: float = 1e-3  # scene.cpp:4 default
    intersection_test_epsilon: float = 1e-6  # parsed but unused in reference
    max_recursion_depth: int = 0  # parser.cpp:64 default
    ambient_light: np.ndarray = field(default_factory=lambda: np.zeros(3))
    cameras: list[CameraCfg] = field(default_factory=list)
    point_lights: list[PointLightCfg] = field(default_factory=list)
    directional_lights: list[DirectionalLightCfg] = field(default_factory=list)
    spot_lights: list[SpotLightCfg] = field(default_factory=list)
    area_lights: list[AreaLightCfg] = field(default_factory=list)
    environment_lights: list[EnvironmentLightCfg] = field(default_factory=list)
    brdfs: list[BrdfCfg] = field(default_factory=list)
    materials: list[MaterialCfg] = field(default_factory=list)
    images: list[ImageCfg] = field(default_factory=list)
    textures: list[TextureCfg] = field(default_factory=list)
    background_texture_id: int | None = None
    meshes: list[MeshCfg] = field(default_factory=list)
    instances: list[MeshInstanceCfg] = field(default_factory=list)
    spheres: list[SphereCfg] = field(default_factory=list)

    def material_by_id(self, mid: int) -> MaterialCfg:
        for m in self.materials:
            if m.id == mid:
                return m
        raise KeyError(f"material id {mid} not found")
