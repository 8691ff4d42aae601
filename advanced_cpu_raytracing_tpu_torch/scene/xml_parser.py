"""XML scene parser — the framework's config system.

Implements the full schema of the reference's ``Scene::loadFromXml``
(src/parser.cpp:26-577 and helpers) using stdlib ``xml.etree``; produces a
:class:`~advanced_cpu_raytracing_tpu_torch.scene.types.SceneConfig` of host numpy
data.  Behavioural notes carried over deliberately:

  - BRDFs are parsed before materials (materials reference BRDF ids,
    parser.cpp:78-82).
  - The parser's ``Material`` is a loop-local that is **reused** between
    <Material> elements (parser.cpp:1115), so Ambient/Diffuse/Specular and the
    BRDF pointer carry over to the next material when its tags are omitted;
    fields with explicit else-branches (mirror, ior, absorption, phong,
    roughness, type) reset.  We replicate that carry-over.
  - ``degamma="true"`` raises ambient/diffuse/specular/mirror to the 2.2 power
    (parser.cpp:1154-1216).
  - LightMesh marks its material Emissive and stores radiance on it
    (parser.cpp:1484-1488).
  - Triangles lower to 1-face meshes; spheres resolve their center vertex id
    against shared VertexData (parser.cpp:458-574).
  - Transform strings ("s1 r2 t1") apply left-to-right (parser.cpp:651-723);
    ids here may be multi-digit (the reference assumes single digits).
  - Texture image paths resolve against the scene directory, then
    ``<scene dir>/inputs/`` (the reference hardcodes an ``inputs/`` prefix
    relative to CWD, parser.cpp:107-110), then CWD.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from advanced_cpu_raytracing_tpu_torch.scene import ply
from advanced_cpu_raytracing_tpu_torch.scene.images import load_image
from advanced_cpu_raytracing_tpu_torch.scene.types import (
    AreaLightCfg,
    BrdfCfg,
    BrdfType,
    CameraCfg,
    DECAL_FROM_STRING,
    DirectionalLightCfg,
    EnvironmentLightCfg,
    ImageCfg,
    MaterialCfg,
    MaterialType,
    MeshCfg,
    MeshInstanceCfg,
    PointLightCfg,
    RendererParamsCfg,
    SceneConfig,
    SphereCfg,
    SpotLightCfg,
    TextureCfg,
    TonemapCfg,
)


def _floats(text: str) -> np.ndarray:
    return np.array([float(t) for t in text.split()], dtype=np.float64)


def _vec3(elem, tag, default=None):
    child = elem.find(tag)
    if child is None:
        return None if default is None else np.asarray(default, np.float64)
    return _floats(child.text)[:3]


def _scalar(elem, tag, default=None, cast=float):
    child = elem.find(tag)
    if child is None:
        return default
    return cast(child.text.split()[0])


def _parse_transform_ops(text: str, translations, scalings, rotations) -> list:
    """Tokenize "s1 r2 t3" into [('s', payload), ...] in application order."""
    ops = []
    for token in text.split():
        kind, idx = token[0], int(token[1:])
        if kind == "t":
            ops.append(("t", tuple(translations[idx - 1])))
        elif kind == "s":
            ops.append(("s", tuple(scalings[idx - 1])))
        elif kind == "r":
            angle, axis = rotations[idx - 1]
            ops.append(("r", (angle, tuple(axis))))
        else:
            raise ValueError(f"unknown transform token {token!r}")
    return ops


def _resolve_path(name: str, scene_dir: str) -> str:
    candidates = [
        os.path.join(scene_dir, name),
        os.path.join(scene_dir, "inputs", name),
        name,
        os.path.join("inputs", name),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return candidates[0]  # let downstream raise a sensible error


def load_scene(path: str) -> SceneConfig:
    scene_dir = os.path.dirname(os.path.abspath(path))
    tree = ET.parse(path)
    root = tree.getroot()
    cfg = SceneConfig()

    bg = root.find("BackgroundColor")
    if bg is not None:
        cfg.background_color = _floats(bg.text)[:3]
    eps = root.find("ShadowRayEpsilon")
    if eps is not None:
        cfg.shadow_ray_epsilon = float(eps.text)
    ieps = root.find("IntersectionTestEpsilon")
    if ieps is not None:
        cfg.intersection_test_epsilon = float(ieps.text)
    mrd = root.find("MaxRecursionDepth")
    if mrd is not None:
        cfg.max_recursion_depth = int(float(mrd.text))

    _parse_cameras(root, cfg)
    _parse_lights(root, cfg)
    _parse_brdfs(root, cfg)
    _parse_materials(root, cfg)
    _parse_textures(root, cfg, scene_dir)
    _parse_env_lights(root, cfg)

    vertex_data = np.zeros((0, 3))
    vd = root.find("VertexData")
    if vd is not None:
        flat = _floats(vd.text)
        vertex_data = flat.reshape(-1, 3)
    tex_coords = np.zeros((0, 2))
    tc = root.find("TexCoordData")
    if tc is not None and tc.text and tc.text.strip():
        tex_coords = _floats(tc.text).reshape(-1, 2)

    translations, scalings, rotations = [], [], []
    tr = root.find("Transformations")
    if tr is not None:
        for t in tr.findall("Translation"):
            translations.append(_floats(t.text)[:3])
        for s in tr.findall("Scaling"):
            scalings.append(_floats(s.text)[:3])
        for r in tr.findall("Rotation"):
            vals = _floats(r.text)  # angle x y z (parser.cpp:336-338)
            rotations.append((float(vals[0]), vals[1:4]))

    objects = root.find("Objects")
    if objects is not None:
        _parse_meshes(objects, cfg, vertex_data, tex_coords, scene_dir,
                      translations, scalings, rotations, "Mesh")
        _parse_meshes(objects, cfg, vertex_data, tex_coords, scene_dir,
                      translations, scalings, rotations, "LightMesh")
        _parse_instances(objects, cfg, translations, scalings, rotations)
        _parse_triangles(objects, cfg, vertex_data, tex_coords,
                         translations, scalings, rotations)
        _parse_spheres(objects, cfg, vertex_data,
                       translations, scalings, rotations)
    return cfg


def _parse_cameras(root, cfg: SceneConfig) -> None:
    cameras = root.find("Cameras")
    if cameras is None:
        return
    for elem in cameras.findall("Camera"):
        cam_id = int(elem.get("id", "0"))
        is_look_at = elem.get("type") == "lookAt"
        pos = _vec3(elem, "Position")
        up = _vec3(elem, "Up")
        near_dist = _scalar(elem, "NearDistance", 1.0)
        res = elem.find("ImageResolution").text.split()
        width, height = int(float(res[0])), int(float(res[1]))
        image_name = elem.find("ImageName").text.strip()

        cam = CameraCfg(
            id=cam_id, position=pos, up=up, near_distance=near_dist,
            width=width, height=height, image_name=image_name,
            is_look_at=is_look_at,
        )
        if is_look_at:
            # GazePoint falls back to Gaze used as a *point* (parser.cpp:1537-1540)
            gp = _vec3(elem, "GazePoint")
            if gp is None:
                gp = _vec3(elem, "Gaze")
            cam.gaze_point = gp
            cam.fov_y_deg = _scalar(elem, "FovY", 45.0)
        else:
            cam.gaze_dir = _vec3(elem, "Gaze")
            np_elem = elem.find("NearPlane")
            cam.near_plane = _floats(np_elem.text)[:4]  # l r b t

        cam.num_samples = _scalar(elem, "NumSamples", 1, cast=lambda s: int(float(s)))
        cam.focus_distance = _scalar(elem, "FocusDistance", 0.0)
        cam.aperture_size = _scalar(elem, "ApertureSize", 0.0)

        renderer = elem.find("Renderer")
        if renderer is not None and renderer.text.strip() == "PathTracing":
            params = RendererParamsCfg(path_tracing=True)
            rp = elem.find("RendererParams")
            if rp is not None and rp.text:
                words = rp.text.split()
                params.next_event_estimation = "NextEventEstimation" in words
                params.russian_roulette = "RussianRoulette" in words
                params.importance_sampling = "ImportanceSampling" in words
            cam.renderer_params = params

        tm = elem.find("Tonemap")
        if tm is not None:
            tcfg = TonemapCfg()
            op = tm.find("TMO")
            if op is not None:
                tcfg.operator = op.text.strip()
            opts = tm.find("TMOOptions")
            if opts is not None:
                vals = opts.text.split()
                tcfg.key_value, tcfg.burn_percent = float(vals[0]), float(vals[1])
            tcfg.saturation = _scalar(tm, "Saturation", 1.0)
            tcfg.gamma = _scalar(tm, "Gamma", 2.2)
            cam.tonemap = tcfg

        cfg.cameras.append(cam)


def _parse_lights(root, cfg: SceneConfig) -> None:
    lights = root.find("Lights")
    if lights is None:
        return
    amb = lights.find("AmbientLight")
    if amb is not None:
        cfg.ambient_light = _floats(amb.text)[:3]
    for l in lights.findall("PointLight"):
        cfg.point_lights.append(PointLightCfg(
            id=int(l.get("id", "0")),
            position=_vec3(l, "Position"),
            intensity=_vec3(l, "Intensity"),
        ))
    for l in lights.findall("AreaLight"):
        cfg.area_lights.append(AreaLightCfg(
            id=int(l.get("id", "0")),
            position=_vec3(l, "Position"),
            normal=_vec3(l, "Normal"),
            radiance=_vec3(l, "Radiance"),
            extent=_scalar(l, "Size", 1.0),
        ))
    for l in lights.findall("DirectionalLight"):
        d = _vec3(l, "Direction")
        cfg.directional_lights.append(DirectionalLightCfg(
            id=int(l.get("id", "0")),
            direction=d / np.linalg.norm(d),
            radiance=_vec3(l, "Radiance"),
        ))
    for l in lights.findall("SpotLight"):
        d = _vec3(l, "Direction")
        cfg.spot_lights.append(SpotLightCfg(
            id=int(l.get("id", "0")),
            position=_vec3(l, "Position"),
            direction=d / np.linalg.norm(d),
            intensity=_vec3(l, "Intensity"),
            coverage_angle_deg=_scalar(l, "CoverageAngle", 0.0),
            falloff_angle_deg=_scalar(l, "FalloffAngle", 0.0),
        ))


def _parse_env_lights(root, cfg: SceneConfig) -> None:
    lights = root.find("Lights")
    if lights is None:
        return
    for l in lights.findall("SphericalDirectionalLight"):
        cfg.environment_lights.append(EnvironmentLightCfg(
            id=int(l.get("id", "0")),
            image_id=_scalar(l, "ImageId", -1, cast=int),
        ))


_BRDF_TAGS = [
    ("ModifiedBlinnPhong", BrdfType.MODIFIED_BLINN_PHONG),
    ("OriginalBlinnPhong", BrdfType.BLINN_PHONG),
    ("OriginalPhong", BrdfType.PHONG),
    ("ModifiedPhong", BrdfType.MODIFIED_PHONG),
    ("TorranceSparrow", BrdfType.TORRANCE_SPARROW),
]


def _parse_brdfs(root, cfg: SceneConfig) -> None:
    brdfs = root.find("BRDFs")
    if brdfs is None:
        return
    for tag, kind in _BRDF_TAGS:
        for elem in brdfs.findall(tag):
            cfg.brdfs.append(BrdfCfg(
                id=int(elem.get("id", "-1")),
                kind=kind,
                exponent=_scalar(elem, "Exponent", 0.0),
                normalized=elem.get("normalized") == "true",
                kd_fresnel=elem.get("kdfresnel") == "true",
            ))


def _parse_materials(root, cfg: SceneConfig) -> None:
    materials = root.find("Materials")
    if materials is None:
        return
    # Carried-over fields mirror the reused loop variable (parser.cpp:1115).
    carry_ambient = np.zeros(3)
    carry_diffuse = np.zeros(3)
    carry_specular = np.zeros(3)
    carry_brdf: int | None = None
    for elem in materials.findall("Material"):
        mat = MaterialCfg(id=int(elem.get("id", "-1")))

        if elem.get("BRDF") is not None:
            carry_brdf = int(elem.get("BRDF"))
        mat.brdf_id = carry_brdf

        mtype = elem.get("type")
        mat.type = {
            "mirror": MaterialType.MIRROR,
            "dielectric": MaterialType.DIELECTRIC,
            "conductor": MaterialType.CONDUCTOR,
        }.get(mtype, MaterialType.DEFAULT)

        degamma = elem.get("degamma") == "true"
        gamma = 2.2

        def color(tag, carry):
            child = elem.find(tag)
            if child is None:
                return carry
            v = _floats(child.text)[:3]
            return np.power(v, gamma) if degamma else v

        carry_ambient = color("AmbientReflectance", carry_ambient)
        carry_diffuse = color("DiffuseReflectance", carry_diffuse)
        carry_specular = color("SpecularReflectance", carry_specular)
        mat.ambient = carry_ambient.copy()
        mat.diffuse = carry_diffuse.copy()
        mat.specular = carry_specular.copy()

        mirror = elem.find("MirrorReflectance")
        if mirror is not None:
            v = _floats(mirror.text)[:3]
            mat.mirror = np.power(v, gamma) if degamma else v
        mat.refractive_index = _scalar(elem, "RefractionIndex", 1.0)
        ab = elem.find("AbsorptionCoefficient")
        if ab is not None:
            mat.absorption_coefficient = _floats(ab.text)[:3]
        mat.conductor_absorption_index = _scalar(elem, "AbsorptionIndex", 0.0)
        mat.phong_exponent = _scalar(elem, "PhongExponent", 1.0)
        mat.roughness = _scalar(elem, "Roughness", 0.0)
        cfg.materials.append(mat)


def _parse_textures(root, cfg: SceneConfig, scene_dir: str) -> None:
    textures = root.find("Textures")
    if textures is None:
        return
    images = textures.find("Images")
    if images is not None:
        for elem in images.findall("Image"):
            name = elem.text.strip()
            path = _resolve_path(name, scene_dir)
            data, is_hdr = load_image(path)
            cfg.images.append(ImageCfg(
                id=int(elem.get("id", "0")), path=path, is_hdr=is_hdr, data=data,
            ))
    for elem in textures.findall("TextureMap"):
        tex_id = int(elem.get("id", "0"))
        tex_type = elem.get("type", "image")
        decal_str = elem.find("DecalMode").text.strip()
        decal = DECAL_FROM_STRING[decal_str]
        if tex_type == "image":
            tex = TextureCfg(
                id=tex_id, kind="image", decal=decal,
                image_id=_scalar(elem, "ImageId", -1, cast=int),
                interpolation=(elem.findtext("Interpolation") or "nearest").strip(),
                normalizer=_scalar(elem, "Normalizer", 255.0),
                bump_factor=_scalar(elem, "BumpFactor", 1.0),
            )
        elif tex_type == "perlin":
            tex = TextureCfg(
                id=tex_id, kind="perlin", decal=decal,
                noise_scale=_scalar(elem, "NoiseScale", 1.0),
                noise_conversion=(elem.findtext("NoiseConversion") or "linear").strip(),
                bump_factor=_scalar(elem, "BumpFactor", 1.0),
            )
        else:
            # checkerboard is unimplemented in the reference too
            # (parser.cpp:220-224)
            continue
        cfg.textures.append(tex)
        if decal == DECAL_FROM_STRING["replace_background"]:
            cfg.background_texture_id = tex_id


def _tex_ids(elem) -> list[int]:
    child = elem.find("Textures")
    if child is None or not child.text:
        return []
    return [int(t) for t in child.text.split()]


def _motion(elem):
    child = elem.find("MotionBlur")
    if child is None:
        return None
    return _floats(child.text)[:3]


def _transform_ops(elem, translations, scalings, rotations):
    child = elem.find("Transformations")
    if child is None or not child.text:
        return []
    return _parse_transform_ops(child.text, translations, scalings, rotations)


def _parse_meshes(objects, cfg, vertex_data, tex_coords, scene_dir,
                  translations, scalings, rotations, tag: str) -> None:
    for elem in objects.findall(tag):
        is_light = tag == "LightMesh"
        mesh_id = int(elem.get("id", "0"))
        mat_id = int(elem.find("Material").text)
        faces_elem = elem.find("Faces")
        ply_file = faces_elem.get("plyFile")

        if ply_file is not None:
            ply_path = _resolve_path(ply_file, scene_dir)
            verts, tris = ply.load_ply(ply_path)
            uvs, uv_idx = None, None
        else:
            v_off = int(faces_elem.get("vertexOffset", "0"))
            t_off = int(faces_elem.get("textureOffset", "0"))
            idx = np.array([int(t) for t in faces_elem.text.split()],
                           dtype=np.int64).reshape(-1, 3)
            # 1-based + vertexOffset (src/mesh.cpp:16-21)
            tris = (idx - 1 + v_off).astype(np.int32)
            verts = vertex_data.astype(np.float32)
            if len(tex_coords):
                uvs = tex_coords.astype(np.float32)
                uv_idx = (idx - 1 + t_off).astype(np.int32)
            else:
                uvs, uv_idx = None, None

        radiance = None
        if is_light:
            radiance = _vec3(elem, "Radiance", default=np.zeros(3))
            # LightMesh marks its material emissive (parser.cpp:1484-1488)
            mat = cfg.material_by_id(mat_id)
            mat.type = MaterialType.EMISSIVE
            mat.radiance = radiance

        cfg.meshes.append(MeshCfg(
            id=mesh_id, material_id=mat_id, vertices=verts, faces=tris,
            uv_indices=uv_idx, uvs=uvs,
            transform_ops=_transform_ops(elem, translations, scalings, rotations),
            motion_blur=_motion(elem),
            textures=_tex_ids(elem),
            is_light=is_light, radiance=radiance,
        ))


def _parse_instances(objects, cfg, translations, scalings, rotations) -> None:
    for elem in objects.findall("MeshInstance"):
        mat_elem = elem.find("Material")
        cfg.instances.append(MeshInstanceCfg(
            id=int(elem.get("id", "0")),
            base_mesh_id=int(elem.get("baseMeshId")),
            reset_transform=elem.get("resetTransform") == "true",
            material_id=int(mat_elem.text) if mat_elem is not None else None,
            transform_ops=_transform_ops(elem, translations, scalings, rotations),
            motion_blur=_motion(elem),
            textures=_tex_ids(elem),
        ))


def _parse_triangles(objects, cfg, vertex_data, tex_coords,
                     translations, scalings, rotations) -> None:
    for elem in objects.findall("Triangle"):
        idx = np.array([int(t) for t in elem.find("Indices").text.split()],
                       dtype=np.int64).reshape(1, 3)
        tris = (idx - 1).astype(np.int32)
        if len(tex_coords):
            uvs, uv_idx = tex_coords.astype(np.float32), tris.copy()
        else:
            uvs, uv_idx = None, None
        cfg.meshes.append(MeshCfg(
            id=int(elem.get("id", "0")),
            material_id=int(elem.find("Material").text),
            vertices=vertex_data.astype(np.float32),
            faces=tris, uv_indices=uv_idx, uvs=uvs,
            transform_ops=_transform_ops(elem, translations, scalings, rotations),
            motion_blur=None,
            textures=_tex_ids(elem),
        ))


def _parse_spheres(objects, cfg, vertex_data,
                   translations, scalings, rotations) -> None:
    for elem in objects.findall("Sphere"):
        center_vid = int(elem.find("Center").text)
        cfg.spheres.append(SphereCfg(
            id=int(elem.get("id", "0")),
            material_id=int(elem.find("Material").text),
            center=vertex_data[center_vid - 1].astype(np.float64),
            radius=_scalar(elem, "Radius", 1.0),
            transform_ops=_transform_ops(elem, translations, scalings, rotations),
            motion_blur=_motion(elem),
            textures=_tex_ids(elem),
        ))
