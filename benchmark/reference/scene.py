"""The plain reference's own reader of the benchmark's scenes.

It reads the subset of DorkTracer's XML schema that the configurations use
(a camera with a near plane, ambient, point and directional lights, the
default, mirror, dielectric and conductor materials, triangle meshes with
inline faces or a binary little-endian PLY file, and spheres) and raises on
any other element, so that a configuration it cannot read in full is never
compared in part.  The defaults are the schema's (parser.cpp:1109-1278).
It shares no code with the program: every table the reference traces is
worked out here from the raw files.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

MAT_DEFAULT, MAT_MIRROR, MAT_DIELECTRIC, MAT_CONDUCTOR = 0, 1, 2, 3
_MAT_TYPES = {None: MAT_DEFAULT, "": MAT_DEFAULT, "mirror": MAT_MIRROR,
              "dielectric": MAT_DIELECTRIC, "conductor": MAT_CONDUCTOR}
_KNOWN = {"MaxRecursionDepth", "BackgroundColor", "ShadowRayEpsilon",
          "Cameras", "Lights", "Materials", "VertexData", "Objects"}


@dataclass
class Camera:
    position: np.ndarray
    gaze: np.ndarray
    up: np.ndarray
    near_plane: np.ndarray  # l r b t
    near_distance: float
    width: int
    height: int
    num_samples: int


@dataclass
class Scene:
    """Everything the Whitted trace and its differentiable chain read.

    ``verts`` (V, 3) holds each mesh's vertex list in file order (a mesh
    with inline faces has its own copy of the VertexData), ``faces`` (F, 3)
    index it, ``face_mat`` (F,) is each face's material row; materials,
    point lights and spheres are rows in file order."""

    camera: Camera
    max_depth: int
    bg: np.ndarray
    eps: float
    ambient: np.ndarray
    pl_pos: np.ndarray  # (P, 3)
    pl_intensity: np.ndarray  # (P, 3)
    dl_dir: np.ndarray  # (D, 3) as written: from the light
    dl_radiance: np.ndarray  # (D, 3)
    mat_type: np.ndarray  # (M,) int
    mat_ambient: np.ndarray  # (M, 3)
    mat_diffuse: np.ndarray
    mat_specular: np.ndarray
    mat_mirror: np.ndarray
    mat_phong: np.ndarray  # (M,)
    mat_ior: np.ndarray  # (M,)
    mat_k: np.ndarray  # (M,) conductor absorption index
    mat_absorb: np.ndarray  # (M, 3)
    verts: np.ndarray  # (V, 3) f32
    faces: np.ndarray  # (F, 3) int64
    face_mat: np.ndarray  # (F,) int64
    sph_center: np.ndarray  # (S, 3)
    sph_radius: np.ndarray  # (S,)
    sph_mat: np.ndarray  # (S,) int64
    mesh_spans: list = field(default_factory=list)  # (first face, count)


def _floats(text: str) -> np.ndarray:
    return np.asarray([float(x) for x in text.split()], np.float64)


def _child(el, tag, default=None):
    c = el.find(tag)
    return default if c is None else c.text


def read_ply(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) f32, faces (F, 3) int64) of a binary little-endian
    PLY with float x y z vertices and uchar-counted int triangle lists."""
    blob = path.read_bytes()
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: not a binary little-endian PLY")
    n_v = n_f = None
    for ln in header:
        if ln.startswith("element vertex "):
            n_v = int(ln.split()[-1])
        elif ln.startswith("element face "):
            n_f = int(ln.split()[-1])
    expect = ["property float x", "property float y", "property float z",
              "property list uchar int vertex_indices"]
    if [ln for ln in header if ln.startswith("property")] != expect:
        raise ValueError(f"{path}: unexpected PLY properties")
    verts = np.frombuffer(blob, "<f4", 3 * n_v, end).reshape(n_v, 3)
    rec = np.dtype([("n", "u1"), ("i", "<i4", 3)])
    faces = np.frombuffer(blob, rec, n_f, end + 12 * n_v)
    if not (faces["n"] == 3).all():
        raise ValueError(f"{path}: a face is not a triangle")
    return verts.astype(np.float32), faces["i"].astype(np.int64)


def load(path) -> Scene:
    path = Path(path)
    root = ET.parse(path).getroot()
    unknown = {c.tag for c in root} - _KNOWN
    if unknown:
        raise ValueError(f"{path}: the reference reads no {sorted(unknown)}")
    cams = root.find("Cameras").findall("Camera")
    if len(cams) != 1:
        raise ValueError(f"{path}: one camera expected")
    c = cams[0]
    if c.get("type") or c.find("GazePoint") is not None \
            or c.find("ApertureSize") is not None:
        raise ValueError(f"{path}: only a near-plane camera without a lens")
    res = _floats(c.find("ImageResolution").text).astype(int)
    camera = Camera(_floats(_child(c, "Position")), _floats(_child(c, "Gaze")),
                    _floats(_child(c, "Up")), _floats(_child(c, "NearPlane")),
                    float(_child(c, "NearDistance")), int(res[0]), int(res[1]),
                    int(float(_child(c, "NumSamples", "1"))))

    lights = root.find("Lights")
    ambient, pls, dls = np.zeros(3), [], []
    for el in lights:
        if el.tag == "AmbientLight":
            ambient = _floats(el.text)
        elif el.tag == "PointLight":
            pls.append((_floats(_child(el, "Position")),
                        _floats(_child(el, "Intensity"))))
        elif el.tag == "DirectionalLight":
            dls.append((_floats(_child(el, "Direction")),
                        _floats(_child(el, "Radiance"))))
        else:
            raise ValueError(f"{path}: the reference reads no {el.tag}")

    mats, mat_row = [], {}
    for el in root.find("Materials"):
        known = {"AmbientReflectance", "DiffuseReflectance",
                 "SpecularReflectance", "MirrorReflectance", "PhongExponent",
                 "RefractionIndex", "AbsorptionCoefficient", "AbsorptionIndex"}
        extra = {x.tag for x in el} - known
        if extra or el.get("type") not in _MAT_TYPES:
            raise ValueError(f"{path}: material {el.get('id')}: {extra}")
        mat_row[el.get("id")] = len(mats)

        def vec(tag, el=el):
            return _floats(_child(el, tag, "0 0 0"))

        mats.append(dict(
            type=_MAT_TYPES[el.get("type")], amb=vec("AmbientReflectance"),
            kd=vec("DiffuseReflectance"), ks=vec("SpecularReflectance"),
            mirror=vec("MirrorReflectance"),
            phong=float(_child(el, "PhongExponent", "1")),
            ior=float(_child(el, "RefractionIndex", "1")),
            k=float(_child(el, "AbsorptionIndex", "0")),
            absorb=vec("AbsorptionCoefficient")))

    vertex_data = _floats(root.find("VertexData").text).reshape(-1, 3)
    verts, faces, face_mat, spans = [], [], [], []
    n_v = 0
    sph = []
    for el in root.find("Objects"):
        if el.tag == "Mesh":
            extra = {x.tag for x in el} - {"Material", "Faces"}
            f_el = el.find("Faces")
            if extra or f_el.get("vertexOffset") or f_el.get("textureOffset"):
                raise ValueError(f"{path}: mesh {el.get('id')}: {extra}")
            if f_el.get("plyFile"):
                v, f = read_ply(path.parent / f_el.get("plyFile"))
            else:
                v = vertex_data.astype(np.float32)
                f = _floats(f_el.text).astype(np.int64).reshape(-1, 3) - 1
            spans.append((sum(len(x) for x in faces), len(f)))
            verts.append(v)
            faces.append(f + n_v)
            face_mat.append(np.full(len(f), mat_row[_child(el, "Material")]))
            n_v += len(v)
        elif el.tag == "Sphere":
            extra = {x.tag for x in el} - {"Material", "Center", "Radius"}
            if extra:
                raise ValueError(f"{path}: sphere {el.get('id')}: {extra}")
            sph.append((vertex_data[int(_child(el, "Center")) - 1],
                        float(_child(el, "Radius")),
                        mat_row[_child(el, "Material")]))
        else:
            raise ValueError(f"{path}: the reference reads no {el.tag}")

    def col(key):
        return np.asarray([m[key] for m in mats], np.float32)

    return Scene(
        camera=camera,
        max_depth=int(float(_child(root, "MaxRecursionDepth", "0"))),
        bg=_floats(_child(root, "BackgroundColor", "0 0 0")).astype(np.float32),
        eps=float(_child(root, "ShadowRayEpsilon", "1e-3")),
        ambient=ambient.astype(np.float32),
        pl_pos=np.asarray([p for p, _ in pls], np.float32).reshape(-1, 3),
        pl_intensity=np.asarray([i for _, i in pls], np.float32).reshape(-1, 3),
        dl_dir=np.asarray([d for d, _ in dls], np.float64).reshape(-1, 3),
        dl_radiance=np.asarray([r for _, r in dls], np.float32).reshape(-1, 3),
        mat_type=np.asarray([m["type"] for m in mats], np.int64),
        mat_ambient=col("amb"), mat_diffuse=col("kd"), mat_specular=col("ks"),
        mat_mirror=col("mirror"), mat_phong=col("phong"), mat_ior=col("ior"),
        mat_k=col("k"), mat_absorb=col("absorb"),
        verts=np.concatenate(verts).astype(np.float32),
        faces=np.concatenate(faces), face_mat=np.concatenate(face_mat),
        sph_center=np.asarray([s[0] for s in sph], np.float32).reshape(-1, 3),
        sph_radius=np.asarray([s[1] for s in sph], np.float32),
        sph_mat=np.asarray([s[2] for s in sph], np.int64),
        mesh_spans=spans)
