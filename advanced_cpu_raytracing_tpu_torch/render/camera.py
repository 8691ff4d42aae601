"""Camera: image-plane setup and primary-ray generation (with DoF).

Host setup mirrors Camera::SetupDefault / SetupLookAt /
CalculateImagePlaneParams (src/camera.cpp:5-72); ray generation mirrors
Raytracer::GenerateRay (src/raytracer.cpp:661-699).  Sample positions are
true sub-pixel positions, as in the JAX package's ``render/camera.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from advanced_cpu_raytracing_tpu_torch.scene.types import CameraCfg
from advanced_cpu_raytracing_tpu_torch.utils.device import resolve_device
from advanced_cpu_raytracing_tpu_torch.utils.math3d import dot, normalize


@dataclass
class DeviceCamera:
    """Precomputed image-plane parameters as f32 tensors on one device."""

    position: torch.Tensor  # (3,)
    gaze: torch.Tensor  # (3,) unit
    up: torch.Tensor  # (3,) unit, orthogonalized
    right: torch.Tensor  # (3,)
    q: torch.Tensor  # (3,) image plane top-left (m_q)
    su_scale: torch.Tensor  # () (r-l)/width
    sv_scale: torch.Tensor  # () (t-b)/height
    aperture: torch.Tensor  # ()
    focus_distance: torch.Tensor  # ()
    width: int
    height: int
    use_dof: bool = False  # aperture > 1e-4 (raytracer.cpp:669)


def build_camera(cfg: CameraCfg, device=None) -> DeviceCamera:
    dev = resolve_device(device)
    pos = np.asarray(cfg.position, np.float64)
    up_in = np.asarray(cfg.up, np.float64)

    if cfg.is_look_at:
        # SetupLookAt (camera.cpp:25-48)
        aspect = cfg.width / cfg.height
        top = cfg.near_distance * np.tan(np.deg2rad(cfg.fov_y_deg) / 2.0)
        right_ext = top * aspect
        l, r, b, t = -right_ext, right_ext, -top, top
        gaze = np.asarray(cfg.gaze_point, np.float64) - pos
        gaze /= np.linalg.norm(gaze)
        tmp_up = up_in / np.linalg.norm(up_in)
        tmp_right = np.cross(tmp_up, gaze)
        tmp_right /= np.linalg.norm(tmp_right)
        up = np.cross(gaze, tmp_right)
        up /= np.linalg.norm(up)
    else:
        # SetupDefault (camera.cpp:5-24): orthogonalize up against gaze by
        # subtracting the projection (camera.cpp:50-58)
        l, r, b, t = [float(x) for x in cfg.near_plane]
        gaze = np.asarray(cfg.gaze_dir, np.float64)
        gaze /= np.linalg.norm(gaze)
        tmp_up = up_in / np.linalg.norm(up_in)
        proj = gaze * (tmp_up @ gaze)
        up = tmp_up - proj
        up /= np.linalg.norm(up)

    # CalculateImagePlaneParams (camera.cpp:60-72): right = up x (-gaze)
    w = -gaze
    right = np.cross(up, w)
    middle = pos + gaze * cfg.near_distance
    q = middle + right * l + up * t

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return DeviceCamera(
        position=f32(pos), gaze=f32(gaze), up=f32(up), right=f32(right),
        q=f32(q),
        su_scale=f32((r - l) / cfg.width), sv_scale=f32((t - b) / cfg.height),
        aperture=f32(cfg.aperture_size),
        focus_distance=f32(cfg.focus_distance),
        width=cfg.width, height=cfg.height,
        use_dof=cfg.aperture_size > 1e-4,
    )


def image_plane_position(cam: DeviceCamera, px, py):
    """World position on the near plane for (possibly fractional) pixel
    coordinates, with the +0.5 center offset (camera.cpp:74-80)."""
    su = (px + 0.5) * cam.su_scale
    sv = (py + 0.5) * cam.sv_scale
    return cam.q + cam.right * su[..., None] - cam.up * sv[..., None]


def generate_rays(cam: DeviceCamera, px, py, lens_uv=None, dof: bool = False):
    """Primary rays for pixel coords px/py (R,) f32.

    ``lens_uv`` (R,2) in [-1,1] drives the aperture sample when ``dof``
    (GenerateRay, src/raytracer.cpp:669-691).
    Returns (origin (R,3), dir (R,3) unit).
    """
    plane = image_plane_position(cam, px, py)
    origin = cam.position.expand_as(plane)
    if dof:
        ap = origin + cam.up * (lens_uv[..., 0:1] * cam.aperture * 0.5) \
            + cam.right * (lens_uv[..., 1:2] * cam.aperture * 0.5)
        d_rev = normalize(origin - plane)  # points back toward the camera
        t_fd = cam.focus_distance / dot(d_rev, cam.gaze)
        bent = origin + d_rev * t_fd[..., None]
        return ap, normalize(bent - ap)
    return origin.contiguous(), normalize(plane - origin)
