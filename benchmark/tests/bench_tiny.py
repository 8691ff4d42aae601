"""Small CPU versions of the benchmark's cells for its tests: the cells'
scenes with a torus of a few faces in place of the 32,768-face one, at a
few pixels, run through the program's plain versions on the CPU."""

from __future__ import annotations

import math
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = {"width": 12, "height": 12, "spp": 4, "pixels": 48}


def torus_ply(path: Path, nu: int = 8, nv: int = 6, big: float = 3.0,
              small: float = 1.0, center=(1.0, -7.0, -2.0)):
    """A binary little-endian PLY torus of 2 nu nv faces."""
    u = np.arange(nu) * 2 * math.pi / nu
    v = np.arange(nv) * 2 * math.pi / nv
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (big + small * np.cos(vv)) * np.cos(uu) + center[0]
    y = small * np.sin(vv) + center[1]
    z = (big + small * np.cos(vv)) * np.sin(uu) + center[2]
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype("<f4")
    faces = []
    for i in range(nu):
        for j in range(nv):
            a, b = i * nv + j, ((i + 1) % nu) * nv + j
            c, d = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
            faces += [(a, b, c), (a, c, d)]
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex "
            f"{len(verts)}\nproperty float x\nproperty float y\nproperty "
            f"float z\nelement face {len(faces)}\nproperty list uchar int "
            f"vertex_indices\nend_header\n").encode()
    rec = np.zeros(len(faces), np.dtype([("n", "u1"), ("i", "<i4", 3)]))
    rec["n"], rec["i"] = 3, faces
    path.write_bytes(head + verts.tobytes() + rec.tobytes())
    return len(faces)


def tiny_scene_dir(tmp: Path, layout=None) -> Path:
    """The scene of every configuration of ``layout`` and the files it
    lists under ``assets``, copied from the layout's roots, with the small
    torus in place of the 32,768-face one, in ``tmp``."""
    layout = layout or harness.Layout()
    for c in layout.spec["configs"]:
        cfg = layout.config(c["name"])
        for name in [cfg["scene"], *cfg.get("assets", [])]:
            (tmp / name).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(layout.find("configs", name), tmp / name)
    torus_ply(tmp / "torus_32768.ply")
    return tmp


def run_of(cell: str, tmp: Path, seed: int = 7, seconds: float = 0.2,
           trace: bool = False, layout=None, **over) -> harness.Run:
    layout = layout or harness.Layout()
    c = layout.cell(cell)
    tr = layout.traffic(c["traffic"])
    if tr["runner"] == "train":
        # the shortest job that holds the checked updates, so the window
        # starts with a job of its own
        from benchmark.runners.train import CHECKED_UPDATES

        over = {"steps_per_job": -(-CHECKED_UPDATES // tr["grids"]),
                **over}
    return harness.Run(layout, c, layout.config(c["config"]), tr, seed,
                       seconds, trace, device="cpu",
                       overrides={**TINY,
                                  "scene_dir": tiny_scene_dir(tmp, layout),
                                  **over})

