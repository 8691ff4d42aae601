"""Output writers: PNG, Radiance .hdr, and legacy ASCII PPM.

PNG/HDR mirror main.cpp:187-195 (tonemapped cameras emit both .hdr raw
radiance and .png).  The P3 PPM writer matches write_ppm (src/ppm.cpp:4-39),
kept for parity with the reference's legacy path.
"""

from __future__ import annotations

import numpy as np

from advanced_cpu_raytracing_tpu_torch.scene.images import write_hdr, write_png  # noqa: F401


def write_ppm(path: str, rgb_u8: np.ndarray) -> None:
    h, w, _ = rgb_u8.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        flat = rgb_u8.reshape(-1, 3)
        lines = [" ".join(str(int(v)) for v in px) for px in flat]
        f.write("\n".join(lines))
        f.write("\n")


def read_ppm(path: str) -> np.ndarray:
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0] == "P3"
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int32)
    return data.reshape(h, w, 3).astype(np.uint8)
