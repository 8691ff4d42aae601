"""Host-side image decode/encode.

Replaces the reference's vendored stb_image / tinyexr (src/LDRImage.h:40,
src/HDRImage.h:45-70):

  - LDR (png/jpg...) decode via PIL -> float32 arrays kept in **0..255**
    range, matching ``LDRImage::GetSample`` returning raw bytes.
  - EXR decode via imageio (if built with an EXR plugin) or a minimal native
    reader; falls back with a clear error.
  - Radiance ``.hdr`` (RGBE) encode/decode implemented here directly —
    the reference writes .hdr via stb_image_write (src/main.cpp:191).
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> tuple[np.ndarray, bool]:
    """Return (data (H,W,3) float32, is_hdr).

    LDR values stay in 0..255 like the reference byte samples; HDR (.exr/.hdr)
    are linear floats.
    """
    lower = path.lower()
    if lower.endswith(".exr"):
        return load_exr(path), True
    if lower.endswith(".hdr"):
        return read_hdr(path), True
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        data = np.asarray(im, dtype=np.float32)
    return data, False


def load_exr(path: str) -> np.ndarray:
    try:
        # built-in reader first: handles uncompressed scanline files exactly,
        # and this environment's imageio has no real EXR plugin (its spe
        # plugin mis-claims .exr files)
        data = read_exr(path)
    except Exception:
        import imageio.v2 as imageio

        data = np.asarray(imageio.imread(path), dtype=np.float32)
    if data.ndim == 2:
        data = np.stack([data] * 3, axis=-1)
    # RGBA -> RGB, mirroring HDRImage's RGBA->RGB repack (src/HDRImage.h:58-66)
    return np.ascontiguousarray(data[..., :3])


def write_exr(path: str, rgb: np.ndarray) -> None:
    """Write (H,W,3) float32 as a minimal OpenEXR 2.0 file: single part,
    scanline storage, NO_COMPRESSION, FLOAT channels.

    The capability the reference gets from tinyexr (decode only,
    src/HDRImage.h:45-70) plus the encode side it lacks; tinyexr reads this
    output (verified by the env-light cross-validation test).
    """
    import struct

    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape

    def attr(name: str, typ: str, value: bytes) -> bytes:
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    # channels MUST be sorted by name: B, G, R
    ch = b""
    for name in (b"B", b"G", b"R"):
        ch += name + b"\0" + struct.pack("<i", 2) + b"\0\0\0\0" \
            + struct.pack("<ii", 1, 1)
    ch += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<i", 20000630) + struct.pack("<i", 2)
        + attr("channels", "chlist", ch)
        + attr("compression", "compression", b"\0")
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    row_bytes = 8 + w * 3 * 4  # y + size prefix + BGR float rows
    table_start = len(header)
    data_start = table_start + 8 * h
    offsets = struct.pack("<%dQ" % h,
                          *[data_start + y * row_bytes for y in range(h)])
    with open(path, "wb") as f:
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, w * 3 * 4))
            f.write(rgb[y, :, 2].tobytes())  # B
            f.write(rgb[y, :, 1].tobytes())  # G
            f.write(rgb[y, :, 0].tobytes())  # R


def read_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR reader: single-part uncompressed scanline images with
    HALF or FLOAT channels (covers write_exr output and tinyexr's
    NO_COMPRESSION files)."""
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    if struct.unpack_from("<i", raw, 0)[0] != 20000630:
        raise ValueError("not an EXR file")
    pos = 8
    channels: list[tuple[str, int]] = []
    compression = 0
    dw = (0, 0, 0, 0)
    while raw[pos] != 0:
        e = raw.index(b"\0", pos)
        name = raw[pos:e].decode()
        pos = e + 1
        e = raw.index(b"\0", pos)
        pos = e + 1
        size = struct.unpack_from("<i", raw, pos)[0]
        pos += 4
        val = raw[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while val[cp] != 0:
                ce = val.index(b"\0", cp)
                cname = val[cp:ce].decode()
                ptype = struct.unpack_from("<i", val, ce + 1)[0]
                channels.append((cname, ptype))
                cp = ce + 1 + 16
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", val)
    pos += 1  # header terminator
    if compression != 0:
        raise ValueError("only NO_COMPRESSION EXR files supported")
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    pos += 8 * h  # skip the offset table; blocks follow in order
    planes: dict[str, np.ndarray] = {
        c: np.zeros((h, w), np.float32) for c, _ in channels}
    for _ in range(h):
        y = struct.unpack_from("<i", raw, pos)[0] - dw[1]
        pos += 8
        for cname, ptype in channels:  # chlist order == file order
            if ptype == 2:  # FLOAT
                row = np.frombuffer(raw, "<f4", w, pos)
                pos += 4 * w
            elif ptype == 1:  # HALF
                row = np.frombuffer(raw, "<f2", w, pos).astype(np.float32)
                pos += 2 * w
            else:
                raise ValueError("UINT channels unsupported")
            planes[cname][y] = row
    if all(k in planes for k in ("R", "G", "B")):
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    first = planes[channels[0][0]]
    return np.stack([first] * 3, axis=-1)


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write (H,W,3) uint8 to PNG (reference: stbi_write_png, main.cpp:195)."""
    from PIL import Image

    Image.fromarray(np.asarray(rgb_u8, dtype=np.uint8), mode="RGB").save(path)


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write (H,W,3) float32 as Radiance RGBE .hdr (flat, no RLE).

    Matches the container stb_image_write produces (main.cpp:191); readers
    accept both RLE and flat scanlines.
    """
    rgb = np.asarray(rgb, dtype=np.float32)
    h, w, _ = rgb.shape
    maxc = rgb.max(axis=-1)
    # frexp: maxc = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(maxc)
    scale = np.where(maxc > 1e-32, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE reader (flat and adaptive-RLE scanlines)."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance file")
        while True:
            line = f.readline().strip()
            if not line:
                break
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = f.read()

    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    pos = 0
    for y in range(h):
        if (
            len(data) - pos >= 4
            and data[pos] == 2
            and data[pos + 1] == 2
            and ((data[pos + 2] << 8) | data[pos + 3]) == w
        ):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]; pos += 1
                    if cnt > 128:  # run
                        rgbe[y, x : x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:  # literal
                        rgbe[y, x : x + cnt, c] = np.frombuffer(
                            data, np.uint8, cnt, pos
                        )
                        pos += cnt
                        x += cnt
        else:
            row = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            rgbe[y] = row
            pos += w * 4

    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]
