"""PLY mesh reader (ASCII + binary little/big endian), tri & quad faces.

Replaces the reference's vendored happly (src/parser.cpp:1404-1443): vertex
positions are read as float64 then narrowed to float32; quad faces are split
into two triangles (v0,v1,v2) and (v2,v3,v0) exactly as parser.cpp:1431-1437.

Binary little-endian files of the usual layout (float x, y, z; one list
of uchar or int counts and int32 indices) are read by the native reader
(``native/ply_reader.cpp`` through ``native/bindings.py``, compiled with
g++ at first use; a failed build raises); every other file by the Python
reader below, as in the JAX package (its scene/ply.py:125-131).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class _Property:
    def __init__(self, name, dtype, is_list=False, count_dtype=None):
        self.name = name
        self.dtype = dtype
        self.is_list = is_list
        self.count_dtype = count_dtype


class _Element:
    def __init__(self, name, count):
        self.name = name
        self.count = count
        self.props: list[_Property] = []


def _parse_header(f):
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: list[_Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(_Element(tokens[1], int(tokens[2])))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                prop = _Property(tokens[4], _DTYPES[tokens[3]], True, _DTYPES[tokens[2]])
            else:
                prop = _Property(tokens[2], _DTYPES[tokens[1]])
            elements[-1].props.append(prop)
        elif tokens[0] == "end_header":
            break
    return fmt, elements


def _read_binary_element(f, elem: _Element, endian: str):
    has_list = any(p.is_list for p in elem.props)
    if not has_list:
        dt = np.dtype([(p.name, endian + p.dtype) for p in elem.props])
        raw = np.frombuffer(f.read(dt.itemsize * elem.count), dtype=dt, count=elem.count)
        return {p.name: np.ascontiguousarray(raw[p.name]) for p in elem.props}
    # List properties: sizes can vary per row; parse with offsets over raw bytes.
    buf = f.read()
    out: dict[str, list] = {p.name: [] for p in elem.props}
    off = 0
    for _ in range(elem.count):
        for p in elem.props:
            if p.is_list:
                cnt_dt = np.dtype(endian + p.count_dtype)
                n = int(np.frombuffer(buf, dtype=cnt_dt, count=1, offset=off)[0])
                off += cnt_dt.itemsize
                val_dt = np.dtype(endian + p.dtype)
                vals = np.frombuffer(buf, dtype=val_dt, count=n, offset=off)
                off += val_dt.itemsize * n
                out[p.name].append(vals)
            else:
                val_dt = np.dtype(endian + p.dtype)
                out[p.name].append(np.frombuffer(buf, dtype=val_dt, count=1, offset=off)[0])
                off += val_dt.itemsize
    # rewind leftover bytes for any subsequent element
    f.seek(off - len(buf), 1)
    return out


def _read_ascii_element(f, elem: _Element):
    out: dict[str, list] = {p.name: [] for p in elem.props}
    rows = 0
    while rows < elem.count:
        tokens = f.readline().split()
        if not tokens:
            continue
        i = 0
        for p in elem.props:
            if p.is_list:
                n = int(tokens[i]); i += 1
                out[p.name].append(np.array([float(t) for t in tokens[i:i + n]]))
                i += n
            else:
                out[p.name].append(float(tokens[i])); i += 1
        rows += 1
    return out


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Return (vertices (V,3) float32, triangles (F,3) int32, 0-based).

    Quad faces are split (v0,v1,v2)+(v2,v3,v0) per parser.cpp:1428-1439;
    other polygon arities raise, mirroring the reference's refusal
    (parser.cpp:1440-1442).  The native reader reads the files it takes;
    ``load_ply_python`` the others.
    """
    from advanced_cpu_raytracing_tpu_torch.native.bindings import load_ply_native

    res = load_ply_native(path)
    return load_ply_python(path) if res is None else res


def load_ply_python(path: str) -> tuple[np.ndarray, np.ndarray]:
    """``load_ply`` in Python: ASCII and binary of either endianness, any
    property layout."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        endian = {"binary_little_endian": "<", "binary_big_endian": ">", "ascii": None}[fmt]
        data = {}
        for elem in elements:
            if endian is None:
                data[elem.name] = _read_ascii_element(f, elem)
            else:
                data[elem.name] = _read_binary_element(f, elem, endian)

    v = data["vertex"]
    verts = np.stack(
        [np.asarray(v["x"], np.float64), np.asarray(v["y"], np.float64), np.asarray(v["z"], np.float64)],
        axis=-1,
    ).astype(np.float32)

    face_elem = data.get("face")
    tris: list = []
    if face_elem is not None:
        key = "vertex_indices" if "vertex_indices" in face_elem else "vertex_index"
        idx_lists = face_elem[key]
        counts = np.array([len(ix) for ix in idx_lists])
        if np.all(counts == counts[0]) and counts[0] == 3:
            tris_arr = np.stack(idx_lists).astype(np.int32)
        else:
            for ix in idx_lists:
                if len(ix) == 3:
                    tris.append([ix[0], ix[1], ix[2]])
                elif len(ix) == 4:
                    tris.append([ix[0], ix[1], ix[2]])
                    tris.append([ix[2], ix[3], ix[0]])
                else:
                    raise ValueError(f"face with {len(ix)} indices unsupported")
            tris_arr = np.asarray(tris, dtype=np.int32)
    else:
        tris_arr = np.zeros((0, 3), np.int32)
    return verts, tris_arr
