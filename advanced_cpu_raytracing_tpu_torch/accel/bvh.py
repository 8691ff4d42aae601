"""Host-side BVH construction, flattened for device traversal.

Build semantics mirror the reference (midpoint split on the longest axis with
in-place face partition, leaf when <2 faces or a side comes out empty, child
boxes refit from face bboxes — src/mesh.cpp:23-156), but the output is a flat
SoA node table:

  node_min/node_max : (N, 3) float32   child AABBs
  node_left/right   : (N,)  int32      child indices, -1 for leaves
  node_first/count  : (N,)  int32      face range for leaves
  order             : (F,)  int32      permutation applied to the face arrays

Interior nodes have count == 0 (mesh.cpp:125).  The face permutation makes
consecutive faces spatially coherent, which the megakernel's 128-face chunk
culls and its tree's leaves of consecutive rows rely on.

From ``NATIVE_MIN_FACES`` faces, as in the JAX package (its accel/bvh.py),
the build runs in ``native/bvh_builder.cpp``: compiled with g++ at first use
into ``build/native/`` beside the package, named by a hash of the source and
flags (``native/build.py``), and called through ctypes.  It builds the same tree as the numpy
builder, node for node.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from advanced_cpu_raytracing_tpu_torch.native.build import (
    BUILD_DIR,
    CXX_FLAGS,
    build_library,
)

NATIVE_MIN_FACES = 4096
_SOURCE = Path(__file__).resolve().parents[1] / "native" / "bvh_builder.cpp"
_BUILD_DIR = BUILD_DIR
# no FMA contraction, so the split planes round as numpy's do
_CXX_FLAGS = (*CXX_FLAGS, "-ffp-contract=off")
_LIB = None


@dataclass
class FlatBVH:
    node_min: np.ndarray
    node_max: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    node_first: np.ndarray
    node_count: np.ndarray
    order: np.ndarray  # face permutation
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return len(self.node_left)


def build_bvh(face_bbox_min: np.ndarray, face_bbox_max: np.ndarray,
              face_center: np.ndarray) -> FlatBVH:
    """Build a BVH over faces given per-face bboxes and centers: numpy
    below ``NATIVE_MIN_FACES`` faces, the native builder from there."""
    if len(face_center) >= NATIVE_MIN_FACES:
        return _build_bvh_native(face_bbox_min, face_bbox_max, face_center)
    return _build_bvh_numpy(face_bbox_min, face_bbox_max, face_center)


def _native_lib() -> ctypes.CDLL:
    """The native builder, compiled on first use; a failed build raises
    with the compiler's output."""
    global _LIB
    if _LIB is None:
        cdll = ctypes.CDLL(str(build_library(_SOURCE, "libbvh", _CXX_FLAGS,
                                             _BUILD_DIR)))
        cdll.acrt_build_bvh.restype = ctypes.c_int32
        cdll.acrt_build_bvh.argtypes = [ctypes.c_int32] + [ctypes.c_void_p] * 11
        _LIB = cdll
    return _LIB


def _build_bvh_native(face_bbox_min, face_bbox_max, face_center) -> FlatBVH:
    n = len(face_center)
    cap = 2 * n - 1
    ins = [np.ascontiguousarray(a, np.float32)
           for a in (face_bbox_min, face_bbox_max, face_center)]
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    ints = [np.empty(cap, np.int32) for _ in range(4)]
    order = np.empty(n, np.int32)
    depth = np.zeros(1, np.int32)
    num = _native_lib().acrt_build_bvh(
        n, *(a.ctypes.data for a in (*ins, node_min, node_max, *ints, order,
                                     depth)))
    if num <= 0:
        raise RuntimeError(f"native BVH build failed on {n} faces")
    left, right, first, count = (a[:num] for a in ints)
    return FlatBVH(node_min[:num], node_max[:num], left, right, first, count,
                   order, int(depth[0]))


def _build_bvh_numpy(face_bbox_min: np.ndarray, face_bbox_max: np.ndarray,
                     face_center: np.ndarray) -> FlatBVH:
    n = len(face_center)
    fmin = np.asarray(face_bbox_min, np.float32)
    fmax = np.asarray(face_bbox_max, np.float32)
    fctr = np.asarray(face_center, np.float32)

    order = np.arange(n, dtype=np.int32)
    cap = max(2 * n - 1, 1)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    node_left = np.full(cap, -1, np.int32)
    node_right = np.full(cap, -1, np.int32)
    node_first = np.zeros(cap, np.int32)
    node_count = np.zeros(cap, np.int32)

    if n == 0:
        node_min[0] = np.inf
        node_max[0] = -np.inf
        return FlatBVH(node_min[:1], node_max[:1], node_left[:1],
                       node_right[:1], node_first[:1], node_count[:1],
                       order, 1)

    node_min[0] = fmin[order].min(axis=0)
    node_max[0] = fmax[order].max(axis=0)
    node_first[0] = 0
    node_count[0] = n
    next_free = 1
    max_depth = 1

    # Iterative DFS matching RecursiveBVHBuild (mesh.cpp:51-135).
    stack = [(0, 1)]
    while stack:
        idx, depth = stack.pop()
        max_depth = max(max_depth, depth)
        count = node_count[idx]
        if count < 2:
            continue
        first = node_first[idx]
        ext = node_max[idx] - node_min[idx]
        axis = int(np.argmax(ext))  # ties go to earliest axis like the C++ chain
        # The reference picks x only if strictly greater than y and z; its
        # nested ifs make z win x/z and y/z ties, y wins x/y ties.  argmax
        # picks the first max; emulate the reference's tie-breaking:
        if ext[0] > ext[1]:
            axis = 0 if ext[0] > ext[2] else 2
        else:
            axis = 1 if ext[1] > ext[2] else 2
        split = node_min[idx][axis] + ext[axis] * 0.5

        seg = order[first:first + count]
        left_mask = fctr[seg, axis] < split
        left_count = int(left_mask.sum())
        if left_count == 0 or left_count == count:
            continue  # one half empty -> stays a leaf (mesh.cpp:105-106)
        # stable partition (reference's swap loop is unstable; hit results
        # are order-independent, so stability is fine and reproducible)
        order[first:first + count] = np.concatenate([seg[left_mask], seg[~left_mask]])

        li, ri = next_free, next_free + 1
        next_free += 2
        node_first[li], node_count[li] = first, left_count
        node_first[ri], node_count[ri] = first + left_count, count - left_count
        for ci in (li, ri):
            seg_c = order[node_first[ci]:node_first[ci] + node_count[ci]]
            node_min[ci] = fmin[seg_c].min(axis=0)
            node_max[ci] = fmax[seg_c].max(axis=0)
        node_left[idx], node_right[idx] = li, ri
        node_count[idx] = 0  # interior (mesh.cpp:125)
        stack.append((li, depth + 1))
        stack.append((ri, depth + 1))

    return FlatBVH(
        node_min[:next_free], node_max[:next_free], node_left[:next_free],
        node_right[:next_free], node_first[:next_free], node_count[:next_free],
        order, max_depth,
    )
