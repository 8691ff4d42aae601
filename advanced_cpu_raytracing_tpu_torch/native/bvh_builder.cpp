// Native BVH builder: midpoint split on the longest axis, iterative, SoA out
// (the port's copy of the JAX package's native/bvh_builder.cpp).
//
// Same build semantics as the numpy builder of accel/bvh.py (which mirrors
// the reference Mesh::RecursiveBVHBuild, src/mesh.cpp:51-135): leaf when < 2
// faces or an empty half, child AABBs refit from face bboxes, interior nodes
// get count 0.  accel/bvh.py::build_bvh uses it from 4,096 faces, where the
// numpy builder dominates scene-load time; it compiles this file at first
// use (g++ -O3 -shared -fPIC) and calls it through ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Returns number of nodes written (<= 2n-1), or -1 on error.
// face_min/face_max/face_center: (n,3) float32
// out arrays must have capacity 2n-1 (nodes) / n (order).
int32_t acrt_build_bvh(
    int32_t n,
    const float* face_min, const float* face_max, const float* face_center,
    float* node_min, float* node_max,
    int32_t* node_left, int32_t* node_right,
    int32_t* node_first, int32_t* node_count,
    int32_t* order, int32_t* out_max_depth) {
  if (n <= 0) return -1;
  for (int32_t i = 0; i < n; i++) order[i] = i;

  const int32_t cap = 2 * n - 1;
  for (int32_t i = 0; i < cap; i++) {
    node_left[i] = node_right[i] = -1;
    node_first[i] = node_count[i] = 0;
  }

  auto refit = [&](int32_t idx) {
    float mn[3] = {1e30f, 1e30f, 1e30f};
    float mx[3] = {-1e30f, -1e30f, -1e30f};
    const int32_t first = node_first[idx], count = node_count[idx];
    for (int32_t k = 0; k < count; k++) {
      const int32_t f = order[first + k];
      for (int c = 0; c < 3; c++) {
        mn[c] = std::min(mn[c], face_min[3 * f + c]);
        mx[c] = std::max(mx[c], face_max[3 * f + c]);
      }
    }
    std::memcpy(node_min + 3 * idx, mn, 12);
    std::memcpy(node_max + 3 * idx, mx, 12);
  };

  node_first[0] = 0;
  node_count[0] = n;
  refit(0);
  int32_t next_free = 1;
  int32_t max_depth = 1;

  std::vector<std::pair<int32_t, int32_t>> stack;  // (node, depth)
  stack.emplace_back(0, 1);
  while (!stack.empty()) {
    const auto [idx, depth] = stack.back();
    stack.pop_back();
    max_depth = std::max(max_depth, depth);
    const int32_t count = node_count[idx];
    if (count < 2) continue;
    const int32_t first = node_first[idx];

    const float* bmin = node_min + 3 * idx;
    const float* bmax = node_max + 3 * idx;
    const float ext[3] = {bmax[0] - bmin[0], bmax[1] - bmin[1],
                          bmax[2] - bmin[2]};
    // reference tie-breaking (mesh.cpp:65-89): x only if strictly greatest,
    // z wins x/z and y/z ties, y wins x/y ties
    int axis;
    if (ext[0] > ext[1]) axis = (ext[0] > ext[2]) ? 0 : 2;
    else axis = (ext[1] > ext[2]) ? 1 : 2;
    const float split = bmin[axis] + ext[axis] * 0.5f;

    // stable partition by centroid (matches the numpy builder)
    std::vector<int32_t> left_part, right_part;
    left_part.reserve(count);
    right_part.reserve(count);
    for (int32_t k = 0; k < count; k++) {
      const int32_t f = order[first + k];
      if (face_center[3 * f + axis] < split) left_part.push_back(f);
      else right_part.push_back(f);
    }
    const int32_t lc = (int32_t)left_part.size();
    if (lc == 0 || lc == count) continue;  // leaf (mesh.cpp:105-106)
    std::memcpy(order + first, left_part.data(), 4 * lc);
    std::memcpy(order + first + lc, right_part.data(), 4 * (count - lc));

    const int32_t li = next_free++, ri = next_free++;
    node_first[li] = first;
    node_count[li] = lc;
    node_first[ri] = first + lc;
    node_count[ri] = count - lc;
    refit(li);
    refit(ri);
    node_left[idx] = li;
    node_right[idx] = ri;
    node_count[idx] = 0;  // interior (mesh.cpp:125)
    stack.emplace_back(li, depth + 1);
    stack.emplace_back(ri, depth + 1);
  }
  *out_max_depth = max_depth;
  return next_free;
}

}  // extern "C"
