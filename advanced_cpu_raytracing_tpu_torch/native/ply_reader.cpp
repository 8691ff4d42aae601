// Native PLY reader: the binary little-endian fast path (the format of the
// reference's committed assets), tri + quad faces split like
// parser.cpp:1428-1439.  ASCII and other layouts go to the Python reader
// (scene/ply.py).
//
// API: two-phase.  acrt_ply_open parses the header and the counts, the
// caller allocates, acrt_ply_read fills the buffers.  Only files whose
// vertex element comes first and holds float x, y, z side by side, and
// whose face element is a single (uchar or int count, int32 indices) list,
// are read here; everything else returns a negative code, and the caller
// reads the file in Python.  The JAX package's native/ply_reader.cpp, with
// int counts added and the layout checks (x, y, z adjacent; vertex before
// face; the face list alone) made explicit.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

int dtype_size(const std::string& t) {
  if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
  if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
  if (t == "int" || t == "uint" || t == "int32" || t == "uint32" ||
      t == "float" || t == "float32") return 4;
  if (t == "double" || t == "float64") return 8;
  return -1;
}

bool is_float32(const std::string& t) { return t == "float" || t == "float32"; }

}  // namespace

extern "C" {

// Returns 0 when the fast path reads the file, <0 otherwise.  counts[0..5]:
// vertices, face rows, the data's byte offset, bytes per vertex row, the
// byte offset of x in a row, bytes of a face row's count.
int32_t acrt_ply_open(const char* path, int64_t* counts) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  if (!std::fgets(line, sizeof line, f) || std::strncmp(line, "ply", 3)) {
    std::fclose(f);
    return -2;
  }
  int64_t n_vert = 0, n_rows = 0;
  long data_offset = -1;
  std::string cur_elem;
  int vert_off = 0, x_off = -1, y_off = -1, z_off = -1;
  int count_size = 0, face_props = 0;
  bool vertex_seen = false, face_before_vertex = false;
  while (std::fgets(line, sizeof line, f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.rfind("comment", 0) == 0 || s.rfind("obj_info", 0) == 0) continue;
    if (s.rfind("format", 0) == 0) {
      if (s.find("binary_little_endian") == std::string::npos) {
        std::fclose(f);
        return -3;
      }
    } else if (s.rfind("element", 0) == 0) {
      char name[256];
      long long cnt;
      if (std::sscanf(s.c_str(), "element %255s %lld", name, &cnt) != 2) {
        std::fclose(f);
        return -4;
      }
      cur_elem = name;
      if (cur_elem == "vertex") {
        n_vert = cnt;
        vertex_seen = true;
      } else if (cur_elem == "face") {
        n_rows = cnt;
        face_before_vertex = !vertex_seen;
      } else if (cnt != 0) {
        std::fclose(f);
        return -5;  // an unknown element with rows
      }
    } else if (s.rfind("property", 0) == 0) {
      if (cur_elem == "vertex") {
        char t[64], n[256];
        if (s.rfind("property list", 0) == 0) { std::fclose(f); return -6; }
        if (std::sscanf(s.c_str(), "property %63s %255s", t, n) != 2) {
          std::fclose(f);
          return -7;
        }
        const int sz = dtype_size(t);
        if (sz < 0) { std::fclose(f); return -8; }
        const std::string pname(n);
        if (pname == "x" || pname == "y" || pname == "z") {
          if (!is_float32(t)) { std::fclose(f); return -9; }
          (pname == "x" ? x_off : pname == "y" ? y_off : z_off) = vert_off;
        }
        vert_off += sz;
      } else if (cur_elem == "face") {
        char ct[64], it[64], n[256];
        face_props++;
        if (std::sscanf(s.c_str(), "property list %63s %63s %255s",
                        ct, it, n) != 3) {
          std::fclose(f);
          return -10;
        }
        count_size = dtype_size(ct);
        if (count_size != 1 && count_size != 4) { std::fclose(f); return -11; }
        if (dtype_size(it) != 4 || is_float32(it)) { std::fclose(f); return -12; }
      }
    } else if (s == "end_header") {
      data_offset = std::ftell(f);
      break;
    }
  }
  std::fclose(f);
  if (data_offset < 0 || n_vert <= 0 || x_off < 0 || y_off != x_off + 4 ||
      z_off != x_off + 8 || face_props != 1 || count_size == 0 ||
      face_before_vertex)
    return -13;
  counts[0] = n_vert;
  counts[1] = n_rows;
  counts[2] = data_offset;
  counts[3] = vert_off;
  counts[4] = x_off;
  counts[5] = count_size;
  return 0;
}

// verts: (n_vert, 3) float32 out.  tris: (2 * n_face_rows, 3) int32 out.
// Returns the number of triangles, or <0 on a short file or a face of
// another arity (the Python reader then raises as the reference does).
int32_t acrt_ply_read(const char* path, const int64_t* counts, float* verts,
                      int32_t* tris) {
  const int64_t n_vert = counts[0], n_rows = counts[1];
  const long off = (long)counts[2];
  const int stride = (int)counts[3], x_off = (int)counts[4];
  const int count_size = (int)counts[5];

  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, off, SEEK_SET);

  std::vector<unsigned char> row(stride);
  for (int64_t i = 0; i < n_vert; i++) {
    if (std::fread(row.data(), 1, stride, f) != (size_t)stride) {
      std::fclose(f);
      return -2;
    }
    std::memcpy(verts + 3 * i, row.data() + x_off, 12);
  }
  int64_t nt = 0;
  for (int64_t r = 0; r < n_rows; r++) {
    unsigned char cbuf[4];
    if (std::fread(cbuf, 1, count_size, f) != (size_t)count_size) {
      std::fclose(f);
      return -3;
    }
    int32_t cnt = cbuf[0];
    if (count_size == 4) std::memcpy(&cnt, cbuf, 4);
    int32_t idx[4];
    if (cnt == 3) {
      if (std::fread(idx, 4, 3, f) != 3) { std::fclose(f); return -4; }
      tris[3 * nt + 0] = idx[0];
      tris[3 * nt + 1] = idx[1];
      tris[3 * nt + 2] = idx[2];
      nt++;
    } else if (cnt == 4) {
      if (std::fread(idx, 4, 4, f) != 4) { std::fclose(f); return -5; }
      // quad -> (v0,v1,v2) + (v2,v3,v0) (parser.cpp:1431-1437)
      tris[3 * nt + 0] = idx[0];
      tris[3 * nt + 1] = idx[1];
      tris[3 * nt + 2] = idx[2];
      nt++;
      tris[3 * nt + 0] = idx[2];
      tris[3 * nt + 1] = idx[3];
      tris[3 * nt + 2] = idx[0];
      nt++;
    } else {
      std::fclose(f);
      return -6;
    }
  }
  std::fclose(f);
  return (int32_t)nt;
}

}  // extern "C"
