// mega_tex.cuh — textures and the environment light of the K1d megakernel
// (mega_pt.cu's mega_tex_kernel and mega_tex_motion_kernel).
//
// Replaces the texture and env parts of the TPU kernel
// advanced_cpu_raytracing_tpu/ops/pallas/megakernel.py::_kernel: Perlin
// noise (perlin_unit, fade_w: lines 1010-1057), image lookups (tile_uv_k,
// img_sample, img_grey_at: 1062-1142), the lat-long env lookup
// (env_radiance: 1353-1360), the trace's winner slots, UV and tangent frame
// with the sphere UV and the sphere's object-space bump (1548-1719), and
// the mesh bump, normal map and image bump (1880-2007).  The plain version
// is ops/megakernel.py (_Tex, _tex_normal, _tex_reflectance) over
// ops/texture.py.
//
// Design.  The TPU kernel packs LDR texels one f32 per texel, gathers them
// with row-masked lane gathers, tiles megapixel and HDR images into 8x16
// blocks fetched by a windowed DMA, and evaluates atan2/acos as
// polynomials: none of that is needed here.  Every texel of every image
// texture and of the env map sits in one plain f32 RGB pool at native
// size, and a tap is three read-only global loads.  The trace
// (mw::trace<true, M, true>) keeps only the index of the winning face or
// sphere; its slots, UV and tangent frame
// are read from that row afterwards, so the 128-face sweep carries nothing
// more than K1c's.  Bound: the FP32 work of the Perlin evaluations (8
// corners each) and the taps, beside the ray queries; at most a few
// hundred bytes of texels per ray, served by L2.  NoTex (K1b, K1c)
// compiles none of this.
//
// On an NVIDIA H100 80GB HBM3 (700.00 W) the texture work is 16% of K1d's
// time on feat_textures.xml and Perlin 5% (PERF.md section 6, PR 14): a
// tap waits on its loads like the walk's node reads.  Three layouts were
// measured against this one and lost or tied: the pool as (N, 4) for one
// 16-byte load a texel (1.4% slower; that scene's 50.3 MB pool grows to
// 67.1 MB, past the 50 MB L2), perm staged in each block's shared memory
// (1.5% slower) and the corner hashes hoisted to their 14 distinct loads
// (within 0.1%).

#pragma once

#include "mega_common.cuh"

namespace mt {

using namespace mw;

constexpr int TEXF_COLS = 29;  // slots 5, vertex UVs 6, TBN (11:29)
constexpr int TEXS_COLS = 7;   // slots diffuse, specular, replace_all,
                               // bump; normaliser, -r pi, 3 / normaliser
constexpr int TEXI_COLS = 7;   // kind, interp, blend, absval, w, h, first
constexpr int TEXR_COLS = 2;   // bump factor, noise scale
// f32 constants of the JAX kernel (the Python doubles rounded once)
constexpr float PI_F = 3.1415927410125732f;
constexpr float TWO_PI_F = 6.2831854820251465f;
constexpr float INV255 = 0.003921568859368563f;
constexpr float THIRD = 0.3333333432674408f;
constexpr float BUMP_EPS = 0.0010000000474974513f;
constexpr float SPH_CLIP = 0.9999989867210388f;

// Scenes without textures or an env light (K1b, K1c).
struct NoTex {
  static constexpr bool kOn = false;
};

// K1d's tables.  Passed by pointer to mega_pt_launch (null for K1b and
// K1c); ops/_build.py mirrors the layout, ops/megakernel.py the columns.
struct TexParams {
  static constexpr bool kOn = true;
  const float* face;    // (n_tri, TEXF_COLS) per face
  const float* sph;     // (n_sph, TEXS_COLS) per sphere
  const int* tint;      // (n_tex, TEXI_COLS) per texture
  const float* tflt;    // (n_tex, TEXR_COLS) per texture
  const float* texels;  // (n_texels, 3) the pool
  const int* perm;      // (512) Perlin permutation
  const float* pix_uv;  // (n, 2) pixel UV of each ray, or null
  int n_tex, tbn_obj, bg_tex;
  int env_w, env_h, env_first;  // env_w 0: no env light
};

// The winner of a textured trace and its surface attributes.
struct Surface {
  int slot[5];       // diffuse, specular, bump, replace_all, normal
  float u, v;        // untiled UV
  const float* row;  // the winning face's row of X.face, or null
};

__device__ __forceinline__ int ldi(const int* p) { return __ldg(p); }

__device__ __forceinline__ float fade_w(float x) {
  x = fabsf(x);
  const float x2 = x * x;
  const float x3 = x2 * x;
  const float w = -6.0f * x3 * x2 + 15.0f * x3 * x - 10.0f * x3 + 1.0f;
  return x > 1.0f ? 0.0f : w;
}

// Converted Perlin sample of texture ti in [0, 1] at a world position
// (PerlinTexture::GetSampleFromWorldPos, perlinTexture.h:76-133): the
// gradient of corner hash h is the classic table's row h % 12.
__device__ float perlin(const TexParams& X, int ti, float px, float py,
                        float pz) {
  const float scale = __ldg(X.tflt + ti * TEXR_COLS + 1);
  px = px * scale;
  py = py * scale;
  pz = pz * scale;
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float dx = px - fx, dy = py - fy, dz = pz - fz;
  const int cx = static_cast<int>(fx) & 255;
  const int cy = static_cast<int>(fy) & 255;
  const int cz = static_cast<int>(fz) & 255;
  float total = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c >> 2, oy = (c >> 1) & 1, oz = c & 1;
    const int h =
        ldi(X.perm + cx + ox + ldi(X.perm + cy + oy + ldi(X.perm + cz + oz))) %
        12;
    const int k = h & 3;
    const float s0 = (k & 1) ? -1.0f : 1.0f;
    const float s1 = (k & 2) ? -1.0f : 1.0f;
    const float gx = h < 8 ? s0 : 0.0f;
    const float gy = h < 4 ? s1 : (h >= 8 ? s0 : 0.0f);
    const float gz = h < 4 ? 0.0f : s1;
    const float ex = dx - static_cast<float>(ox);
    const float ey = dy - static_cast<float>(oy);
    const float ez = dz - static_cast<float>(oz);
    const float cc = gx * ex + gy * ey + gz * ez;
    const float w = fade_w(ex) * fade_w(ey) * fade_w(ez);
    total = total + w * cc;
  }
  return ldi(X.tint + ti * TEXI_COLS + 3) ? fabsf(total)
                                          : (total + 1.0f) * 0.5f;
}

// UV tiling (Mesh::GetFloorForTiledUV, mesh.cpp:382-389)
__device__ __forceinline__ float tile_uv(float x) {
  float frac = x - floorf(x);
  frac = frac < 0.0001f ? 1.0f : frac;
  return x > 1.0001f ? frac : x;
}

__device__ __forceinline__ void texel(const TexParams& X, int first, int w,
                                      int i, int j, float& r, float& g,
                                      float& b) {
  const float* t = X.texels + 3 * (static_cast<size_t>(first) +
                                   static_cast<size_t>(j) * w + i);
  r = __ldg(t);
  g = __ldg(t + 1);
  b = __ldg(t + 2);
}

__device__ __forceinline__ int nearest(float u, int w) {
  return max(min(static_cast<int>(u * static_cast<float>(w)), w - 1), 0);
}

// RGB of image texture ti at (u, v): nearest (imageTexture.h:60-70) or
// bilinear with edge-clamped +1 taps (77-133), scaled by 1/255 unless raw.
__device__ void img_sample(const TexParams& X, int ti, float u, float v,
                           bool raw, float& r, float& g, float& b) {
  const int* T = X.tint + ti * TEXI_COLS;
  const int w = ldi(T + 4), h = ldi(T + 5), first = ldi(T + 6);
  if (ldi(T + 1) == 0) {
    texel(X, first, w, nearest(u, w), nearest(v, h), r, g, b);
  } else {
    const float fw = static_cast<float>(w), fh = static_cast<float>(h);
    const float fi = fminf(fmaxf(u * fw, 0.0f), fw - 1.0f);
    const float fj = fminf(fmaxf(v * fh, 0.0f), fh - 1.0f);
    const float p = floorf(fi), q = floorf(fj);
    const float dx = fi - p, dy = fj - q;
    const int p0 = static_cast<int>(p), q0 = static_cast<int>(q);
    const int p1 = static_cast<int>(fminf(p + 1.0f, fw - 1.0f));
    const int q1 = static_cast<int>(fminf(q + 1.0f, fh - 1.0f));
    float r0, g0, b0, r1, g1, b1, r2, g2, b2, r3, g3, b3;
    texel(X, first, w, p0, q0, r0, g0, b0);
    texel(X, first, w, p1, q0, r1, g1, b1);
    texel(X, first, w, p0, q1, r2, g2, b2);
    texel(X, first, w, p1, q1, r3, g3, b3);
    const float w0 = (1.0f - dx) * (1.0f - dy), w1 = dx * (1.0f - dy);
    const float w2 = (1.0f - dx) * dy, w3 = dx * dy;
    r = w0 * r0 + w1 * r1 + w2 * r2 + w3 * r3;
    g = w0 * g0 + w1 * g1 + w2 * g2 + w3 * g3;
    b = w0 * b0 + w1 * b1 + w2 * b2 + w3 * b3;
  }
  if (!raw) {
    r = r * INV255;
    g = g * INV255;
    b = b * INV255;
  }
}

// Mean-channel grey at an integer texel (the bump taps, mesh.cpp:317-329)
__device__ __forceinline__ float img_grey(const TexParams& X, int ti, int i,
                                          int j) {
  const int* T = X.tint + ti * TEXI_COLS;
  float r, g, b;
  texel(X, ldi(T + 6), ldi(T + 4), i, j, r, g, b);
  return (r + g + b) * THIRD;
}

// Lat-long radiance * 2pi along an unnormalised direction (GetSample,
// sphericalEnvironmentLight.h:22-35): nearest texel, raw values.
__device__ __forceinline__ void env_radiance(const TexParams& X, float vx,
                                             float vy, float vz, float& r,
                                             float& g, float& b) {
  const float u = (1.0f + atan2f(vx, -vz) / PI_F) / 2.0f;
  const float v = acosf(fminf(fmaxf(vy, -1.0f), 1.0f)) / PI_F;
  texel(X, X.env_first, X.env_w, nearest(u, X.env_w), nearest(v, X.env_h), r,
        g, b);
  r = r * TWO_PI_F;
  g = g * TWO_PI_F;
  b = b * TWO_PI_F;
}

// The winner's slots and UV (megakernel.py:1548-1719): a face's from its
// row, with the UV interpolated at the hit's barycentrics; a sphere's from
// its row, with the spherical UV of its local hit (sphere.cpp:138-167)
// and its bump applied to h's normal in object space (sphere.cpp:116-169).
template <class M>
__device__ void surface(const Params& P, const TexParams& X, Hit& h,
                        int face, int sph, float px, float py, float pz,
                        float vx, float vy, float vz, const M& mo,
                        Surface& S) {
  for (int k = 0; k < 5; ++k) S.slot[k] = -1;
  S.u = 0.0f;
  S.v = 0.0f;
  S.row = nullptr;
  if (!h.hit) return;
  if (face >= 0) {
    const float* q = X.face + face * TEXF_COLS;
    S.row = q;
    for (int k = 0; k < 5; ++k) S.slot[k] = static_cast<int>(__ldg(q + k));
    // the barycentrics of the winning face, as its test computed them
    const float* r = P.tri + face * TRI_COLS;
    move_to_face(mo, face, px, py, pz);
    const float v0x = __ldg(r), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
    const float e1x = v0x - __ldg(r + 3), e1y = v0y - __ldg(r + 4),
                e1z = v0z - __ldg(r + 5);
    const float e2x = v0x - __ldg(r + 6), e2y = v0y - __ldg(r + 7),
                e2z = v0z - __ldg(r + 8);
    const float bx = v0x - px, by = v0y - py, bz = v0z - pz;
    const float m0 = e2y * vz - vy * e2z;
    const float m1 = e2x * vz - vx * e2z;
    const float m2 = e2x * vy - vx * e2y;
    const float det = e1x * m0 - e1y * m1 + e1z * m2;
    const float safe = det == 0.0f ? 1.0f : det;
    const float beta = (bx * m0 - by * m1 + bz * m2) / safe;
    const float n0 = by * vz - vy * bz;
    const float n1 = bx * vz - vx * bz;
    const float n2 = bx * vy - vx * by;
    const float gamma = (e1x * n0 - e1y * n1 + e1z * n2) / safe;
    const float u0 = __ldg(q + 5), w0 = __ldg(q + 6);
    S.u = u0 + beta * (__ldg(q + 7) - u0) + gamma * (__ldg(q + 9) - u0);
    S.v = w0 + beta * (__ldg(q + 8) - w0) + gamma * (__ldg(q + 10) - w0);
    return;
  }
  const float* st = X.sph + sph * TEXS_COLS;
  S.slot[0] = static_cast<int>(st[0]);
  S.slot[1] = static_cast<int>(st[1]);
  S.slot[3] = static_cast<int>(st[2]);
  const int bti = static_cast<int>(st[3]);
  if (S.slot[0] < 0 && S.slot[1] < 0 && S.slot[3] < 0 && bti < 0) return;
  // the local hit minus the center, as sphere_hit computed it
  const float* s = P.sph + sph * SPH_COLS;
  float olx = s[0] * px + s[1] * py + s[2] * pz + s[3];
  float oly = s[4] * px + s[5] * py + s[6] * pz + s[7];
  float olz = s[8] * px + s[9] * py + s[10] * pz + s[11];
  if constexpr (M::kOn) {
    if (mo.sph != nullptr) {
      const float* m = mo.sph + 3 * sph;
      olx = olx + m[0] * mo.tau;
      oly = oly + m[1] * mo.tau;
      olz = olz + m[2] * mo.tau;
    }
  }
  const float dlx = s[0] * vx + s[1] * vy + s[2] * vz;
  const float dly = s[4] * vx + s[5] * vy + s[6] * vz;
  const float dlz = s[8] * vx + s[9] * vy + s[10] * vz;
  const float prx = (olx - s[21]) + h.t * dlx;
  const float pry = (oly - s[22]) + h.t * dly;
  const float prz = (olz - s[23]) + h.t * dlz;
  const float phi = atan2f(prz, prx);
  const float th = acosf(fminf(fmaxf(pry / s[24], -SPH_CLIP), SPH_CLIP));
  S.u = (-phi + PI_F) / TWO_PI_F;
  S.v = th / PI_F;
  if (bti < 0) return;
  // analytic tangents; n = unit(bitangent x tangent)
  float tx = TWO_PI_F * prz, ty = 0.0f, tz = -TWO_PI_F * prx;
  norm3(tx, ty, tz);
  float bx = PI_F * pry * cosf(phi), by = st[5] * sinf(th),
        bz = PI_F * pry * sinf(phi);
  norm3(bx, by, bz);
  float nbx = by * tz - bz * ty, nby = bz * tx - bx * tz,
        nbz = bx * ty - by * tx;
  norm3(nbx, nby, nbz);
  float ox, oy, oz;
  if (ldi(X.tint + bti * TEXI_COLS) == 1) {
    // Perlin: the local-frame gradient, no bump factor
    const float h0 = perlin(X, bti, prx, pry, prz);
    const float gx = (perlin(X, bti, prx + BUMP_EPS, pry, prz) - h0) / BUMP_EPS;
    const float gy = (perlin(X, bti, prx, pry + BUMP_EPS, prz) - h0) / BUMP_EPS;
    const float gz = (perlin(X, bti, prx, pry, prz + BUMP_EPS) - h0) / BUMP_EPS;
    const float gpar = gx * nbx + gy * nby + gz * nbz;
    ox = nbx - (gx - gpar * nbx);
    oy = nby - (gy - gpar * nby);
    oz = nbz - (gz - gpar * nbz);
    norm3(ox, oy, oz);
  } else {
    // image: taps scale by w (not w - 1), the grey by 3 / normaliser
    const int* T = X.tint + bti * TEXI_COLS;
    const int w = ldi(T + 4), hh = ldi(T + 5);
    const float bf = __ldg(X.tflt + bti * TEXR_COLS), rescale = st[6];
    const int i0 = max(min(static_cast<int>(S.u * static_cast<float>(w)), w - 1), 0);
    const int j0 = max(min(static_cast<int>(S.v * static_cast<float>(hh)), hh - 1), 0);
    const int i1 = min(i0 + 1, w - 1), j1 = min(j0 + 1, hh - 1);
    const float h_uv = img_grey(X, bti, i0, j0) * rescale;
    const float h_du = img_grey(X, bti, i1, j0) * rescale;
    const float h_dv = img_grey(X, bti, i0, j1) * rescale;
    const float qux = tx + nbx * ((h_du - h_uv) * bf);
    const float quy = ty + nby * ((h_du - h_uv) * bf);
    const float quz = tz + nbz * ((h_du - h_uv) * bf);
    const float qvx = bx + nbx * ((h_dv - h_uv) * bf);
    const float qvy = by + nby * ((h_dv - h_uv) * bf);
    const float qvz = bz + nbz * ((h_dv - h_uv) * bf);
    ox = qvy * quz - qvz * quy;
    oy = qvz * qux - qvx * quz;
    oz = qvx * quy - qvy * qux;
    norm3(ox, oy, oz);
    if (ox * nbx <= 0.0f && oy * nby <= 0.0f && oz * nbz <= 0.0f) {
      ox = -ox;
      oy = -oy;
      oz = -oz;
    }
  }
  h.nx = s[12] * ox + s[13] * oy + s[14] * oz;
  h.ny = s[15] * ox + s[16] * oy + s[17] * oz;
  h.nz = s[18] * ox + s[19] * oy + s[20] * oz;
  norm3(h.nx, h.ny, h.nz);
}

// A face's tangent-frame vector a (object space with tbn_obj) to a world
// unit vector: M^-T of the entity, or as it is.
__device__ __forceinline__ void tbn_world(const TexParams& X, const float* q,
                                          float& ax, float& ay, float& az) {
  if (X.tbn_obj) {
    const float* m = q + 20;
    const float x = __ldg(m) * ax + __ldg(m + 1) * ay + __ldg(m + 2) * az;
    const float y = __ldg(m + 3) * ax + __ldg(m + 4) * ay + __ldg(m + 5) * az;
    const float z = __ldg(m + 6) * ax + __ldg(m + 7) * ay + __ldg(m + 8) * az;
    ax = x;
    ay = y;
    az = z;
  }
  norm3(ax, ay, az);
}

// The shading normal at hit point p after the Perlin bump, the normal map
// and the image bump, in that order (megakernel.py:1880-2007); (u, v)
// become the tiled UV.
__device__ void shading_normal(const TexParams& X, Surface& S, float px,
                               float py, float pz, float& nx, float& ny,
                               float& nz) {
  const int tb = S.slot[2], tn = S.slot[4];
  if (tb >= 0 && ldi(X.tint + tb * TEXI_COLS) == 1) {
    // Perlin bump: the world-space gradient projected off the normal
    const float bf = __ldg(X.tflt + tb * TEXR_COLS);
    const float h0 = perlin(X, tb, px, py, pz) * bf;
    const float gx = (perlin(X, tb, px + BUMP_EPS, py, pz) * bf - h0) / BUMP_EPS;
    const float gy = (perlin(X, tb, px, py + BUMP_EPS, pz) * bf - h0) / BUMP_EPS;
    const float gz = (perlin(X, tb, px, py, pz + BUMP_EPS) * bf - h0) / BUMP_EPS;
    const float gpar = gx * nx + gy * ny + gz * nz;
    const float bx = nx - (gx - gpar * nx), by = ny - (gy - gpar * ny),
                bz = nz - (gz - gpar * nz);
    nx = bx;
    ny = by;
    nz = bz;
    norm3(nx, ny, nz);
  }
  S.u = tile_uv(S.u);
  S.v = tile_uv(S.v);
  const bool nmap = tn >= 0 && ldi(X.tint + tn * TEXI_COLS) == 0;
  const bool ibump = tb >= 0 && tn < 0 && ldi(X.tint + tb * TEXI_COLS) == 0;
  if (!(nmap || ibump) || S.row == nullptr) return;
  const float* q = S.row;
  const float tx = __ldg(q + 11), ty = __ldg(q + 12), tz = __ldg(q + 13);
  const float bx = __ldg(q + 14), by = __ldg(q + 15), bz = __ldg(q + 16);
  float ox = nx, oy = ny, oz = nz;
  if (X.tbn_obj) {
    ox = __ldg(q + 17);
    oy = __ldg(q + 18);
    oz = __ldg(q + 19);
  }
  float ax, ay, az;
  if (nmap) {
    // tangent-space normal map (mesh.cpp:264-275): rgb / 127.5 - 1
    float r, g, b;
    img_sample(X, tn, S.u, S.v, true, r, g, b);
    float sx = r / 127.5f - 1.0f, sy = g / 127.5f - 1.0f, sz = b / 127.5f - 1.0f;
    norm3(sx, sy, sz);
    ax = tx * sx + bx * sy + ox * sz;
    ay = ty * sx + by * sy + oy * sz;
    az = tz * sx + bz * sy + oz * sz;
  } else {
    // height-field bump (mesh.cpp:310-357): forward differences of the
    // grey at integer texels
    const int* T = X.tint + tb * TEXI_COLS;
    const int w = ldi(T + 4), hh = ldi(T + 5);
    const float bf = __ldg(X.tflt + tb * TEXR_COLS);
    const int i0 = max(min(static_cast<int>(S.u * static_cast<float>(w - 1)), w - 1), 0);
    const int j0 = max(min(static_cast<int>(S.v * static_cast<float>(hh - 1)), hh - 1), 0);
    const int i1 = min(i0 + 1, w - 1), j1 = min(j0 + 1, hh - 1);
    const float h_uv = img_grey(X, tb, i0, j0);
    const float h_du = img_grey(X, tb, i1, j0);
    const float h_dv = img_grey(X, tb, i0, j1);
    const float qux = tx + ox * ((h_du - h_uv) * bf);
    const float quy = ty + oy * ((h_du - h_uv) * bf);
    const float quz = tz + oz * ((h_du - h_uv) * bf);
    const float qvx = bx + ox * ((h_dv - h_uv) * bf);
    const float qvy = by + oy * ((h_dv - h_uv) * bf);
    const float qvz = bz + oz * ((h_dv - h_uv) * bf);
    ax = qvy * quz - qvz * quy;
    ay = qvz * qux - qvx * quz;
    az = qvx * quy - qvy * qux;
    norm3(ax, ay, az);
    // orientation fixups (mesh.cpp:345-354)
    const bool flip = (ax * ox <= 0.0f && ay * oy <= 0.0f && az * oz <= 0.0f) ||
                      fabsf(ax - ox) > 0.9f || fabsf(ay - oy) > 0.9f ||
                      fabsf(az - oz) > 0.9f;
    if (flip) {
      ax = -ax;
      ay = -ay;
      az = -az;
    }
  }
  tbn_world(X, q, ax, ay, az);
  nx = ax;
  ny = ay;
  nz = az;
}

// A reflectance k (3) with texture ti applied: a Perlin grey or an image
// RGB / 255 replaces it, or with blend_kd averages with it
// (megakernel.py:2100-2137).
__device__ __forceinline__ void reflectance(const TexParams& X, int ti,
                                            const Surface& S, float px,
                                            float py, float pz, float* k) {
  if (ti < 0) return;
  const int* T = X.tint + ti * TEXI_COLS;
  float r, g, b;
  if (ldi(T) == 1) {
    r = g = b = perlin(X, ti, px, py, pz);
  } else {
    img_sample(X, ti, S.u, S.v, false, r, g, b);
  }
  if (ldi(T + 2)) {
    k[0] = (r + k[0]) * 0.5f;
    k[1] = (g + k[1]) * 0.5f;
    k[2] = (b + k[2]) * 0.5f;
  } else {
    k[0] = r;
    k[1] = g;
    k[2] = b;
  }
}

}  // namespace mt
