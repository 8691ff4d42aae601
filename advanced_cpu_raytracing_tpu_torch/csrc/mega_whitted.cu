// mega_whitted.cu — the Whitted megakernel (K1a) for NVIDIA Hopper (sm_90a).
//
// Replaces the Whitted core of the TPU kernel
// advanced_cpu_raytracing_tpu/ops/pallas/megakernel.py::_kernel (lines
// 912-2690, launched by mega_trace_flat through pl.pallas_call at line
// 2785).  Per ray it runs the whole Whitted shading tree: closest hit over
// BVH-ordered 128-face triangle chunks behind AABB slab culls plus analytic
// spheres, shadow rays to point and directional lights, ambient +
// Blinn-Phong shading, mirror and conductor reflection, and the dielectric
// Fresnel split with Beer attenuation (reference raytracer.cpp:65-134,
// 208-415).  The plain version beside it is ops/megakernel.py::mega_trace_ref.
//
// Design.  The scene tables and ray queries (closest hit, shadow) live in
// mega_common.cuh, shared with the path-tracing variant mega_pt.cu.  One
// thread per ray, 128 threads per block, grid over the rays.
// The TPU kernel's per-block lax.while_loop becomes a loop per thread over
// the same node sequence: one node per iteration (trace it, add its direct
// light, continue in place, push or pop), at most max_iters nodes.  The
// K-slot one-hot stack of the TPU carry becomes a per-thread array of
// K = max_depth + 2 entries (origin, direction, weight, absorption, medium,
// depth).  The scene tables (16 f32 per face, spheres, materials, lights)
// are read from global memory through the read-only path.  The TPU
// kernel's geometry, 128-face chunks swept in table order behind box culls
// (mega_whitted_kernel, FlatChunks), cost the 32,768-face scene 27.76 ms
// for one sample's 640,000 rays on the card: every chunk box tested for
// every query, 128 face tests per box entered, no early stop.  So a scene
// past one chunk launches mega_whitted_tree_kernel, which walks a tree of
// 4-wide, 128-byte nodes over 4-row leaves, nearest child first (ChunkTree,
// mega_common.cuh), and gives the flat sweep's radiance bit for bit.
//
// Bound.  FP32 arithmetic on the CUDA cores: 38 operations per
// ray x triangle test up to its t test (22 more for the barycentrics of a
// candidate), 22 per box slab test, 66 per sphere test, against the bytes
// the walk reads once (node lines, the tested rows' vertices, the winners'
// rows) and 36 bytes of rays in and out per ray — operations, not bytes,
// bound it; ops/megakernel.py::TreeWalker counts the walk's tests (PERF.md
// gives the bound and the time).  Everything is f32
// with IEEE division and sqrtf (no fast math) and, built with -fmad=false,
// in the order the plain version computes it: on the same rays the two
// differ only where libdevice's expf/logf round otherwise.

#include "mega_common.cuh"

namespace mw {

constexpr int MAX_K = 12;  // stack slots: max_depth (<= 10) + 2

// The whole shading tree of ray i; radiance to out[3i:3i+3].  G is the
// geometry: the 128-face chunks, or the tree (K1e).
template <class G>
__device__ void shade_ray(const Params& P, const float* __restrict__ o,
                          const float* __restrict__ d,
                          float* __restrict__ out, int i) {
  float cox = o[3 * i], coy = o[3 * i + 1], coz = o[3 * i + 2];
  float cdx = d[3 * i], cdy = d[3 * i + 1], cdz = d[3 * i + 2];
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  float cwx = 1.0f, cwy = 1.0f, cwz = 1.0f;
  float cax = 0.0f, cay = 0.0f, caz = 0.0f, cmed = 1.0f;
  int cdep = P.max_depth;
  const bool diel = (P.flags & FLAG_DIELECTRIC) != 0;
  const bool any_spec = (P.flags & (FLAG_MIRROR | FLAG_DIELECTRIC |
                                    FLAG_CONDUCTOR)) != 0 && P.max_depth > 0;
  const bool has_amb = P.amb[0] != 0.0f || P.amb[1] != 0.0f ||
                       P.amb[2] != 0.0f;
  const float eps = P.eps;
  // stack entry: o3 d3 w3 a3 medium (13 f32) + depth
  float stk[MAX_K][13];
  int sdep[MAX_K];
  int sp = 0;
  bool act = true;

  for (int it = 0; act && it < P.max_iters; ++it) {
    const Hit h = trace<false, NoMotion, false, G>(P, cox, coy, coz, cdx, cdy,
                                                   cdz);
    const float t_safe = h.hit ? h.t : 0.0f;
    if (diel) {  // Beer attenuation of this segment (raytracer.cpp:416-423)
      cwx = cwx * expf(-cax * t_safe);
      cwy = cwy * expf(-cay * t_safe);
      cwz = cwz * expf(-caz * t_safe);
    }
    if (!h.hit && it == 0) {  // primary miss: background
      lr += cwx * P.bg[0];
      lg += cwy * P.bg[1];
      lb += cwz * P.bg[2];
    }
    const float px = cox + t_safe * cdx;
    const float py = coy + t_safe * cdy;
    const float pz = coz + t_safe * cdz;
    const float wox = -cdx, woy = -cdy, woz = -cdz;
    const float nx = h.nx, ny = h.ny, nz = h.nz;
    const float* m = P.mat + h.mat * MAT_COLS;
    const bool inside = diel && cmed > 1.00001f;

    if (h.hit && !inside) {  // direct light (raytracer.cpp:98-100, 701-806)
      if (has_amb) {
        lr += cwx * (P.amb[0] * m[1]);
        lg += cwy * (P.amb[1] * m[2]);
        lb += cwz * (P.amb[2] * m[3]);
      }
      const float kdx = m[4], kdy = m[5], kdz = m[6];
      const float ksx = m[7], ksy = m[8], ksz = m[9];
      const float phong = m[13];
      const float sox = px + nx * eps, soy = py + ny * eps,
                  soz = pz + nz * eps;
      for (int l = 0; l < P.n_point + P.n_dir; ++l) {
        const bool point = l < P.n_point;
        const float* L = point ? P.pl + l * LIGHT_COLS
                               : P.dl + (l - P.n_point) * LIGHT_COLS;
        float wix, wiy, wiz, limit, ir, ig, ib;
        if (point) {
          const float tlx = L[0] - px, tly = L[1] - py, tlz = L[2] - pz;
          const float d2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
          limit = sqrtf(d2);
          const float inv = 1.0f / limit;
          wix = tlx * inv;
          wiy = tly * inv;
          wiz = tlz * inv;
          ir = L[3] / d2;
          ig = L[4] / d2;
          ib = L[5] / d2;
        } else {
          wix = L[0];
          wiy = L[1];
          wiz = L[2];
          limit = BIG;
          ir = L[3];
          ig = L[4];
          ib = L[5];
        }
        if (shadow<false, NoMotion, G>(P, sox, soy, soz, wix, wiy, wiz, limit))
          continue;
        // default diffuse + Blinn-Phong (raytracer.cpp:540-554)
        const float cos_t = fmaxf(0.0f, wix * nx + wiy * ny + wiz * nz);
        float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
        norm3(hx, hy, hz);
        const float cos_hm = fmaxf(0.0f, hx * nx + hy * ny + hz * nz);
        const float spec = powmax(cos_hm, phong);
        lr += cwx * ir * (kdx * cos_t + ksx * spec);
        lg += cwy * ig * (kdy * cos_t + ksy * spec);
        lb += cwz * ib * (kdz * cos_t + ksz * spec);
      }
    }

    // children: the reflection leg continues in place, refraction pushes
    bool new_act = false;
    float nox = px, noy = py, noz = pz;
    float ndx = wox, ndy = woy, ndz = woz;
    float nwx = cwx, nwy = cwy, nwz = cwz;
    float nax = 0.0f, nay = 0.0f, naz = 0.0f, nmed = 1.0f;
    const int type = static_cast<int>(m[0]);
    if (any_spec && h.hit && cdep > 0) {
      if (type == MAT_MIRROR || type == MAT_CONDUCTOR) {
        const float ndotwo = nx * wox + ny * woy + nz * woz;
        float rx = 2.0f * nx * ndotwo - wox;
        float ry = 2.0f * ny * ndotwo - woy;
        float rz = 2.0f * nz * ndotwo - woz;
        norm3(rx, ry, rz);
        float f = 1.0f;
        bool go = true;
        if (type == MAT_CONDUCTOR) {  // conductor Fresnel (208-254)
          const float n2 = m[14], k2 = m[15], cos_t = ndotwo;
          const float n2k2 = n2 * n2 + k2 * k2;
          const float two = 2.0f * n2 * cos_t;
          const float cos2 = cos_t * cos_t;
          const float rs = (n2k2 - two + cos2) / fmaxf(n2k2 + two + cos2, 1e-20f);
          const float rp = (n2k2 * cos2 - two + 1.0f) /
                           fmaxf(n2k2 * cos2 + two + 1.0f, 1e-20f);
          f = 0.5f * (rs + rp);
          go = f > 1e-4f;
        }
        if (go) {
          new_act = true;
          nox = px + nx * eps;
          noy = py + ny * eps;
          noz = pz + nz * eps;
          ndx = rx;
          ndy = ry;
          ndz = rz;
          nwx = cwx * m[10];
          nwy = cwy * m[11];
          nwz = cwz * m[12];
          if (type == MAT_CONDUCTOR) {
            nwx = nwx * f;
            nwy = nwy * f;
            nwz = nwz * f;
          }
        }
      } else if (type == MAT_DIELECTRIC) {  // Fresnel split (261-415)
        const float ior = m[14];
        const float cos0 = -(cdx * nx + cdy * ny + cdz * nz);
        const bool entering = cos0 > 0.0f;
        const float sgn = entering ? 1.0f : -1.0f;
        const float nmx = nx * sgn, nmy = ny * sgn, nmz = nz * sgn;
        const float cos_i = fabsf(cos0);
        const float n1 = entering ? cmed : ior;
        const float n2 = entering ? ior : 1.0f;
        const float ratio_n = n1 / fmaxf(n2, 1e-20f);
        const float sin2 = 1.0f - cos_i * cos_i;
        const float crit = ratio_n * ratio_n * sin2;
        const float ndw = nmx * wox + nmy * woy + nmz * woz;
        float rdx = 2.0f * nmx * ndw - wox;
        float rdy = 2.0f * nmy * ndw - woy;
        float rdz = 2.0f * nmz * ndw - woz;
        norm3(rdx, rdy, rdz);
        new_act = true;
        nox = px + nmx * eps;
        noy = py + nmy * eps;
        noz = pz + nmz * eps;
        ndx = rdx;
        ndy = rdy;
        ndz = rdz;
        if (crit > 1.0f) {  // total internal reflection: weight, medium kept
          if (cmed > 1.0001f) {
            nax = m[16];
            nay = m[17];
            naz = m[18];
          }
          nmed = cmed;
        } else {
          const float cos_p = sqrtf(fmaxf(1.0f - crit, 0.0f));
          const float n2cos = n2 * cos_i, n1cosp = n1 * cos_p;
          const float rpar = (n2cos - n1cosp) / fmaxf(n2cos + n1cosp, 1e-20f);
          const float rperp = (n1 * cos_i - n2 * cos_p) /
                              fmaxf(n1 * cos_i + n2 * cos_p, 1e-20f);
          const float r_refl = 0.5f * (rpar * rpar + rperp * rperp);
          const float r_refr = 1.0f - r_refl;
          nwx = cwx * r_refl;
          nwy = cwy * r_refl;
          nwz = cwz * r_refl;
          if (n2 > 1.00001f) {
            nax = m[16];
            nay = m[17];
            naz = m[18];
          }
          nmed = n2;
          if (sp < P.stack_k) {  // refraction leg; dropped past K, as on TPU
            float fdx = (cdx + nmx * cos_i) * ratio_n - nmx * cos_p;
            float fdy = (cdy + nmy * cos_i) * ratio_n - nmy * cos_p;
            float fdz = (cdz + nmz * cos_i) * ratio_n - nmz * cos_p;
            norm3(fdx, fdy, fdz);
            const bool fin = n2 > 1.001f;
            float* e = stk[sp];
            e[0] = px - nmx * eps;
            e[1] = py - nmy * eps;
            e[2] = pz - nmz * eps;
            e[3] = fdx;
            e[4] = fdy;
            e[5] = fdz;
            e[6] = cwx * r_refr;
            e[7] = cwy * r_refr;
            e[8] = cwz * r_refr;
            e[9] = fin ? m[16] : 0.0f;
            e[10] = fin ? m[17] : 0.0f;
            e[11] = fin ? m[18] : 0.0f;
            e[12] = n2;
            sdep[sp] = cdep - 1;
          }
          ++sp;
        }
      }
    }

    int ndep = cdep - 1;
    if (!new_act && sp > 0) {  // pop
      const int top = sp - 1;
      float e[13];
      for (int k = 0; k < 13; ++k) e[k] = top < P.stack_k ? stk[top][k] : 0.0f;
      ndep = top < P.stack_k ? sdep[top] : 0;
      nox = e[0];
      noy = e[1];
      noz = e[2];
      ndx = e[3];
      ndy = e[4];
      ndz = e[5];
      nwx = e[6];
      nwy = e[7];
      nwz = e[8];
      nax = e[9];
      nay = e[10];
      naz = e[11];
      nmed = e[12];
      --sp;
      new_act = true;
    }
    cox = nox;
    coy = noy;
    coz = noz;
    cdx = ndx;
    cdy = ndy;
    cdz = ndz;
    cwx = nwx;
    cwy = nwy;
    cwz = nwz;
    cax = nax;
    cay = nay;
    caz = naz;
    cmed = nmed;
    cdep = ndep;
    act = new_act;
  }
  out[3 * i] = lr;
  out[3 * i + 1] = lg;
  out[3 * i + 2] = lb;
}

__global__ void __launch_bounds__(THREADS)
mega_whitted_kernel(Params P, const float* __restrict__ o,
                    const float* __restrict__ d, float* __restrict__ out,
                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) shade_ray<FlatChunks>(P, o, d, out, i);
}

// K1e: the same over the tree
__global__ void __launch_bounds__(THREADS)
mega_whitted_tree_kernel(Params P, const float* __restrict__ o,
                         const float* __restrict__ d, float* __restrict__ out,
                         int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) shade_ray<ChunkTree>(P, o, d, out, i);
}

}  // namespace mw

// ---- C interface (loaded with ctypes) ----

// nodes: the tree (the K1e instantiation), or null (the chunk sweep)
extern "C" int mega_whitted_launch(
    const float* o, const float* d, float* out, int n, const float* tri,
    int n_tri, const float* chunk, int n_chunks, const float* nodes,
    const float* sph, int n_sph, const float* mat, int n_mat,
    const float* pl, int n_point, const float* dl, int n_dir,
    const float* consts, int max_depth, int stack_k, int max_iters, int flags,
    void* stream) {
  if (stack_k > mw::MAX_K || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const mw::Params P = mw::make_params(tri, n_tri, chunk, n_chunks, nodes, sph,
                                       n_sph, mat, n_mat, pl, n_point, dl,
                                       n_dir, consts, max_depth, stack_k,
                                       max_iters, flags);
  const int blocks = (n + mw::THREADS - 1) / mw::THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nodes != nullptr)
    mw::mega_whitted_tree_kernel<<<blocks, mw::THREADS, 0, st>>>(P, o, d, out,
                                                                 n);
  else
    mw::mega_whitted_kernel<<<blocks, mw::THREADS, 0, st>>>(P, o, d, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_whitted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
