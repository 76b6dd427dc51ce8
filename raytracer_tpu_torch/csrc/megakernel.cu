// Path-tracing megakernel, nearest-hit, wavefront hit and image-fetch
// kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of raytracer_tpu:
//   K1  ops/megakernel.py:370-1150  _kernel, the whole spp x bounce loop
//   K2  ops/sweep.py:491-1128       sweep_tile, the nearest hit
//   K3  ops/sweep.py:1170           fetch_winner_param, winner parameters
//   K4  ops/megakernel.py:260-357   _fetch_image, the image texel fetch
//   K5  ops/intersect_pallas.py:60  _kernel, the wavefront nearest hit
//                                   with its decoded winner parameters
// K2, K3 and K4 are __device__ functions here, called by the entry points:
//   rt_megakernel   K1 with K2, K3 and K4 inlined;
//   rt_nearest_hit  K2 + K3 over a batch of rays (no randomness), so the
//                   hit contract can be checked on the card on its own;
//   rt_hit_resolve  K5: K2 with exact triangle division + K3, the winner's
//                   material id, colour and smoothness decoded;
//   rt_fetch_image  K4 over a batch of (u, v, material) queries.
// Their plain PyTorch versions are ops/megakernel.py::mega_reference,
// ops/sweep.py::nearest_hit_reference,
// ops/intersect_cuda.py::hit_resolve_reference and
// ops/megakernel.py::fetch_image_reference. The primitive tests live in
// sweep.cuh, shared with K6 (wavefront.cu).
//
// Layout. One thread per lane slot of the TPU tile: thread g has tile
// g / 4096, row r = (g % 4096) / 128 and lane l = g % 128, and owns the
// pixpack (K) pixels tile*4096*K + (k*32 + r)*128 + l, k = 0..K-1 (the JAX
// layout, megakernel.py:435-449, with one stream of 32 rows). Each thread
// runs its own loop until its budget of spp*K samples is spent; a retired
// lane of the TPU tile loop is a no-op, so the per-lane results are the
// same. Random bits come from the counter hash that the JAX kernel uses in
// interpret mode (megakernel.py:406-417, 560-571), keyed by (frame key
// words, global tile, loop iteration, element id), so this kernel, its
// plain version and the JAX interpret-mode kernel draw the same bits.
//
// Sweep. Each thread walks the cluster arrays of pack_scene in index
// order: supers (if any), then the clusters they cover, each behind a slab
// test against the thread's own best t, then the leaf primitives; spheres
// first, triangles second, strict '<' throughout, so an exact tie keeps
// the first primitive visited. Two differences from the TPU tile sweep:
// the gate is per thread (the tile sweeps a leaf when any lane enters its
// box, so a ray that misses a padded box can still win a primitive there
// through float error on the TPU, and cannot here), and scenes with cell
// orders are walked in index order instead of the tile's near-first order
// (that changes only which of two exactly tied primitives in different
// clusters wins).
//
// What bounds it on an H100: each thread runs a long, divergent loop of
// dependent scalar float math and data-dependent branches (hit or miss,
// material, path end). It is bound by latency, occupancy and registers,
// not by bytes: the scene is ~4 KB for the RTiOW scene and stays in L1/L2,
// the card draws a small share of its power limit while it runs, and a
// frame gets faster with more threads in flight (smaller pixpack; PERF.md).
// What this first design does about that: nothing yet. It is written to
// be right first; the scene stays in global memory behind const
// __restrict__ pointers and per-pixel sums are read-modify-written in
// global memory by their owning thread.
//
// Numerics. Built with IEEE division and sqrt (no --use_fast_math: the
// NaN-on-miss sphere test and the 0/0 padding triangles need IEEE NaN
// compares) and with --fmad=false, so every product and sum rounds on its
// own like the elementwise ops of the plain PyTorch version. rsqrtf,
// sinf and cosf are the CUDA library's.
//
// K4. On the TPU the texel plane sits in VMEM (or is paged in from HBM)
// and a tile selects rows with lane gathers, because a vector lane cannot
// load from its own address. A thread here loads its texel straight from
// the (img_rows, 128) colour30 plane in global memory: one 4-byte load per
// image hit, which the L2 (50 MB) holds for every image of the suite (the
// 1024x2048 earth packs into 8 MB). The indices are clamped before the
// load, so a NaN or out-of-range UV reads a texel inside the plane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"

extern "C" {

struct RtScene {
  const float* sph_f;   // (4, n_sph): centre x, y, z, |c|^2 - r^2
  const int* sph_i;     // (2, n_sph): colour30, smooth8 << 16 | mat
  const float* tri_f;   // (24, n_tri): Woop u, v, w rows, normal, cull, uv
  const int* tri_i;     // (2, n_tri)
  const float* sph_cl;  // (n, 8) leaf clusters [min3, max3, start, count]
  const float* tri_cl;
  const float* sph_sup;  // (n, 8) supers [min3, max3, first, count]
  const float* tri_sup;
  const float* sphp_f;  // (3 * rows_s, 128) winner centre planes
  const int* sphp_i;    // (2 * rows_s, 128)
  const float* trip_f;  // (3|9 * rows_t, 128) winner normal [+ uv] planes
  const int* trip_i;    // (2 * rows_t, 128)
  int n_sph, n_tri, n_sph_cl, n_tri_cl, n_sph_sup, n_tri_sup;
  int sph_leaf, tri_leaf, rows_s, rows_t;
  int has_one_way, needs_tri_uv;
};

struct RtHitArgs {
  RtScene scene;
  const float* o[3];
  const float* d[3];  // unit directions
  void* out[9];       // t, code, u, v, n0, n1, n2, pa, pb
  int n;
};

struct RtResolveArgs {
  RtScene scene;
  const float* o[3];
  const float* d[3];  // unit directions
  // t, code, u, v, n0, n1, n2, mat, colour r, g, b, smoothness
  void* out[12];
  int n;
};

struct RtMegaArgs {
  RtScene scene;
  const float* o[3];  // primary rays, n_tiles * 4096 * pixpack each
  const float* d[3];  // unit directions
  float* out[5];      // mean r, g, b, segments (on pixel block 0), depth
  const float* mat;   // (16, n_mat) material rows (pack_materials)
  int n_mat;
  const int* tex;     // (img_rows, 128) colour30 texel plane
  int img_rows;       // 0: no image texture
  unsigned int seed_w0, seed_w1;
  int tile_offset, n_tiles, pixpack, spp, limit;
  int antialias, rr_start, emissive_terminates, fix_exit_ior;
  int need_sphere_uv, has_refractive;
  float inv_spp;
  float sky[3];
};

struct RtFetchArgs {
  const int* tex;     // (img_rows, 128) colour30 texel plane
  int img_rows;
  const float* mat;   // (16, n_mat) material rows
  int n_mat;
  const float* u;
  const float* v;
  const int* mat_id;  // clamped to [0, n_mat)
  float* out[3];      // r, g, b
  int n;
};

}  // extern "C"

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 32;
constexpr int kTileLanes = kRows * kLanes;  // lane slots per tile
constexpr uint32_t kGolden = 0x9E3779B9u;   // int32 -1640531527
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kTwoPi = 6.28318530717958647692f;

// material rows (megakernel.py:130-132)
enum { M_TYPE, M_IOR, M_EMR, M_EMG, M_EMB, M_TEXTYPE, M_LR, M_LG, M_LB,
       M_DR, M_DG, M_DB, M_NSQ, M_TW, M_TH, M_TROW };
constexpr float kMatEmissive = 1.0f;
constexpr float kMatRefractive = 2.0f;
constexpr float kTexGradient = 1.0f;
constexpr float kTexChecker = 2.0f;
constexpr float kTexImage = 3.0f;

struct Winner {
  float u, v, n0, n1, n2;
  int pa, pb;
};

// Sphere i (sweep.py:821-860): half-b quadratic, NaN on a miss.
__device__ __forceinline__ void sphere_test(const RtScene& s, int i,
                                            const Ray& r, float ddo,
                                            float osq, Hit& h) {
  const float t = sphere_t(s.sph_f + i, s.n_sph, r, ddo, osq);
  if (t > kEps && t < h.t) {
    h.t = t;
    h.code = 2 * i;
  }
}

// Triangle k (sweep.py:961-1032): Woop rows, one-way cull; FAST_DIV or
// exact division.
template <bool kFastDiv>
__device__ __forceinline__ void triangle_test(const RtScene& s, int k,
                                              const Ray& r, Hit& h) {
  float t, u, v;
  const bool valid =
      triangle_t<kFastDiv>(s.tri_f + k, s.n_tri, r, s.has_one_way, t, u, v);
  if (valid && t < h.t) {
    h.t = t;
    h.code = 2 * k + 1;
    h.bu = u;
    h.bv = v;
  }
}

// One pool: supers -> clusters -> leaves when the scene has them, else
// every slot in order. Each box is gated per thread.
template <bool kTri, bool kFastDiv>
__device__ void sweep_pool(const RtScene& s, const Ray& r, float ddo,
                           float osq, float ix, float iy, float iz, Hit& h) {
  const float* __restrict__ cl = kTri ? s.tri_cl : s.sph_cl;
  const float* __restrict__ sup = kTri ? s.tri_sup : s.sph_sup;
  const int n_cl = kTri ? s.n_tri_cl : s.n_sph_cl;
  const int n_sup = kTri ? s.n_tri_sup : s.n_sph_sup;
  const int leaf = kTri ? s.tri_leaf : s.sph_leaf;
  const int n_prim = kTri ? s.n_tri : s.n_sph;
  auto leaf_sweep = [&](int c) {
    for (int i = c * leaf; i < (c + 1) * leaf; ++i) {
      if (kTri) {
        triangle_test<kFastDiv>(s, i, r, h);
      } else {
        sphere_test(s, i, r, ddo, osq, h);
      }
    }
  };
  if (n_sup > 0) {
    for (int g = 0; g < n_sup; ++g) {
      const float* box = sup + 8 * g;
      if (!slab(box, r, ix, iy, iz, h.t)) continue;
      const int first = static_cast<int>(box[6]);
      const int count = static_cast<int>(box[7]);
      for (int c = first; c < first + count; ++c) {
        if (slab(cl + 8 * c, r, ix, iy, iz, h.t)) leaf_sweep(c);
      }
    }
  } else if (n_cl > 0) {
    for (int c = 0; c < n_cl; ++c) {
      if (slab(cl + 8 * c, r, ix, iy, iz, h.t)) leaf_sweep(c);
    }
  } else {
    for (int i = 0; i < n_prim; ++i) {
      if (kTri) {
        triangle_test<kFastDiv>(s, i, r, h);
      } else {
        sphere_test(s, i, r, ddo, osq, h);
      }
    }
  }
}

// K2: nearest hit of a unit-direction ray.
template <bool kFastDiv>
__device__ Hit nearest(const RtScene& s, const Ray& r) {
  const float ddo = r.dx * r.ox + r.dy * r.oy + r.dz * r.oz;
  const float osq = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  Hit h{kInf, 0, 0.0f, 0.0f};
  sweep_pool<false, kFastDiv>(s, r, ddo, osq, ix, iy, iz, h);
  sweep_pool<true, kFastDiv>(s, r, ddo, osq, ix, iy, iz, h);
  return h;
}

// K3: the winner's centre or normal, colour30, smooth|mat and texture UV
// (megakernel.py:651-701 over pack_param_planes).
__device__ Winner fetch_winner(const RtScene& s, const Hit& h) {
  const int prim = h.code >> 1;
  Winner w;
  if (h.code & 1) {
    const int plane = s.rows_t * kLanes;
    w.n0 = s.trip_f[prim];
    w.n1 = s.trip_f[plane + prim];
    w.n2 = s.trip_f[2 * plane + prim];
    w.pa = s.trip_i[prim];
    w.pb = s.trip_i[plane + prim];
    if (s.needs_tri_uv) {
      const float* __restrict__ uv = s.trip_f + 3 * plane + prim;
      const float wb = 1.0f - h.bu - h.bv;
      w.u = uv[0] * wb + uv[2 * plane] * h.bu + uv[4 * plane] * h.bv;
      w.v = uv[plane] * wb + uv[3 * plane] * h.bu + uv[5 * plane] * h.bv;
    } else {
      w.u = 0.0f;
      w.v = 0.0f;
    }
  } else {
    const int plane = s.rows_s * kLanes;
    w.n0 = s.sphp_f[prim];
    w.n1 = s.sphp_f[plane + prim];
    w.n2 = s.sphp_f[2 * plane + prim];
    w.pa = s.sphp_i[prim];
    w.pb = s.sphp_i[plane + prim];
    w.u = 0.0f;
    w.v = 0.0f;
  }
  return w;
}

// The interpret-mode counter hash (megakernel.py:564-570), stream salt 0.
__device__ __forceinline__ uint32_t hash_bits(uint32_t itc, uint32_t elem,
                                              uint32_t w0, uint32_t w1) {
  uint32_t x = (itc * kGolden + elem) ^ w0;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = x + w1;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float uni(uint32_t b) {
  return static_cast<float>(b & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

// 8-bit antialias jitter from the top byte (AA_PACK, megakernel.py:589-596)
__device__ __forceinline__ float aa_jitter(uint32_t b) {
  const float j = static_cast<float>((b >> 24) & 0xFFu) * (1.0f / 256.0f) +
                  (0.5f / 256.0f);
  return (j - 0.5f) * 0.002f;
}

// Abramowitz-Stegun arcsin (megakernel.py:359-367)
__device__ __forceinline__ float asin_as(float x) {
  const float ax = fabsf(x);
  const float r =
      1.5707288f + ax * (-0.2121144f + ax * (0.0742610f + ax * -0.0187293f));
  const float v = kHalfPi - sqrtf(fmaxf(1.0f - ax, 0.0f)) * r;
  return x < 0.0f ? -v : v;
}

__device__ __forceinline__ float clip1(float x) {
  return fminf(fmaxf(x, -1.0f), 1.0f);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// K4: the nearest texel of (uu, vv) in the image of width mtw and height
// mth whose rows start at mtrow (megakernel.py:282-292). Float-to-int is
// XLA's convert: toward zero, saturating, NaN -> 0 (__float2int_rz).
__device__ __forceinline__ int fetch_texel(const int* __restrict__ tex,
                                           int img_rows, float uu, float vv,
                                           float mtw, float mth,
                                           float mtrow) {
  const int w_i = __float2int_rz(mtw);
  const int u_i = clampi(__float2int_rz((mtw - 1.0f) * uu), 0,
                         max(w_i - 1, 0));
  const int v_i = clampi(__float2int_rz((mth - 1.0f) * vv), 0,
                         max(__float2int_rz(mth) - 1, 0));
  const int nb = (w_i + (kLanes - 1)) >> 7;  // column blocks per image row
  const int ty = clampi(__float2int_rz(mtrow) + v_i * nb + (u_i >> 7), 0,
                        img_rows - 1);
  return tex[ty * kLanes + (u_i & (kLanes - 1))];
}

__global__ void __launch_bounds__(128)
    nearest_hit_kernel(const RtHitArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray r{a.o[0][i], a.o[1][i], a.o[2][i],
              a.d[0][i], a.d[1][i], a.d[2][i]};
  const Hit h = nearest<true>(a.scene, r);
  const Winner w = fetch_winner(a.scene, h);
  static_cast<float*>(a.out[0])[i] = h.t;
  static_cast<int*>(a.out[1])[i] = h.code;
  static_cast<float*>(a.out[2])[i] = w.u;
  static_cast<float*>(a.out[3])[i] = w.v;
  static_cast<float*>(a.out[4])[i] = w.n0;
  static_cast<float*>(a.out[5])[i] = w.n1;
  static_cast<float*>(a.out[6])[i] = w.n2;
  static_cast<int*>(a.out[7])[i] = w.pa;
  static_cast<int*>(a.out[8])[i] = w.pb;
}

// K5 (intersect_pallas.py:60-120): the nearest hit with exact triangle
// division, the winner's parameters and its decoded material; a miss
// keeps the sweep's zero carry.
__global__ void __launch_bounds__(128)
    hit_resolve_kernel(const RtResolveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray r{a.o[0][i], a.o[1][i], a.o[2][i],
              a.d[0][i], a.d[1][i], a.d[2][i]};
  const Hit h = nearest<false>(a.scene, r);
  Winner w = fetch_winner(a.scene, h);
  if (!(h.t < kInf)) w = Winner{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0};
  static_cast<float*>(a.out[0])[i] = h.t;
  static_cast<int*>(a.out[1])[i] = h.code;
  static_cast<float*>(a.out[2])[i] = w.u;
  static_cast<float*>(a.out[3])[i] = w.v;
  static_cast<float*>(a.out[4])[i] = w.n0;
  static_cast<float*>(a.out[5])[i] = w.n1;
  static_cast<float*>(a.out[6])[i] = w.n2;
  static_cast<int*>(a.out[7])[i] = w.pb & 0xFFFF;
  static_cast<float*>(a.out[8])[i] = c30(w.pa, 20);
  static_cast<float*>(a.out[9])[i] = c30(w.pa, 10);
  static_cast<float*>(a.out[10])[i] = c30(w.pa, 0);
  static_cast<float*>(a.out[11])[i] =
      static_cast<float>((w.pb >> 16) & 255) * (1.0f / 255.0f);
}

// K4 alone, one thread per query.
__global__ void __launch_bounds__(128) fetch_image_kernel(const RtFetchArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int nm = a.n_mat;
  const int mid = clampi(a.mat_id[i], 0, nm - 1);
  const int texel =
      fetch_texel(a.tex, a.img_rows, a.u[i], a.v[i], a.mat[M_TW * nm + mid],
                  a.mat[M_TH * nm + mid], a.mat[M_TROW * nm + mid]);
  a.out[0][i] = c30(texel, 20);
  a.out[1][i] = c30(texel, 10);
  a.out[2][i] = c30(texel, 0);
}

// K1 (megakernel.py:370-1150), one thread per lane slot.
__global__ void __launch_bounds__(128) megakernel(const RtMegaArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= a.n_tiles * kTileLanes) return;
  const RtScene& s = a.scene;
  const int tile = g / kTileLanes;
  const int rl = g % kTileLanes;  // r * 128 + l
  const int K = a.pixpack;
  const int spp = a.spp;
  const int budget = spp * K;
  const int base = tile * kTileLanes * K + rl;  // pixel of block k: + k*4096
  const uint32_t w0 = a.seed_w0;
  const uint32_t w1 =
      a.seed_w1 + static_cast<uint32_t>(a.tile_offset + tile) * kGolden;
  float* __restrict__ out_r = a.out[0];
  float* __restrict__ out_g = a.out[1];
  float* __restrict__ out_b = a.out[2];
  float* __restrict__ out_depth = a.out[4];
  const float* __restrict__ mat = a.mat;
  const int nm = a.n_mat;

  for (int k = 0; k < K; ++k) {
    const int p = base + k * kTileLanes;
    out_r[p] = 0.0f;
    out_g[p] = 0.0f;
    out_b[p] = 0.0f;
    out_depth[p] = kInf;
  }

  Ray ray{a.o[0][base], a.o[1][base], a.o[2][base],
          a.d[0][base], a.d[1][base], a.d[2][base]};
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;  // throughput
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;  // path radiance
  float ior = 1.0f;
  float segs = 0.0f;
  int bounce = 0, sample = 0, cur_k = 0;
  uint32_t itc = 0;

  while (sample < budget) {
    ++itc;
    segs += 1.0f;
    const uint32_t b0 = hash_bits(itc, rl, w0, w1);
    const uint32_t b1 = hash_bits(itc, kTileLanes + rl, w0, w1);
    const uint32_t b2 = hash_bits(itc, 2 * kTileLanes + rl, w0, w1);

    if (a.antialias) {
      ray.dx = ray.dx + aa_jitter(b0);
      ray.dy = ray.dy + aa_jitter(b1);
      ray.dz = ray.dz + aa_jitter(b2);
      const float inv =
          rsqrtf(ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz);
      ray.dx = ray.dx * inv;
      ray.dy = ray.dy * inv;
      ray.dz = ray.dz * inv;
    }
    // uniform direction on the sphere (megakernel.py:616-622)
    const float z = 2.0f * uni(b0) - 1.0f;
    const float phi = kTwoPi * uni(b1);
    const float rs = sqrtf(fmaxf(1.0f - z * z, 0.0f));
    const float gx = rs * cosf(phi), gy = rs * sinf(phi), gz = z;
    const float fres_u = uni(b2);

    const Hit h = nearest<true>(s, ray);
    const bool hit = h.t < kInf;
    if (bounce == 0 && sample == cur_k * spp) {
      out_depth[base + cur_k * kTileLanes] = h.t;
    }

    bool continues = false;
    if (!hit) {
      rr = rr + tr * a.sky[0];
      rg = rg + tg * a.sky[1];
      rb = rb + tb * a.sky[2];
    } else {
      const Winner w = fetch_winner(s, h);
      const bool is_tri = h.code & 1;
      const float msm =
          static_cast<float>((w.pb >> 16) & 255) * (1.0f / 255.0f);
      const int mid = w.pb & 0xFFFF;
      const float px = ray.ox + ray.dx * h.t;
      const float py = ray.oy + ray.dy * h.t;
      const float pz = ray.oz + ray.dz * h.t;
      // sphere normal (p - c) / |p - c|; triangle normal flipped against
      // the ray (src/objects.cu:66, 158)
      const float rx = px - w.n0, ry = py - w.n1, rz = pz - w.n2;
      const float rmag = rsqrtf(fmaxf(rx * rx + ry * ry + rz * rz, 1e-24f));
      float sph_u = 0.0f, sph_v = 0.0f;
      if (a.need_sphere_uv) {
        const float theta = asin_as(clip1(ry * rmag));
        const float phi_s = kHalfPi - asin_as(clip1(rx * rmag));
        // torch divides a tensor by a scalar as a product with the
        // scalar's float32 reciprocal; so does this
        sph_u = (theta + kHalfPi) * (1.0f / kPi);
        const float v_ratio = (1.0f - phi_s * (1.0f / kPi)) * 0.5f;
        const float behind = pz > w.n2 ? 1.0f : 0.0f;
        sph_v = behind + (1.0f - 2.0f * behind) * v_ratio;
      }
      const float ndd = w.n0 * ray.dx + w.n1 * ray.dy + w.n2 * ray.dz;
      const float flip = ndd > 0.0f ? -1.0f : 1.0f;
      const float nx = is_tri ? w.n0 * flip : rx * rmag;
      const float ny = is_tri ? w.n1 * flip : ry * rmag;
      const float nz = is_tri ? w.n2 * flip : rz * rmag;
      const float uu = is_tri ? w.u : sph_u;
      const float vv = is_tri ? w.v : sph_v;

      const float mtype = mat[M_TYPE * nm + mid];
      const float mior = mat[M_IOR * nm + mid];
      const float mtt = mat[M_TEXTYPE * nm + mid];
      const float mnsq = mat[M_NSQ * nm + mid];

      // texture colour: checker / gradient / image / const
      // (megakernel.py:826-863)
      float tex_r, tex_g, tex_b;
      if (mtt == kTexChecker) {
        const int u_c = static_cast<int>(uu * mnsq);
        const int v_c = static_cast<int>(vv * mnsq);
        const int row = ((u_c + v_c) % 2) == 0 ? M_LR : M_DR;
        tex_r = mat[row * nm + mid];
        tex_g = mat[(row + 1) * nm + mid];
        tex_b = mat[(row + 2) * nm + mid];
      } else if (mtt == kTexGradient) {
        tex_r = uu;
        tex_g = vv;
        tex_b = 0.0f;
      } else if (mtt == kTexImage && a.img_rows > 0) {
        const int texel = fetch_texel(
            a.tex, a.img_rows, uu, vv, mat[M_TW * nm + mid],
            mat[M_TH * nm + mid], mat[M_TROW * nm + mid]);
        tex_r = c30(texel, 20);
        tex_g = c30(texel, 10);
        tex_b = c30(texel, 0);
      } else {
        tex_r = c30(w.pa, 20);
        tex_g = c30(w.pa, 10);
        tex_b = c30(w.pa, 0);
      }

      // radiance bookkeeping, emissive quirk (megakernel.py:865-880)
      const bool is_em = mtype == kMatEmissive;
      if (is_em) {
        rr = rr + tr * mat[M_EMR * nm + mid];
        rg = rg + tg * mat[M_EMG * nm + mid];
        rb = rb + tb * mat[M_EMB * nm + mid];
      } else {
        tr = tr * tex_r;
        tg = tg * tex_g;
        tb = tb * tex_b;
      }

      // scatter (megakernel.py:883-961)
      const float gdotn = gx * nx + gy * ny + gz * nz;
      const float gflip = gdotn < 0.0f ? -1.0f : 1.0f;
      const float ax = nx + gx * gflip;
      const float ay = ny + gy * gflip;
      const float az = nz + gz * gflip;
      const float dinv = rsqrtf(2.0f + 2.0f * fabsf(gdotn));
      const float dfx = ax * dinv, dfy = ay * dinv, dfz = az * dinv;
      const float ddn = ray.dx * nx + ray.dy * ny + ray.dz * nz;
      const float sx = ray.dx - 2.0f * ddn * nx;
      const float sy = ray.dy - 2.0f * ddn * ny;
      const float sz = ray.dz - 2.0f * ddn * nz;
      float refx = dfx + (sx - dfx) * msm;
      float refy = dfy + (sy - dfy) * msm;
      float refz = dfz + (sz - dfz) * msm;
      const float rinv =
          rsqrtf(fmaxf(refx * refx + refy * refy + refz * refz, 1e-24f));
      refx = refx * rinv;
      refy = refy * rinv;
      refz = refz * rinv;
      float ndx = refx, ndy = refy, ndz = refz;
      if (a.has_refractive) {
        const bool exiting = ddn > 0.0f;
        const float n1 = exiting ? mior : ior;
        const float exit_ior = a.fix_exit_ior ? 1.0f : ior;
        const float n2 = exiting ? exit_ior : mior;
        const float sgn = exiting ? 1.0f : -1.0f;
        const float rnx = nx * sgn, rny = ny * sgn, rnz = nz * sgn;
        const float cos1 =
            fminf(ray.dx * rnx + ray.dy * rny + ray.dz * rnz, 1.0f);
        const float sin1 = sqrtf(fmaxf(1.0f - cos1 * cos1, 0.0f));
        const float sin2 = fminf(n1 * sin1 / n2, 1.0f);
        const float cos2 = sqrtf(fmaxf(1.0f - sin2 * sin2, 0.0f));
        const bool tir = sin1 * n1 > n2;
        const float sq0 = (n1 - n2) / (n1 + n2);
        const float r0 = sq0 * sq0;
        const float mm = 1.0f - cos1;
        const float m2 = mm * mm;
        const float refl = r0 + (1.0f - r0) * (m2 * m2 * mm);
        const bool do_reflect = tir || (refl > fres_u);
        const float inv_s1 = sin1 == 0.0f ? 0.0f : 1.0f / sin1;
        const float pfx = (ray.dx - rnx * cos1) * inv_s1;
        const float pfy = (ray.dy - rny * cos1) * inv_s1;
        const float pfz = (ray.dz - rnz * cos1) * inv_s1;
        const bool is_refr = mtype == kMatRefractive;
        if (is_refr && !do_reflect) {
          ndx = rnx * cos2 + pfx * sin2;
          ndy = rny * cos2 + pfy * sin2;
          ndz = rnz * cos2 + pfz * sin2;
        }
        const bool ior_upd =
            a.fix_exit_ior ? (is_refr && !do_reflect) : is_refr;
        if (ior_upd) ior = n2;
      }
      ray = Ray{px, py, pz, ndx, ndy, ndz};

      continues = !(a.emissive_terminates && is_em);
      if (a.rr_start > 0) {
        // russian roulette (megakernel.py:988-1003), 4th draw row
        const float rr_u =
            uni(hash_bits(itc, 3 * kTileLanes + rl, w0, w1));
        const float p = fminf(fmaxf(fmaxf(tr, fmaxf(tg, tb)), 0.05f), 1.0f);
        const bool eligible = continues && (bounce + 1 >= a.rr_start);
        const bool survive = rr_u < p;
        if (eligible && survive) {
          const float inv_p = 1.0f / p;
          tr = tr * inv_p;
          tg = tg * inv_p;
          tb = tb * inv_p;
        }
        continues = continues && (!eligible || survive);
      }
    }

    if (!continues || bounce + 1 >= a.limit) {
      // bank the path into its pixel, regenerate onto the next sample
      const int p = base + cur_k * kTileLanes;
      out_r[p] = out_r[p] + rr;
      out_g[p] = out_g[p] + rg;
      out_b[p] = out_b[p] + rb;
      ++sample;
      bounce = 0;
      if (sample == (cur_k + 1) * spp) cur_k = min(cur_k + 1, K - 1);
      const int q = base + cur_k * kTileLanes;
      ray = Ray{a.o[0][q], a.o[1][q], a.o[2][q],
                a.d[0][q], a.d[1][q], a.d[2][q]};
      tr = tg = tb = 1.0f;
      rr = rg = rb = 0.0f;
      ior = 1.0f;
    } else {
      ++bounce;
    }
  }

  for (int k = 0; k < K; ++k) {
    const int p = base + k * kTileLanes;
    out_r[p] = out_r[p] * a.inv_spp;
    out_g[p] = out_g[p] * a.inv_spp;
    out_b[p] = out_b[p] * a.inv_spp;
    a.out[3][p] = k == 0 ? segs : 0.0f;
  }
}

}  // namespace

extern "C" {

int rt_nearest_hit(const RtHitArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int blocks = (args->n + 127) / 128;
  nearest_hit_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

int rt_hit_resolve(const RtResolveArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int blocks = (args->n + 127) / 128;
  hit_resolve_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

int rt_fetch_image(const RtFetchArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int blocks = (args->n + 127) / 128;
  fetch_image_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

int rt_megakernel(const RtMegaArgs* args, void* stream) {
  if (args->n_tiles <= 0) return 0;
  const int blocks = args->n_tiles * kTileLanes / 128;
  megakernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
