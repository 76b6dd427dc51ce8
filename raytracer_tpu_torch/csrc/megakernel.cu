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
//                   hit contract can be checked on the card on its own,
//                   with the same group walk as K1;
//   rt_hit_resolve  K5: K2 with exact triangle division + K3, G threads a
//                   ray (ops/intersect_cuda.py resolve_group), the winner's
//                   material id, colour and smoothness decoded; with a
//                   stats pointer, also each ray's primitive-test count
//                   (K5's with_stats arm, intersect_pallas.py:74-105);
//                   with a sample pointer (the regen loop's), a finished
//                   lane is skipped;
//   rt_fetch_image  K4 over a batch of (u, v, material) queries.
// Their plain PyTorch versions are ops/megakernel.py::mega_reference,
// ops/sweep.py::nearest_hit_reference,
// ops/intersect_cuda.py::hit_resolve_reference (the counts:
// primitive_tests_reference) and ops/megakernel.py::fetch_image_reference.
// The primitive tests and the group walk live in sweep.cuh, shared with
// K6 (wavefront.cu).
//
// Layout. A group of G consecutive threads of a warp (G = 1, 2, 4 or 8,
// a template parameter the wrapper picks by a rule) shares one lane slot
// of the TPU tile: group g has tile g / 4096, row r = (g % 4096) / 128 and
// lane l = g % 128, and owns the pixpack (K) pixels
// tile*4096*K + (k*32 + r)*128 + l, k = 0..K-1 (the JAX layout,
// megakernel.py:435-449, with one stream of 32 rows). Each group runs its
// own loop until its budget of spp*K samples is spent; a retired lane of
// the TPU tile loop is a no-op, so the per-lane results are the same.
// Every thread of a group carries the same path state and computes the
// same hashes; only the group's leader (rank 0) writes the outputs. Random
// bits come from the counter hash that the JAX kernel uses in interpret
// mode (megakernel.py:406-417, 560-571), keyed by (frame key words, global
// tile, loop iteration, element id), so this kernel, its plain version and
// the JAX interpret-mode kernel draw the same bits. Coherent sampling
// (megakernel.py:525-559, 636) keys the draw by the tile alone: every
// thread of a tile hashes the same seven elements of an iteration (lane 0
// of an 8-row draw) and so scatters alike after a bounce.
//
// Sweep (K2, `nearest`). The group walks the cluster arrays of pack_scene
// with sweep.cuh's walk_pool: spheres first, triangles second, each pool
// in index order (supers, their clusters, the leaf primitives), the boxes
// of a level slab-tested G at a time and a leaf's primitives strided over
// the group and merged. In that order the first hit is the plain
// version's argmin, where an exact tie goes to the sphere, then to the
// lower index (ops/sweep.py:301-325), at every G. The gate is per group
// (the TPU tile sweeps a leaf when any lane enters its box, so a ray that
// misses a padded box can still win a primitive there through float error
// on the TPU, and cannot here). K5 runs the same walk, with exact triangle
// division and, in its counting arm, the primitive tests of the clusters
// the group enters, which are the one-thread walk's. Alone (K2, K5) the
// walk is bound by each ray's dependent chain of box and primitive tests,
// not by bytes: the pools stay in L2 (stress100k's 2.4 MB too). G threads
// a ray cut that chain by about G where the card has threads to spare;
// the wrappers' rules (sweep.nearest_group, intersect_cuda.resolve_group)
// take G from the rays, the arm's resident threads and the gate depth.
//
// What bounds it on an H100: each lane slot runs a long, divergent loop of
// dependent scalar float math and data-dependent branches (hit or miss,
// material, path end). It is bound by latency, occupancy and registers,
// not by bytes: the scene is ~4 KB for the RTiOW scene and stays in L1/L2.
// What the design does about that: at the Renderer's pixpack of 8 a
// 1000x800 frame has only 102,400 lane slots, fewer than the card keeps
// resident, so G threads share each slot: G times the threads without
// changing any random stream, and the slot's serial chain of box and
// primitive tests cut by about G, at the price of G copies of the shading.
// The deeper the scene's gates, the more the split pays, so the wrapper's
// rule takes G from the lane slots, the resident threads and the gate
// depth (ops/megakernel.py mega_group). The walk stays in index order
// because the groups of a warp then load the same boxes and primitives at
// once: a near-first walk (boxes sorted by entry distance per group) was
// slower on the K1 paths measured (PERF.md). Registers are capped at 72 so
// that 7 blocks of an SM stay resident. Per-pixel sums stay in registers and are
// written once per pixel.
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
  int group;          // threads per ray: 1, 2, 4 or 8
};

struct RtResolveArgs {
  RtScene scene;
  const float* o[3];
  const float* d[3];  // unit directions
  // t, code, u, v, n0, n1, n2, mat, colour r, g, b, smoothness
  void* out[12];
  float* stats;  // per-ray primitive tests (K5's with_stats), or null
  // (n,) the regen lanes' sample index, or null: a lane with
  // sample >= spp is finished and skipped, its outputs left as they were
  const int* sample;
  int spp;
  int n;
  int group;     // threads per ray: 1, 2, 4 or 8
};

// K6's instance at group size `group` (csrc/wavefront.cu), for
// rt_occupancy; null for another group.
const void* rt_blocked_kernel(int group);

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
  int need_sphere_uv, has_refractive, coherent;
  float inv_spp;
  float sky[3];
  int group;  // threads per lane slot: 1, 2, 4 or 8
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

// The scene's resident pools, spheres then triangles: in that visit order
// the first hit is the plain version's winner in the order (t,
// is_triangle, primitive index) (ops/sweep.py:301-325).
__device__ __forceinline__ Pool sphere_pool(const RtScene& s) {
  return Pool{s.sph_f, s.n_sph, s.sph_cl, s.sph_sup, s.n_sph_cl,
              s.n_sph_sup, s.n_sph, s.sph_leaf, 0};
}

__device__ __forceinline__ Pool triangle_pool(const RtScene& s) {
  return Pool{s.tri_f, s.n_tri, s.tri_cl, s.tri_sup, s.n_tri_cl,
              s.n_tri_sup, s.n_tri, s.tri_leaf, 0};
}

// K2 for a group of G threads (sweep.cuh walk_pool): every thread returns
// the plain version's winner. kFastDiv: K1's and rt_nearest_hit's
// triangle reciprocal; exact division for K5. kStats counts the ray's
// primitive tests into ``tests``.
template <int G, bool kFastDiv, bool kStats>
__device__ Hit nearest(const RtScene& s, const Ray& r, const Group<G>& grp,
                       float& tests) {
  const Probe q = probe(r);
  Hit h{kInf, 0, 0.0f, 0.0f};
  walk_pool<false, kFastDiv, kStats>(sphere_pool(s), r, q, false, h, grp,
                                     tests);
  walk_pool<true, kFastDiv, kStats>(triangle_pool(s), r, q, s.has_one_way,
                                    h, grp, tests);
  return h;
}

// K2 as K1 and rt_nearest_hit run it: FAST_DIV triangles, no counters.
template <int G>
__device__ __forceinline__ Hit nearest_group(const RtScene& s, const Ray& r,
                                             const Group<G>& grp) {
  float unused = 0.0f;
  return nearest<G, true, false>(s, r, grp, unused);
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

// antialias direction jitter of a uniform u in [0, 1): (u - 0.5) * 2e-3
__device__ __forceinline__ float jitter(float u) {
  return (u - 0.5f) * 0.002f;
}

// 8-bit uniform from the top byte (AA_PACK, megakernel.py:589-596)
__device__ __forceinline__ float aa_byte(uint32_t b) {
  return static_cast<float>((b >> 24) & 0xFFu) * (1.0f / 256.0f) +
         (0.5f / 256.0f);
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

// K2 + K3 over a batch of rays, G threads a ray.
template <int G>
__global__ void __launch_bounds__(kBlock)
    nearest_hit_kernel(const RtHitArgs a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= a.n) return;  // whole groups: the G threads share i
  const Ray r{a.o[0][i], a.o[1][i], a.o[2][i],
              a.d[0][i], a.d[1][i], a.d[2][i]};
  const Group<G> grp = this_group<G>();
  const Hit h = nearest_group<G>(a.scene, r, grp);
  if (grp.rank != 0) return;
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

// K5 (intersect_pallas.py:60-120), G threads a ray: the nearest hit with
// exact triangle division, the winner's parameters and its decoded
// material; a miss keeps the sweep's zero carry. kStats also writes the
// ray's primitive tests, so the plain launch pays nothing for the
// counters. kMask (the regen loop's launch) skips a finished lane,
// sample[i] >= spp: rt_wave_bounce reads none of its outputs, so the
// group returns before it loads the ray, walks or writes; the other
// callers' instances keep their code.
template <int G, bool kStats, bool kMask>
__global__ void __launch_bounds__(kBlock)
    hit_resolve_kernel(const RtResolveArgs a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= a.n) return;  // whole groups: the G threads share i
  if (kMask && a.sample[i] >= a.spp) return;  // whole groups too
  const Ray r{a.o[0][i], a.o[1][i], a.o[2][i],
              a.d[0][i], a.d[1][i], a.d[2][i]};
  const Group<G> grp = this_group<G>();
  float tests = 0.0f;
  const Hit h = nearest<G, false, kStats>(a.scene, r, grp, tests);
  if (grp.rank != 0) return;
  if (kStats) a.stats[i] = tests;
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

// Blocks of kBlock threads an SM must keep resident for K1: it caps the
// registers at 72 (28 warps an SM, against 24 at the 80 registers an
// uncapped G = 1 takes), with no spill at G = 1 (ptxas -v; PERF.md).
constexpr int kMegaMinBlocks = 7;

// K1 (megakernel.py:370-1150), G threads per lane slot.
template <int G>
__global__ void __launch_bounds__(kBlock, kMegaMinBlocks)
    megakernel(const RtMegaArgs a) {
  const RtScene& s = a.scene;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (g >= a.n_tiles * kTileLanes) return;  // whole groups
  const Group<G> grp = this_group<G>();
  const bool leader = grp.rank == 0;
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

  if (leader) {
    for (int k = 0; k < K; ++k) {
      const int p = base + k * kTileLanes;
      out_r[p] = 0.0f;
      out_g[p] = 0.0f;
      out_b[p] = 0.0f;
      out_depth[p] = kInf;
    }
  }

  Ray ray{a.o[0][base], a.o[1][base], a.o[2][base],
          a.d[0][base], a.d[1][base], a.d[2][base]};
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;  // throughput
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;  // path radiance
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;  // the pixel's banked sum
  float ior = 1.0f;
  float segs = 0.0f;
  int bounce = 0, sample = 0, cur_k = 0;
  uint32_t itc = 0;
  // draw row k of this lane slot is element k * 4096 + rl; with coherent,
  // every thread of the tile reads its lane 0, element k * 128
  const uint32_t row = a.coherent ? kLanes : kTileLanes;
  const uint32_t lane = a.coherent ? 0 : rl;

  while (sample < budget) {
    ++itc;
    segs += 1.0f;
    const uint32_t b0 = hash_bits(itc, lane, w0, w1);
    const uint32_t b1 = hash_bits(itc, row + lane, w0, w1);
    const uint32_t b2 = hash_bits(itc, 2 * row + lane, w0, w1);

    if (a.antialias) {
      // the top bytes of rows 0-2 (AA_PACK), or coherent rows 3-5 at full
      // 24-bit precision
      float ux, uy, uz;
      if (a.coherent) {
        ux = uni(hash_bits(itc, 3 * kLanes, w0, w1));
        uy = uni(hash_bits(itc, 4 * kLanes, w0, w1));
        uz = uni(hash_bits(itc, 5 * kLanes, w0, w1));
      } else {
        ux = aa_byte(b0);
        uy = aa_byte(b1);
        uz = aa_byte(b2);
      }
      ray.dx = ray.dx + jitter(ux);
      ray.dy = ray.dy + jitter(uy);
      ray.dz = ray.dz + jitter(uz);
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

    const Hit h = nearest_group<G>(s, ray, grp);
    const bool hit = h.t < kInf;
    if (leader && bounce == 0 && sample == cur_k * spp) {
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
        // russian roulette (megakernel.py:988-1003): the 4th draw row,
        // or row 6 of the coherent draw
        const float rr_u =
            uni(hash_bits(itc, a.coherent ? 6 * row : 3 * row + lane, w0, w1));
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
      sr = sr + rr;
      sg = sg + rg;
      sb = sb + rb;
      ++sample;
      bounce = 0;
      if (sample == (cur_k + 1) * spp) {
        // the pixel's last sample: its mean, once
        if (leader) {
          out_r[p] = sr * a.inv_spp;
          out_g[p] = sg * a.inv_spp;
          out_b[p] = sb * a.inv_spp;
        }
        sr = sg = sb = 0.0f;
        cur_k = min(cur_k + 1, K - 1);
      }
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

  if (!leader) return;
  for (int k = 0; k < K; ++k) {
    a.out[3][base + k * kTileLanes] = k == 0 ? segs : 0.0f;
  }
}

template <int G>
int launch_nearest(const RtHitArgs& a, cudaStream_t st) {
  const int blocks = static_cast<int>(
      (static_cast<long long>(a.n) * G + kBlock - 1) / kBlock);
  nearest_hit_kernel<G><<<blocks, kBlock, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_mega(const RtMegaArgs& a, cudaStream_t st) {
  const int blocks = a.n_tiles * kTileLanes / kBlock * G;
  megakernel<G><<<blocks, kBlock, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_resolve(const RtResolveArgs& a, cudaStream_t st) {
  const int blocks = static_cast<int>(
      (static_cast<long long>(a.n) * G + kBlock - 1) / kBlock);
  if (a.stats != nullptr && a.sample != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);  // no such instance
  } else if (a.stats != nullptr) {
    hit_resolve_kernel<G, true, false><<<blocks, kBlock, 0, st>>>(a);
  } else if (a.sample != nullptr) {
    hit_resolve_kernel<G, false, true><<<blocks, kBlock, 0, st>>>(a);
  } else {
    hit_resolve_kernel<G, false, false><<<blocks, kBlock, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel instance of (kind, group), kind as rt_occupancy's. Null for
// another group.
template <int G>
const void* kernel_ptr(int kind) {
  switch (kind) {
    case 0: return (const void*)megakernel<G>;
    case 1: return (const void*)nearest_hit_kernel<G>;
    case 2: return (const void*)hit_resolve_kernel<G, false, false>;
    case 3: return rt_blocked_kernel(G);
    default: return nullptr;
  }
}

const void* kernel_of(int kind, int group) {
  switch (group) {
    case 1: return kernel_ptr<1>(kind);
    case 2: return kernel_ptr<2>(kind);
    case 4: return kernel_ptr<4>(kind);
    case 8: return kernel_ptr<8>(kind);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int rt_nearest_hit(const RtHitArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (args->group) {
    case 1: return launch_nearest<1>(*args, st);
    case 2: return launch_nearest<2>(*args, st);
    case 4: return launch_nearest<4>(*args, st);
    case 8: return launch_nearest<8>(*args, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Threads of kernel `kind` (0: K1, 1: rt_nearest_hit, 2: K5, 3: K6
// (wavefront.cu)) at group size
// `group` that the current device keeps resident at once: the blocks one
// SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the
// block's threads times the SMs.
int rt_occupancy(int kind, int group, int* resident_threads) {
  const void* fn = kernel_of(kind, group);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlock,
                                                       0);
  }
  *resident_threads = blocks * kBlock * sms;
  return static_cast<int>(rc);
}

int rt_hit_resolve(const RtResolveArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (args->group) {
    case 1: return launch_resolve<1>(*args, st);
    case 2: return launch_resolve<2>(*args, st);
    case 4: return launch_resolve<4>(*args, st);
    case 8: return launch_resolve<8>(*args, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (args->group) {
    case 1: return launch_mega<1>(*args, st);
    case 2: return launch_mega<2>(*args, st);
    case 4: return launch_mega<4>(*args, st);
    case 8: return launch_mega<8>(*args, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
