// Wavefront-sampler kernels for Hopper (sm_90a): the blocked nearest hit
// (K6) and the per-lane random draws.
//
// rt_hit_resolve_blocked replaces K6 of raytracer_tpu,
//   ops/intersect_pallas.py:150-440  _kernel_blocked (pallas_call :688):
// the nearest hit of rays over a scene too big for the TPU's SMEM, which
// streams 4096-sphere / 1024-triangle blocks of the primitive pools into
// SMEM behind block-union -> super -> cluster gates, popping blocks
// near-first. Here one CTA (kK6Threads threads, one ray each) does the
// same with shared memory:
//   1. each thread takes its ray's entry distance into every block's
//      sphere and triangle unions; the CTA keeps the minimum per block;
//   2. it pops blocks in ascending entry distance (lowest index first on
//      ties) while the smallest remaining entry distance is below the
//      CTA's largest best t (intersect_pallas.py:386-433);
//   3. per popped block and pool, a CTA vote (__syncthreads_or) on the
//      per-thread union gate, with the per-pool guards b < pool_blocks of
//      visit_block (:240-262), decides whether the CTA copies the pool's
//      words of that block into shared memory (coalesced float4 loads);
//   4. each thread whose ray enters the union walks the block's supers ->
//      clusters -> leaves from shared memory against its running best,
//      with block-global codes 2 * (b * BLOCK + k) (+1) and a strict '<'
//      (:323-377).
// The winner's parameters (centre or normal, colour30, smooth|mat, the
// texture UV of a triangle) are read from the pools in global memory once
// at the end, by code. Outputs are raw, as the TPU kernel's: t, code, u,
// v, n0-2, pa, pb; a miss keeps zeros. Its plain version is
// ops/intersect_cuda.py::hit_resolve_blocked_reference, which
// brute-forces every block and merges the block winners.
//
// Differences from the TPU kernel that change only exact ties: a CTA holds
// kK6Threads rays, not 4096, so its pop order differs (hazard H3), and
// the gates are per thread, not per tile (a ray that hits a primitive
// without entering its box cannot win it here).
//
// What bounds it on an H100: latency of the dependent per-thread walk and
// the block copies, not device memory: a 100k-sphere scene (2.4 MB of
// pools) stays in the 50 MB L2, and each entered block costs one 64-72 KB
// copy from L2 into shared memory. The pool buffer is one 72 KB array
// reused by the two pools of a block, so three CTAs fit on an SM.
//
// rt_lane_randoms is not a TPU kernel: JAX draws the wavefront samplers'
// randoms in XLA (raytracer_tpu/ops/rng.py:42-101). Per lane it folds the
// lane's key with its sample and bounce, splits it into 7 or 8 subkeys
// (split(k, n)[i] == fold_in(k, i) under jax_threefry_partitionable) and
// draws one uniform or normal from each, all in registers: in plain torch
// the ~18 threefry passes of ~200 elementwise ops each would dominate a
// bounce. Plain version: ops/rng.py::lane_randoms_reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep.cuh"

extern "C" {

struct RtBlockedArgs {
  const float* sphf;   // (4, nblocks * 4096): centre x, y, z, |c|^2 - r^2
  const int* sphi;     // (2, nblocks * 4096): colour30, smooth8 << 16 | mat
  const float* trif;   // (24, nblocks * 1024): Woop rows, normal, cull, uv
  const int* trii;     // (2, nblocks * 1024)
  const float* sph_cl;   // (nblocks * sc_rows, 8) leaf boxes, block-local
  const float* tri_cl;   // (nblocks * tc_rows, 8)
  const float* sph_sup;  // (nblocks * ss_rows, 8) [box, first, count]
  const float* tri_sup;  // (nblocks * ts_rows, 8)
  const float* bbox;     // (nblocks * 2, 8) sphere / triangle unions
  int nblocks, sph_blocks, tri_blocks, sph_leaf, tri_leaf;
  int sc_rows, tc_rows, ss_rows, ts_rows;
  int has_one_way, needs_tri_uv;
  const float* o[3];
  const float* d[3];  // unit directions
  void* out[9];       // t, code, u, v, n0, n1, n2, pa, pb
  int n;
};

struct RtLaneArgs {
  const long long* keys;  // (2, n) uint32 key words held in int64
  const int* sample;      // (n,) or null: no sample fold
  const int* bounce;      // (n,)
  float* out;             // (rows, n)
  int n, rows;            // rows 7, or 8 with the russian-roulette draw
};

}  // extern "C"

namespace {

constexpr int kK6Threads = 256;
constexpr int kWarps = kK6Threads / 32;
constexpr int kSphBlock = 4096;
constexpr int kTriBlock = 1024;
constexpr int kSphRows = 4;      // sphere f32 rows the sweep reads
constexpr int kTriRowsCull = 18;  // triangle rows 0-17: Woop + normal + cull
constexpr int kTriRowsNoCull = 12;
constexpr int kPoolFloats = kTriRowsCull * kTriBlock;  // >= 4 * 4096
constexpr int kTriNrm = 12, kTriUV = 18;

// CTA-wide minimum (kMax: maximum); every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float cta_reduce(float v, float* red) {
  auto op = [](float a, float b) { return kMax ? fmaxf(a, b) : fminf(a, b); };
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = op(r, red[w]);
  __syncthreads();
  return r;
}

// Copy ``rows`` rows of ``block`` floats of block b from a pool of
// ``total`` floats per row into the shared buffer, row-major.
__device__ __forceinline__ void copy_block(float* __restrict__ dst,
                                           const float* __restrict__ pool,
                                           int rows, int block, int b,
                                           int total) {
  const int per_row = block / 4;
  for (int q = threadIdx.x; q < rows * per_row; q += kK6Threads) {
    const int row = q / per_row;
    const int col = (q % per_row) * 4;
    reinterpret_cast<float4*>(dst + row * block)[col / 4] =
        *reinterpret_cast<const float4*>(pool + row * total +
                                         b * block + col);
  }
}

// One block of one pool from shared memory: supers -> clusters -> leaves,
// each box gated on this thread's ray and running best.
template <bool kTri>
__device__ void walk_block(const RtBlockedArgs& a, const float* pool, int b,
                           const Ray& r, float ddo, float osq, float ix,
                           float iy, float iz, Hit& h) {
  const int ns = kTri ? a.ts_rows : a.ss_rows;
  const int nc = kTri ? a.tc_rows : a.sc_rows;
  const int leaf = kTri ? a.tri_leaf : a.sph_leaf;
  const int block = kTri ? kTriBlock : kSphBlock;
  const float* __restrict__ sup = (kTri ? a.tri_sup : a.sph_sup) + 8 * b * ns;
  const float* __restrict__ cl = (kTri ? a.tri_cl : a.sph_cl) + 8 * b * nc;
  const int base = 2 * b * block;
  for (int g = 0; g < ns; ++g) {
    const float* box = sup + 8 * g;
    if (!slab(box, r, ix, iy, iz, h.t)) continue;
    const int first = static_cast<int>(box[6]);
    const int count = static_cast<int>(box[7]);
    for (int c = first; c < first + count; ++c) {
      if (!slab(cl + 8 * c, r, ix, iy, iz, h.t)) continue;
      for (int k = c * leaf; k < (c + 1) * leaf; ++k) {
        if (kTri) {
          float t, u, v;
          if (triangle_t<false>(pool + k, kTriBlock, r, a.has_one_way, t, u,
                                v) &&
              t < h.t) {
            h.t = t;
            h.code = base + 2 * k + 1;
            h.bu = u;
            h.bv = v;
          }
        } else {
          const float t = sphere_t(pool + k, kSphBlock, r, ddo, osq);
          if (t > kEps && t < h.t) {
            h.t = t;
            h.code = base + 2 * k;
            h.bu = 0.0f;
            h.bv = 0.0f;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kK6Threads)
    hit_resolve_blocked_kernel(const RtBlockedArgs a) {
  extern __shared__ float4 smem4[];
  float* pool = reinterpret_cast<float*>(smem4);
  float* tvec = pool + kPoolFloats;         // per-block entry distance
  float* red = tvec + a.nblocks;            // kWarps reduction slots
  int* pick = reinterpret_cast<int*>(red + kWarps);

  const int i = blockIdx.x * kK6Threads + threadIdx.x;
  const bool live = i < a.n;
  const Ray r = live ? Ray{a.o[0][i], a.o[1][i], a.o[2][i],
                           a.d[0][i], a.d[1][i], a.d[2][i]}
                     : Ray{0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  const float ddo = r.dx * r.ox + r.dy * r.oy + r.dz * r.oz;
  const float osq = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  Hit h{kInf, 0, 0.0f, 0.0f};

  // 1. the CTA's entry distance into each block (real pools only;
  // intersect_pallas.py:389-403)
  for (int b = 0; b < a.nblocks; ++b) {
    float tb = kInf;
    if (live && b < a.sph_blocks)
      tb = box_entry(a.bbox + 16 * b, r, ix, iy, iz);
    if (live && b < a.tri_blocks)
      tb = fminf(tb, box_entry(a.bbox + 16 * b + 8, r, ix, iy, iz));
    tb = cta_reduce<false>(tb, red);
    if (threadIdx.x == 0) tvec[b] = tb;
  }
  __syncthreads();

  const int total_s = a.nblocks * kSphBlock;
  const int total_t = a.nblocks * kTriBlock;
  const int tri_rows = a.has_one_way ? kTriRowsCull : kTriRowsNoCull;
  // 2. near-first pops until no remaining block can beat any best t
  while (true) {
    const float worst = cta_reduce<true>(live ? h.t : 0.0f, red);
    if (threadIdx.x == 0) {
      int bmin = 0;
      for (int b = 1; b < a.nblocks; ++b)
        if (tvec[b] < tvec[bmin]) bmin = b;
      pick[0] = bmin;
    }
    __syncthreads();
    const int b = pick[0];
    const float m = tvec[b];
    __syncthreads();
    if (!(m < worst)) break;

    // 3. per-pool votes on the union gates, with the pool-filler guards
    const bool es = live && b < a.sph_blocks &&
                    slab(a.bbox + 16 * b, r, ix, iy, iz, h.t);
    const bool et = live && b < a.tri_blocks &&
                    slab(a.bbox + 16 * b + 8, r, ix, iy, iz, h.t);
    if (__syncthreads_or(es)) {
      copy_block(pool, a.sphf, kSphRows, kSphBlock, b, total_s);
      __syncthreads();
      // 4. the walk, per thread
      if (es) walk_block<false>(a, pool, b, r, ddo, osq, ix, iy, iz, h);
      __syncthreads();
    }
    if (__syncthreads_or(et)) {
      copy_block(pool, a.trif, tri_rows, kTriBlock, b, total_t);
      __syncthreads();
      if (et) walk_block<true>(a, pool, b, r, ddo, osq, ix, iy, iz, h);
      __syncthreads();
    }
    if (threadIdx.x == 0) tvec[b] = kInf;
    __syncthreads();
  }
  if (!live) return;

  // the winner's parameters from the pools in global memory
  const bool hit = h.t < kInf;
  const int prim = h.code >> 1;
  float u = 0.0f, v = 0.0f, n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  int pa = 0, pb = 0;
  if (hit && (h.code & 1)) {
    const float* f = a.trif + prim;
    n0 = f[kTriNrm * total_t];
    n1 = f[(kTriNrm + 1) * total_t];
    n2 = f[(kTriNrm + 2) * total_t];
    pa = a.trii[prim];
    pb = a.trii[total_t + prim];
    if (a.needs_tri_uv) {
      const float w = 1.0f - h.bu - h.bv;
      u = f[kTriUV * total_t] * w + f[(kTriUV + 2) * total_t] * h.bu +
          f[(kTriUV + 4) * total_t] * h.bv;
      v = f[(kTriUV + 1) * total_t] * w + f[(kTriUV + 3) * total_t] * h.bu +
          f[(kTriUV + 5) * total_t] * h.bv;
    }
  } else if (hit) {
    n0 = a.sphf[prim];
    n1 = a.sphf[total_s + prim];
    n2 = a.sphf[2 * total_s + prim];
    pa = a.sphi[prim];
    pb = a.sphi[total_s + prim];
  }
  static_cast<float*>(a.out[0])[i] = h.t;
  static_cast<int*>(a.out[1])[i] = hit ? h.code : 0;
  static_cast<float*>(a.out[2])[i] = u;
  static_cast<float*>(a.out[3])[i] = v;
  static_cast<float*>(a.out[4])[i] = n0;
  static_cast<float*>(a.out[5])[i] = n1;
  static_cast<float*>(a.out[6])[i] = n2;
  static_cast<int*>(a.out[7])[i] = pa;
  static_cast<int*>(a.out[8])[i] = pb;
}

// -- the lane randoms --------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32, 20 rounds, as jax.random uses it.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x0 + k0, b = x1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl32(b, rot[i % 2][j]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  y0 = a;
  y1 = b;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __int_as_float(static_cast<int>((bits >> 9) | 0x3F800000u)) - 1.0f;
}

// XLA's float32 erfinv (Giles), op for op as ops/rng.py::erfinv_xla.
__device__ __forceinline__ float erfinv_xla(float x) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                        -0.00417768164f, 0.246640727f, 1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f, 0.00573950773f, -0.0076224613f,
                        0.00943887047f, 1.00167406f, 2.83297682f};
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : p * x;
}

// jax.random.normal: sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1)).
__device__ __forceinline__ float normal01(uint32_t bits) {
  const float lo = __int_as_float(0xBF7FFFFF);  // nextafter(-1, 0)
  const float u = fmaxf(uniform01(bits) * 2.0f + lo, lo);
  return 1.41421356f * erfinv_xla(u);
}

__global__ void __launch_bounds__(256)
    lane_randoms_kernel(const RtLaneArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  uint32_t k0 = static_cast<uint32_t>(a.keys[i]);
  uint32_t k1 = static_cast<uint32_t>(a.keys[a.n + i]);
  if (a.sample != nullptr)
    threefry(k0, k1, 0u, static_cast<uint32_t>(a.sample[i]), k0, k1);
  threefry(k0, k1, 0u, static_cast<uint32_t>(a.bounce[i]), k0, k1);
  for (int row = 0; row < a.rows; ++row) {
    uint32_t s0, s1, b0, b1;
    threefry(k0, k1, 0u, static_cast<uint32_t>(row), s0, s1);  // split
    threefry(s0, s1, 0u, 0u, b0, b1);                          // bits
    const uint32_t bits = b0 ^ b1;
    a.out[static_cast<size_t>(row) * a.n + i] =
        (row >= 3 && row < 6) ? normal01(bits) : uniform01(bits);
  }
}

}  // namespace

extern "C" {

int rt_hit_resolve_blocked(const RtBlockedArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const size_t smem = sizeof(float) * (kPoolFloats + args->nblocks + kWarps) +
                      sizeof(int) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      hit_resolve_blocked_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (args->n + kK6Threads - 1) / kK6Threads;
  hit_resolve_blocked_kernel<<<blocks, kK6Threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

int rt_lane_randoms(const RtLaneArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int blocks = (args->n + 255) / 256;
  lane_randoms_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
