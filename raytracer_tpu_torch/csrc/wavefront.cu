// Wavefront-sampler kernel for Hopper (sm_90a): the blocked nearest hit
// (K6).
//
// rt_hit_resolve_blocked replaces K6 of raytracer_tpu,
//   ops/intersect_pallas.py:150-440  _kernel_blocked (pallas_call :688):
// the nearest hit of rays over a scene too big for the TPU's SMEM. The TPU
// kernel streams 4096-sphere / 1024-triangle blocks of the primitive pools
// from HBM into SMEM behind block-union -> super -> cluster gates, popping
// blocks near-first per 4096-ray tile. On the H100 nothing needs staging:
// stress100k's whole blocked layout, about 5 MB with its filler rows,
// sits in the 50 MB L2. So G threads of a warp share a ray (G = 1, 2, 4 or
// 8, by the wrapper's rule, ops/intersect_cuda.py blocked_group) and walk
// the blocks from global memory in index order, b = 0 .. nblocks - 1, with
// sweep.cuh's walk_pool: block b's sphere union (row 2b of bbox, only if
// b < sph_blocks: the guards of visit_block, :240-262), then its supers,
// clusters and leaves; then its triangle union (row 2b + 1, only if
// b < tri_blocks), the same way. Every gate is per group, against the
// group's best t, with a strict '<'; a leaf's primitives are strided over
// the group and merged. Codes are block-global, 2 * (b * BLOCK + k) (+ 1).
// The leader reads the winner's parameters (centre or normal, colour30,
// smooth|mat, the texture UV of a triangle) from the pools by code.
// Outputs are raw, as the TPU kernel's: t, code, u, v, n0-2, pa, pb; a
// miss keeps zeros. Given the regen loop's sample indices, a finished
// lane (sample >= spp) is skipped and its outputs keep what they held:
// rt_wave_bounce reads none of them. Its plain version is
// ops/intersect_cuda.py::hit_resolve_blocked_reference, which
// brute-forces every block and merges the block winners in block order.
//
// Ties. The walk visits the primitives in the order (block, spheres before
// triangles, index in the block), the plain version's merge order, so K6
// returns its winner on exact ties too: a block-0 triangle beats a block-1
// sphere at the same t (K5's order would pick the sphere). The TPU kernel
// pops blocks in another order per tile (hazard H3), and gates per tile,
// not per ray (a ray that hits a primitive without entering its box
// cannot win it here).
//
// What bounds it on an H100: each ray's dependent chain of gate and
// primitive tests, read from L2, not device-memory bytes. What the design
// does about it: no copies and no CTA-wide barrier, so a group stops at
// its own best t and never waits for other rays; the block unions give a
// gate level above the per-block supers; and G threads a ray cut the
// chain by about G where the card has threads to spare.

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
  // (n,) the regen lanes' sample index, or null: a lane with
  // sample >= spp is finished and skipped, its outputs left as they were
  const int* sample;
  int spp;
  int n;
  int group;          // threads per ray: 1, 2, 4 or 8
};

}  // extern "C"

namespace {

constexpr int kSphBlock = 4096;
constexpr int kTriBlock = 1024;
constexpr int kTriNrm = 12, kTriUV = 18;

// K6, G threads a ray. kMask (the regen loop's launch) skips a finished
// lane, sample[i] >= spp, before it loads the ray, as K5's does.
template <int G, bool kMask>
__global__ void __launch_bounds__(kBlock)
    hit_resolve_blocked_kernel(const RtBlockedArgs a) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= a.n) return;  // whole groups: the G threads share i
  if (kMask && a.sample[i] >= a.spp) return;  // whole groups too
  const Ray r{a.o[0][i], a.o[1][i], a.o[2][i],
              a.d[0][i], a.d[1][i], a.d[2][i]};
  const Group<G> grp = this_group<G>();
  const Probe q = probe(r);
  const int total_s = a.nblocks * kSphBlock;
  const int total_t = a.nblocks * kTriBlock;
  Hit h{kInf, 0, 0.0f, 0.0f};
  float unused = 0.0f;
  for (int b = 0; b < a.nblocks; ++b) {
    if (b < a.sph_blocks && entry(a.bbox + 16 * b, r, q) < h.t) {
      const Pool p{a.sphf + b * kSphBlock, total_s,
                   a.sph_cl + 8 * b * a.sc_rows, a.sph_sup + 8 * b * a.ss_rows,
                   a.sc_rows, a.ss_rows, kSphBlock, a.sph_leaf,
                   2 * b * kSphBlock};
      walk_pool<false, false, false>(p, r, q, false, h, grp, unused);
    }
    if (b < a.tri_blocks && entry(a.bbox + 16 * b + 8, r, q) < h.t) {
      const Pool p{a.trif + b * kTriBlock, total_t,
                   a.tri_cl + 8 * b * a.tc_rows, a.tri_sup + 8 * b * a.ts_rows,
                   a.tc_rows, a.ts_rows, kTriBlock, a.tri_leaf,
                   2 * b * kTriBlock};
      walk_pool<true, false, false>(p, r, q, a.has_one_way, h, grp, unused);
    }
  }
  if (grp.rank != 0) return;

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

template <int G>
int launch_blocked(const RtBlockedArgs& a, cudaStream_t st) {
  const int blocks = static_cast<int>(
      (static_cast<long long>(a.n) * G + kBlock - 1) / kBlock);
  if (a.sample != nullptr) {
    hit_resolve_blocked_kernel<G, true><<<blocks, kBlock, 0, st>>>(a);
  } else {
    hit_resolve_blocked_kernel<G, false><<<blocks, kBlock, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rt_hit_resolve_blocked(const RtBlockedArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (args->group) {
    case 1: return launch_blocked<1>(*args, st);
    case 2: return launch_blocked<2>(*args, st);
    case 4: return launch_blocked<4>(*args, st);
    case 8: return launch_blocked<8>(*args, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6's instance at group size `group`, for rt_occupancy (megakernel.cu);
// null for another group.
const void* rt_blocked_kernel(int group) {
  switch (group) {
    case 1: return (const void*)hit_resolve_blocked_kernel<1, false>;
    case 2: return (const void*)hit_resolve_blocked_kernel<2, false>;
    case 4: return (const void*)hit_resolve_blocked_kernel<4, false>;
    case 8: return (const void*)hit_resolve_blocked_kernel<8, false>;
    default: return nullptr;
  }
}

}  // extern "C"
