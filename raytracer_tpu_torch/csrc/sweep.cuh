// Hit math shared by the CUDA kernels of raytracer_tpu_torch: the ray and
// hit records, the slab test of a cluster box, the sphere and triangle
// tests of raytracer_tpu/ops/sweep.py (sweep_tile, K2), and the one walk
// that every nearest hit runs (walk_pool: K2 inside K1 and alone, K5, K6).
// megakernel.cu (K1, K2 + K3 alone, K5) and wavefront.cu (K6) include it,
// so every kernel evaluates a primitive with the same operations and
// visits the boxes in the same way.
//
// Numerics: built with IEEE division and sqrt and --fmad=false (see
// megakernel.cu), so each product and sum rounds on its own, as in the
// plain PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr float kInf = 1e30f;

// sweep.py row layout: triangle f32 rows
constexpr int kTriWU = 0, kTriWV = 4, kTriWW = 8, kTriCull = 15;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Hit {
  float t;
  int code;  // prim * 2 + is_triangle
  float bu, bv;
};

// FAST_DIV reciprocal: float32 1 / bf16(x), then one Newton step
// (sweep.py:972-986 as Pallas interpret mode evaluates it).
__device__ __forceinline__ float fast_recip(float x) {
  const float xb = __bfloat162float(__float2bfloat16_rn(x));
  const float r0 = __frcp_rn(xb);
  return r0 * (2.0f - x * r0);
}

__device__ __forceinline__ float safe_inv(float c) {
  return c == 0.0f ? kInf : 1.0f / c;
}

// Entry distance of the ray into one AABB row [min3, max3]
// (sweep.py:561-580), kInf where it misses; a NaN row never enters.
__device__ __forceinline__ float box_entry(const float* __restrict__ box,
                                           const Ray& r, float ix, float iy,
                                           float iz) {
  float t1 = (box[0] - r.ox) * ix;
  float t2 = (box[3] - r.ox) * ix;
  float tmin = fminf(t1, t2);
  float tmax = fmaxf(t1, t2);
  t1 = (box[1] - r.oy) * iy;
  t2 = (box[4] - r.oy) * iy;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  t1 = (box[2] - r.oz) * iz;
  t2 = (box[5] - r.oz) * iz;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  tmin = fmaxf(tmin, 0.0f);
  return (tmin <= tmax && tmax > 0.0f) ? tmin : kInf;
}

// Sphere whose rows (centre x, y, z, |c|^2 - r^2) start at f, ``stride``
// floats apart (sweep.py:821-860): the half-b quadratic of a unit-direction
// ray; a miss gives NaN, which fails every compare.
__device__ __forceinline__ float sphere_t(const float* __restrict__ f,
                                          int stride, const Ray& r,
                                          float ddo, float osq) {
  const float cx = f[0], cy = f[stride], cz = f[2 * stride];
  const float cr2 = f[3 * stride];
  const float dc = r.dx * cx + r.dy * cy + r.dz * cz;
  const float oc = r.ox * cx + r.oy * cy + r.oz * cz;
  const float hh = dc - ddo;
  const float cq = (cr2 + osq) - (oc + oc);
  const float disc = hh * hh - cq;
  return hh - sqrtf(disc);
}

// Triangle whose Woop rows start at f, ``stride`` floats apart
// (sweep.py:961-1032). kFastDiv: the megakernel's FAST_DIV reciprocal;
// false: the exact division of the wavefront kernels (hazard H2). Returns
// true with t and the barycentrics when the ray hits; all-zero padding
// rows give t = NaN and never hit.
template <bool kFastDiv>
__device__ __forceinline__ bool triangle_t(const float* __restrict__ f,
                                           int stride, const Ray& r,
                                           bool one_way, float& t, float& u,
                                           float& v) {
#define W(row) f[(row) * stride]
  const float ow = W(kTriWW) * r.ox + W(kTriWW + 1) * r.oy +
                   W(kTriWW + 2) * r.oz + W(kTriWW + 3);
  const float dw =
      W(kTriWW) * r.dx + W(kTriWW + 1) * r.dy + W(kTriWW + 2) * r.dz;
  t = kFastDiv ? -ow * fast_recip(dw) : -ow / dw;
  const float ou = W(kTriWU) * r.ox + W(kTriWU + 1) * r.oy +
                   W(kTriWU + 2) * r.oz + W(kTriWU + 3);
  const float du =
      W(kTriWU) * r.dx + W(kTriWU + 1) * r.dy + W(kTriWU + 2) * r.dz;
  u = ou + t * du;
  const float ov = W(kTriWV) * r.ox + W(kTriWV + 1) * r.oy +
                   W(kTriWV + 2) * r.oz + W(kTriWV + 3);
  const float dv =
      W(kTriWV) * r.dx + W(kTriWV + 1) * r.dy + W(kTriWV + 2) * r.dz;
  v = ov + t * dv;
  bool valid = (t > kEps) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
  if (one_way) {
    const float cull = W(kTriCull) * r.dx + W(kTriCull + 1) * r.dy +
                       W(kTriCull + 2) * r.dz;
    valid = valid && (cull >= 0.0f);
  }
#undef W
  return valid;
}

// colour30 -> channel (shift 20 = red, 10 = green, 0 = blue),
// sweep.py:100-148
__device__ __forceinline__ float c30(int pa, int shift) {
  return static_cast<float>((pa >> shift) & 1023) * (1.0f / 1023.0f);
}

// ---- the group walk --------------------------------------------------------
//
// G consecutive threads of a warp (G = 1, 2, 4 or 8, a template parameter
// the wrapper picks by a rule) share one ray. The group walks a pool's
// boxes in index order: supers (if any), then the clusters they cover,
// then the leaf primitives. The boxes of a level are slab-tested G at a
// time, one a thread, and a ballot names the ones entered before the
// group's best t; the group visits those in order, each gated again
// against the best t it meets, with a strict '<'. A leaf's
// primitives are strided over the G threads (a thread keeps the first of
// a tie with a strict '<') and merged with __shfl_xor_sync. A group of one
// is the one-thread walk: no warp intrinsic.
//
// Why it is exact. The walk meets the primitives in its visit order: the
// order of the pools it is handed, index order inside each (supers cover
// their clusters in ascending runs). A box entered at or beyond the best t
// holds only primitives later in that order, which lose a tie, so gating
// it out leaves the first hit in visit order. Every merge runs after one
// leaf, on candidates that all beat the group's best before it (strict
// '<') and share one pool: among them the lower code is the earlier visit,
// in the resident pools and in a block of the blocked ones alike.

// Threads a block of the kernels that walk in groups.
constexpr int kBlock = 128;

// The G threads of a warp that share one ray: their lanes and the thread's
// rank among them. Groups are aligned to G within the warp.
template <int G>
struct Group {
  unsigned mask;
  int rank;
  int base;  // the group's first lane in the warp
};

template <int G>
__device__ __forceinline__ Group<G> this_group() {
  const int lane = threadIdx.x & 31;
  return Group<G>{((1u << G) - 1u) << (lane & ~(G - 1)), lane & (G - 1),
                  lane & ~(G - 1)};
}

// What the tests of one ray share: d.o, |o|^2 and the safe inverse of d.
struct Probe {
  float ddo, osq, ix, iy, iz;
};

__device__ __forceinline__ Probe probe(const Ray& r) {
  return Probe{r.dx * r.ox + r.dy * r.oy + r.dz * r.oz,
               r.ox * r.ox + r.oy * r.oy + r.oz * r.oz, safe_inv(r.dx),
               safe_inv(r.dy), safe_inv(r.dz)};
}

__device__ __forceinline__ float entry(const float* __restrict__ box,
                                       const Ray& r, const Probe& q) {
  return box_entry(box, r, q.ix, q.iy, q.iz);
}

// One pool as the walk reads it: row k of primitive i at f[k * stride + i];
// leaf cluster c holds primitives [c * leaf, (c + 1) * leaf) and its row
// of ``cl`` is [min3, max3, start, count]; super rows [min3, max3, first
// cluster, count]. A level with no rows (n_sup, n_cl = 0) is absent. A hit
// on primitive i has code code0 + 2 * i (+ 1 for a triangle).
struct Pool {
  const float* f;
  int stride;
  const float* cl;
  const float* sup;
  int n_cl, n_sup, n_prim, leaf;
  int code0;
};

// Every thread of the group ends with the group's first hit: the lowest t,
// then the lower code (see above); a triangle's barycentrics ride with it.
template <int G>
__device__ __forceinline__ void merge_hits(Hit& h, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float t = __shfl_xor_sync(mask, h.t, off);
    const int code = __shfl_xor_sync(mask, h.code, off);
    const float bu = __shfl_xor_sync(mask, h.bu, off);
    const float bv = __shfl_xor_sync(mask, h.bv, off);
    if (t < h.t || (t == h.t && code < h.code)) h = Hit{t, code, bu, bv};
  }
}

// Visit the boxes first .. first + count - 1 that the ray enters before
// the group's best t, in index order: thread rank tests box c + rank of
// each chunk c of G, and the group visits the chunk's entered boxes in
// order, each gated again against the best t it meets.
template <int G, typename Visit>
__device__ __forceinline__ void in_order(const float* __restrict__ boxes,
                                         int first, int count, const Ray& r,
                                         const Probe& q, Hit& h,
                                         const Group<G>& grp, Visit&& visit) {
  if constexpr (G == 1) {
    for (int c = first; c < first + count; ++c) {
      if (entry(boxes + 8 * c, r, q) < h.t) visit(c);
    }
  } else {
    for (int c = first; c < first + count; c += G) {
      const int b = c + grp.rank;
      const float e = b < first + count ? entry(boxes + 8 * b, r, q) : kInf;
      unsigned entered =
          (__ballot_sync(grp.mask, e < h.t) >> grp.base) & ((1u << G) - 1u);
      while (entered) {
        const int k = __ffs(entered) - 1;
        entered &= entered - 1;
        const float ek = __shfl_sync(grp.mask, e, grp.base + k);
        if (ek < h.t) visit(c + k);
      }
    }
  }
}

// One pool, walked by the group: supers -> clusters -> leaves when the pool
// has them, else every slot. kFastDiv: the megakernel's triangle
// reciprocal (K1, K2), else exact division (K5, K6). kStats adds to
// ``tests`` the primitive count (box[7]) of every leaf cluster the group
// enters, or the whole pool when it has no clusters (sweep.py:601-603,
// 1119-1126); every thread of the group keeps the same count. The group
// enters the clusters the one-thread walk enters: each is gated against
// the best t of the leaves before it, merged.
template <bool kTri, bool kFastDiv, bool kStats, int G>
__device__ __forceinline__ void walk_pool(const Pool& p, const Ray& r,
                                          const Probe& q, bool one_way,
                                          Hit& h, const Group<G>& grp,
                                          float& tests) {
  auto test = [&](int i) {
    if constexpr (kTri) {
      float t, u, v;
      if (triangle_t<kFastDiv>(p.f + i, p.stride, r, one_way, t, u, v) &&
          t < h.t) {
        h = Hit{t, p.code0 + 2 * i + 1, u, v};
      }
    } else {
      // a sphere's barycentrics are never read: bu, bv stay as they are
      const float t = sphere_t(p.f + i, p.stride, r, q.ddo, q.osq);
      if (t > kEps && t < h.t) {
        h.t = t;
        h.code = p.code0 + 2 * i;
      }
    }
  };
  auto leaf_sweep = [&](int c) {
    if constexpr (kStats) tests += p.cl[8 * c + 7];
    for (int i = c * p.leaf + grp.rank; i < (c + 1) * p.leaf; i += G) {
      test(i);
    }
    merge_hits<G>(h, grp.mask);
  };
  if (p.n_sup > 0) {
    in_order<G>(p.sup, 0, p.n_sup, r, q, h, grp, [&](int g) {
      const float* box = p.sup + 8 * g;
      in_order<G>(p.cl, static_cast<int>(box[6]), static_cast<int>(box[7]),
                  r, q, h, grp, leaf_sweep);
    });
  } else if (p.n_cl > 0) {
    in_order<G>(p.cl, 0, p.n_cl, r, q, h, grp, leaf_sweep);
  } else {
    if constexpr (kStats) tests += static_cast<float>(p.n_prim);
    for (int i = grp.rank; i < p.n_prim; i += G) test(i);
    merge_hits<G>(h, grp.mask);
  }
}

}  // namespace
