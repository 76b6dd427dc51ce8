// Hit math shared by the CUDA kernels of raytracer_tpu_torch: the ray and
// hit records, the slab test of a cluster box and the sphere and triangle
// tests of raytracer_tpu/ops/sweep.py (sweep_tile, K2). megakernel.cu (K1,
// K2 + K3 alone, K5) and wavefront.cu (K6) include it, so every kernel
// evaluates a primitive with the same operations.
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

// Slab test: the ray enters the box before its best t (bt <= kInf).
__device__ __forceinline__ bool slab(const float* __restrict__ box,
                                     const Ray& r, float ix, float iy,
                                     float iz, float bt) {
  return box_entry(box, r, ix, iy, iz) < bt;
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

}  // namespace
