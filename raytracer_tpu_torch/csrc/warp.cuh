// The history gather of one pixel (sm_90a), for warp.cu's
// rt_temporal_frame.
//
// raytracer_tpu/runtime/renderer.py:53-122 (_pack_history_body, then
// _gather_history) for current pixel i, scanline order: the primary hit
// o + d * min(depth, 1e29), projected through the old pinhole (plane
// normal, focal distance and du.du, dv.dv computed once on the host),
// floor to int32, the validity test, the clamped flat index, the load of
// the old accumulation and weight at that pixel (K7's one gather, where
// valid), their pack to 9-bit sqrt codes and a 5-bit weight
// (pack_history), the decode of the codes to the history radiance and the
// velocity-limited weight. The pack runs only on the pixels read, so no
// packed plane exists.
//
// Numerics (the sources are built with --fmad=false and IEEE division and
// sqrt): each product and sum rounds on its own, dot products run left to
// right as a0*b0 + a1*b1 + a2*b2, as in the plain version, so the result is
// bitwise equal to it. sqrtf is correctly rounded and rintf rounds half to
// even, as torch.round and jnp.round do. floor-to-int saturates and sends
// NaN to 0 (__float2int_rd, as XLA's convert); yi * width + xi wraps in
// int32 as in XLA and torch, computed in unsigned here (signed overflow is
// undefined in C++). min() propagates NaN, as jnp.minimum and
// torch.minimum do. The pack is held to the plain version for finite
// accumulations and weights (the renderer's check_health keeps them so).

#pragma once

#include <cuda_runtime.h>

namespace warp {

constexpr float kHistMax = 8.0f;  // ops/warp.py HIST_MAX

// The index the gathers load at: k clamped to [0, m).
__device__ __forceinline__ int clamp_index(int k, int m) {
  return min(max(k, 0), m - 1);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

// pack_history's 9-bit code of one channel, as a float:
// round(sqrt(clamp(a / HIST_MAX, 0, 1)) * 511).
__device__ __forceinline__ float code9(float a) {
  return rintf(sqrtf(fminf(fmaxf(a / kHistMax, 0.0f), 1.0f)) * 511.0f);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      const float* b) {
  return ax * b[0] + ay * b[1] + az * b[2];
}

// Pixel i's history radiance hist[3] and weight w, gathered from the old
// view. ``A`` holds the old view: accum (n, 3) and wpix (n,), its pinhole
// pos, tl, du, dv, nrm, focal, dudu, dvdv, the history cap and the decode
// scale, and the film's width and height. ``o``, ``d``: the pixel's
// primary ray in the current view; ``t``: its primary-hit depth (>= 1e29
// on a miss).
template <class A>
__device__ __forceinline__ void gather_pixel(const A& a, int i,
                                             const float* o, const float* d,
                                             float t, float hist[3],
                                             float& w) {
  const int n = a.width * a.height;
  const bool hit = t < 1e29f;
  const float tm = min_nan(t, 1e29f);
  const float vx = (o[0] + d[0] * tm) - a.pos[0];
  const float vy = (o[1] + d[1] * tm) - a.pos[1];
  const float vz = (o[2] + d[2] * tm) - a.pos[2];
  const float vn = dot3(vx, vy, vz, a.nrm);
  const bool front = vn > 1e-9f;
  const float s = a.focal / (front ? vn : 1.0f);
  const float rx = (a.pos[0] + vx * s) - a.tl[0];
  const float ry = (a.pos[1] + vy * s) - a.tl[1];
  const float rz = (a.pos[2] + vz * s) - a.tl[2];
  const float x = dot3(rx, ry, rz, a.du) / a.dudu;
  const float y = dot3(rx, ry, rz, a.dv) / a.dvdv;
  const int xi = __float2int_rd(x);
  const int yi = __float2int_rd(y);
  const bool valid = hit && front && xi >= 0 && xi < a.width && yi >= 0 &&
                     yi < a.height;
  const int flat = clamp_index(
      static_cast<int>(static_cast<unsigned>(yi) *
                           static_cast<unsigned>(a.width) +
                       static_cast<unsigned>(xi)),
      n);
  // the old pixel's pack (zeros where not valid, and nothing is read)
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, wq = 0.0f;
  if (valid) {
    const size_t f3 = 3 * static_cast<size_t>(flat);
    cr = code9(__ldg(a.accum + f3));
    cg = code9(__ldg(a.accum + f3 + 1));
    cb = code9(__ldg(a.accum + f3 + 2));
    wq = truncf(fminf(fmaxf(fminf(__ldg(a.wpix + flat), a.history), 0.0f),
                      31.0f));
  }

  const float ex = x - static_cast<float>(i % a.width);
  const float ey = y - static_cast<float>(i / a.width);
  const float motion = sqrtf(ex * ex + ey * ey);
  w = min_nan(wq, 31.0f / (1.0f + 0.5f * motion));
  hist[0] = (cr * cr) * a.scale;
  hist[1] = (cg * cg) * a.scale;
  hist[2] = (cb * cb) * a.scale;
}

}  // namespace warp
