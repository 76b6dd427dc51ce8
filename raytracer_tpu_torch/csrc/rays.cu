// The wavefront iteration's ray set-up before K5 / K6 (sm_90a).
//
// rt_wave_rays is not a TPU kernel. In the JAX package XLA fuses its work
// around the Pallas hit kernel inside the jitted loop: the lane draw
// (raytracer_tpu/ops/rng.py:75-101), the antialias jitter
// (ops/scatter.py:34) and the padding and normalisation before the hit
// (ops/intersect_pallas.py:728-741). One thread a lane: it draws in
// registers (draw.cuh's lane_key and lane_draw, as rt_lane_randoms does;
// in the coherent arm it reads the jitter rows rt_tile_randoms drew),
// jitters the direction and renormalises it (scatter.antialias_jitter), or
// passes it through with antialias off, then normalises it again for the
// hit kernel: the unit direction and 1 / |d|, the plain version's two
// normalisations (the second length is near 1, not 1). It writes the
// jittered direction, the unit direction, 1 / |d| and the rows
// rt_wave_bounce reads (Gaussian x 3, Fresnel[, russian roulette]); the
// jitter rows never leave registers. It also adds the lanes that trace a
// segment this iteration to one int64: a block count
// (__syncthreads_count), then one atomic add a block (integers, so the
// order does not matter). The hit kernels take any n, so nothing is
// padded. Plain version: ops/rays.py::wave_rays_reference.
//
// What bounds it on an H100: operations, ~1500 a lane, most of them the
// threefry rounds' integer adds, xors and shifts (the bytes: ~90 a lane).
// What the design does about it: one pass, nothing staged; the jitter
// rows are drawn only with antialias on and never stored, and the rows it
// writes are the ones the bounce reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "draw.cuh"

extern "C" {

struct RtRaysArgs {
  const long long* keys;  // (2, n) uint32 key words in int64, or null
  const int* sample;      // (n,): the draw's sample fold (with keys) and the
                          // count's sample_i < spp (no alive); or null
  const int* bounce;      // (n,), or null: every lane on bounce_const
  const float* drawn;     // (rows, n) drawn rows when keys is null
  const float* d[3];      // the lanes' directions
  float* dj[3];           // out: the jittered directions (antialias only)
  float* unit[3];         // out: dj / |dj|
  float* inv_len;         // out: 1 / |dj|
  float* draws;           // out: (rows - 3, n) Gaussian x 3, Fresnel[, rr];
                          // null when drawn is given
  const unsigned char* alive;  // the count's lanes (scan), or null
  long long* segs;        // the lanes that trace a segment, added; or null
  int n, rows, bounce_const, spp, antialias;
  float jitter_scale;     // 2 * ANTIALIAS_OFFSET_RANGE as float32
};

}  // extern "C"

namespace {

// The ray set-up, one thread a lane. Numerics as the plain version's
// torch ops on the card (built with --fmad=false): each product and sum
// rounds on its own, sums in torch's order ((a0*b0 + a1*b1) + a2*b2), the
// float32 scalar of (u - 0.5) * scale, rsqrtf as torch.rsqrt.
__global__ void __launch_bounds__(256) wave_rays_kernel(const RtRaysArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < a.n;
  if (a.segs != nullptr) {  // the same for every thread of the grid
    const bool live = in && (a.alive != nullptr ? a.alive[i] != 0
                                                : a.sample[i] < a.spp);
    const int count = __syncthreads_count(live);
    if (threadIdx.x == 0 && count > 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.segs),
                static_cast<unsigned long long>(count));
  }
  if (!in) return;
  const size_t n = static_cast<size_t>(a.n);
  float jit[3] = {0.0f, 0.0f, 0.0f};
  if (a.keys != nullptr) {
    uint32_t k0, k1;
    const uint32_t b = a.bounce != nullptr
                           ? static_cast<uint32_t>(a.bounce[i])
                           : static_cast<uint32_t>(a.bounce_const);
    lane_key(a.keys, a.n, i, a.sample, b, k0, k1);
    if (a.antialias)
      for (int r = 0; r < 3; ++r) jit[r] = lane_draw(k0, k1, r);
    for (int r = 3; r < a.rows; ++r)
      a.draws[(r - 3) * n + i] = lane_draw(k0, k1, r);
  } else if (a.antialias) {
    for (int r = 0; r < 3; ++r) jit[r] = a.drawn[r * n + i];
  }
  float x = a.d[0][i], y = a.d[1][i], z = a.d[2][i];
  if (a.antialias) {
    // scatter.antialias_jitter: d + (u - 0.5) * scale, renormalised
    x = x + (jit[0] - 0.5f) * a.jitter_scale;
    y = y + (jit[1] - 0.5f) * a.jitter_scale;
    z = z + (jit[2] - 0.5f) * a.jitter_scale;
    const float r = rsqrtf(x * x + y * y + z * z);
    x = x * r;
    y = y * r;
    z = z * r;
    a.dj[0][i] = x;
    a.dj[1][i] = y;
    a.dj[2][i] = z;
  }
  // intersect_cuda.unit_rays: the hit kernels take unit directions
  const float inv = rsqrtf(x * x + y * y + z * z);
  a.unit[0][i] = x * inv;
  a.unit[1][i] = y * inv;
  a.unit[2][i] = z * inv;
  a.inv_len[i] = inv;
}

}  // namespace

extern "C" {

int rt_wave_rays(const RtRaysArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int blocks = (args->n + 255) / 256;
  wave_rays_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
