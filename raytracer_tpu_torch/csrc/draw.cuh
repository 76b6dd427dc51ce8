// The wavefront samplers' random draws as device functions: threefry2x32
// as jax.random uses it, its uniforms and normals (XLA's float32 erfinv,
// op for op), one lane's key and draw (raytracer_tpu/ops/rng.py:42-101)
// and coherent sampling's tile key and tile value (rng.py:104-127).
// rt_wave_rays (rays.cu) draws with them. Plain versions: ops/rng.py.

#pragma once

#include <stdint.h>

namespace {

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

// The lane's key for this bounce: fold_in(fold_in(k, sample), bounce), or
// fold_in(k, bounce) without a sample (the key already holds it).
__device__ __forceinline__ void lane_key(const long long* keys, int n, int i,
                                         const int* sample, uint32_t bounce,
                                         uint32_t& k0, uint32_t& k1) {
  k0 = static_cast<uint32_t>(keys[i]);
  k1 = static_cast<uint32_t>(keys[n + i]);
  if (sample != nullptr)
    threefry(k0, k1, 0u, static_cast<uint32_t>(sample[i]), k0, k1);
  threefry(k0, k1, 0u, bounce, k0, k1);
}

// Row `row` of the lane's draw: split(key)[row], then its bits: a uniform,
// or a normal for the Gaussian rows 3-5.
__device__ __forceinline__ float lane_draw(uint32_t k0, uint32_t k1,
                                           int row) {
  uint32_t s0, s1, b0, b1;
  threefry(k0, k1, 0u, static_cast<uint32_t>(row), s0, s1);  // split
  threefry(s0, s1, 0u, 0u, b0, b1);                          // bits
  const uint32_t bits = b0 ^ b1;
  return (row >= 3 && row < 6) ? normal01(bits) : uniform01(bits);
}

// Coherent sampling's key for one iteration: the host's words (key0,
// key1), or, under a replayed CUDA graph (key_dev set),
// fold_in((key_dev[0], key_dev[1]), iter_dev[0]), read when the kernel
// runs (uint32 values held in int64). Plain version: ops/rng.py's
// fold_in_tensor.
__device__ __forceinline__ void tile_key(const long long* key_dev,
                                         const long long* iter_dev,
                                         uint32_t key0, uint32_t key1,
                                         uint32_t& k0, uint32_t& k1) {
  k0 = key0;
  k1 = key1;
  if (key_dev != nullptr)
    threefry(static_cast<uint32_t>(key_dev[0]),
             static_cast<uint32_t>(key_dev[1]), 0u,
             static_cast<uint32_t>(iter_dev[0]), k0, k1);
}

// Row `row` of tile t (of nt) under the tile key. Subkey s = split(key)[s]
// draws a block of bits whose element j is x0 ^ x1 of
// threefry(subkey, (0, j)): block 0 the (3, nt) jitter uniforms, block 1
// the (3, nt) normals, blocks 2 and 3 the (nt,) Fresnel and
// russian-roulette uniforms. The row reads element (row % 3) * nt + t of
// its block (t of blocks 2 and 3).
__device__ __forceinline__ float tile_value(uint32_t k0, uint32_t k1,
                                            int row, uint32_t nt,
                                            uint32_t t) {
  const int block = row < 3 ? 0 : row < 6 ? 1 : row - 4;
  const uint32_t j = (row < 6 ? static_cast<uint32_t>(row % 3) * nt : 0u) + t;
  uint32_t s0, s1, b0, b1;
  threefry(k0, k1, 0u, static_cast<uint32_t>(block), s0, s1);  // split
  threefry(s0, s1, 0u, j, b0, b1);                             // bits
  const uint32_t bits = b0 ^ b1;
  return block == 1 ? normal01(bits) : uniform01(bits);
}

}  // namespace
