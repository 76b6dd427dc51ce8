// The wavefront iteration's ray set-up before K5 / K6 (sm_90a).
//
// rt_wave_rays is not a TPU kernel. In the JAX package XLA fuses its work
// around the Pallas hit kernel inside the jitted loop: the lane draw
// (raytracer_tpu/ops/rng.py:75-101) or coherent sampling's tile draw
// (:104-127), the antialias jitter (ops/scatter.py:34) and the padding and
// normalisation before the hit (ops/intersect_pallas.py:728-741). One
// thread a lane: it draws in registers (draw.cuh's lane_key and lane_draw),
// or, in the coherent arm, takes its tile's bundle (draw.cuh's tile_key
// and tile_value):
// the tile is JAX's 1024 lanes, so a block of 256 lies in one tile and its
// first threads draw the bundle once into shared memory. It jitters the
// direction and renormalises it (scatter.antialias_jitter), or passes it
// through with antialias off,
// then normalises it again for the hit kernel: the unit direction and
// 1 / |d|, the plain version's two normalisations (the second length is
// near 1, not 1). It writes the jittered direction, the unit direction,
// 1 / |d| and the rows rt_wave_bounce reads (Gaussian x 3, Fresnel[,
// russian roulette]); the jitter rows never leave registers. A finished
// regen lane (sample_i >= spp, no alive mask) skips all of it: it gets the
// park walk's unit direction (kParkUnit) and 1 / |d| = 1, without its d
// being read, so K5 / K6 walk it from the park origin the bounce moved it
// to. It also adds the lanes that trace a segment this iteration to one
// int64: a block count
// (__syncthreads_count), then one atomic add a block (integers, so the
// order does not matter). Under a replayed CUDA graph the coherent arm
// reads the tile key and the iteration counter from device memory, and
// the last block to have read them (a ticket, counted after a fence)
// advances the counter by one and zeroes the ticket again, so an
// iteration needs no other op. The hit kernels take any n, so nothing is
// padded. Plain version: ops/rays.py::wave_rays_reference.
//
// What bounds it on an H100: operations, ~1500 a live lane, most of them
// the threefry rounds' integer adds, xors and shifts (the bytes: ~90 a
// lane); a finished lane reads its sample and writes 16 bytes.
// What the design does about it: one pass, nothing staged; the jitter
// rows are drawn only with antialias on and never stored, and the rows it
// writes are the ones the bounce reads. The coherent arm's draw is a few
// threefry calls a block, so that arm is bound by its bytes; it is the
// kernel's second instance (kCoherent), so the per-lane one carries none
// of it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "draw.cuh"

extern "C" {

struct RtRaysArgs {
  const long long* keys;  // (2, n) uint32 key words in int64, or null: the
                          // coherent arm, keyed by the tile key below
  const int* sample;      // (n,): the draw's sample fold (with keys) and the
                          // count's sample_i < spp (no alive); or null
  const int* bounce;      // (n,), or null: every lane on bounce_const
  const float* d[3];      // the lanes' directions
  float* dj[3];           // out: the jittered directions (antialias only)
  float* unit[3];         // out: dj / |dj|
  float* inv_len;         // out: 1 / |dj|
  float* draws;           // out: (rows - 3, n) Gaussian x 3, Fresnel[, rr]
  const unsigned char* alive;  // the count's lanes (scan), or null; when
                               // null, a lane with sample >= spp is
                               // finished and only its unit (kParkUnit)
                               // and inv_len (1) are written
  long long* segs;        // the lanes that trace a segment, added; or null
  // The coherent arm's tile key: (key0, key1), or, when key_dev is set,
  // fold_in((key_dev[0], key_dev[1]), iter_dev[0]) read when the kernel
  // runs; the launch then adds one to iter_dev[0] (iter_dev[1] is its
  // ticket, zero before and after a launch).
  const long long* key_dev;
  long long* iter_dev;
  unsigned int key0, key1;
  int n, rows, bounce_const, spp, antialias;
  float jitter_scale;     // 2 * ANTIALIAS_OFFSET_RANGE as float32
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
// A finished lane's unit direction (ops/rays.py PARK_UNIT): from the park
// origin (1e13, 1e13, 1e13) away from the scene and along no axis. With a
// zero component the hit kernels' exact triangle division divides by zero
// on every triangle parallel to it (a box's walls), which IEEE division
// takes on its slow path. Its squares sum to 1 in float32.
constexpr float kParkUx = 0.6f, kParkUy = 0.64f, kParkUz = 0.48f;
// The coherent arm's lanes a tile: tile_randoms' default, the tile the
// JAX wavefront loop draws with (raytracer_tpu/ops/rng.py:104,
// ops/integrator.py:266); ops/rays.py's TILE. A multiple of kThreads, so a
// block lies in one tile.
constexpr int kCoherentTile = 1024;

// The coherent arm's draw of lane i's tile: the jitter rows (with
// antialias on) into jit, the Gaussian, Fresnel[ and russian-roulette]
// rows into draws. Every thread of the block calls it: the key is read
// before the block's barrier, and under graph replay thread 0 takes the
// block's ticket after it; the last block advances the counter.
__device__ __forceinline__ void tile_draw(const RtRaysArgs& a, int i,
                                          bool in, float jit[3]) {
  __shared__ float bundle[8];
  const int row = threadIdx.x;
  if (row >= (a.antialias ? 0 : 3) && row < a.rows) {
    uint32_t k0, k1;
    tile_key(a.key_dev, a.iter_dev, a.key0, a.key1, k0, k1);
    bundle[row] = tile_value(
        k0, k1, row,
        static_cast<uint32_t>((a.n + kCoherentTile - 1) / kCoherentTile),
        static_cast<uint32_t>(blockIdx.x * kThreads / kCoherentTile));
  }
  __syncthreads();  // the bundle drawn; every read of iter_dev done
  if (a.iter_dev != nullptr && threadIdx.x == 0) {
    unsigned long long* it = reinterpret_cast<unsigned long long*>(
        a.iter_dev);
    __threadfence();
    if (atomicAdd(it + 1, 1ull) == gridDim.x - 1) {
      atomicAdd(it, 1ull);
      it[1] = 0;
    }
  }
  if (!in) return;
  const size_t n = static_cast<size_t>(a.n);
  if (a.antialias)  // constant indices: jit stays in registers
    for (int r = 0; r < 3; ++r) jit[r] = bundle[r];
  for (int r = 3; r < a.rows; ++r) a.draws[(r - 3) * n + i] = bundle[r];
}

// The ray set-up, one thread a lane; kCoherent: the tile draw (keys null)
// instead of the lane draw. Numerics as the plain version's torch ops on
// the card (built with --fmad=false): each product and sum rounds on its
// own, sums in torch's order ((a0*b0 + a1*b1) + a2*b2), the float32
// scalar of (u - 0.5) * scale, rsqrtf as torch.rsqrt.
template <bool kCoherent>
__global__ void __launch_bounds__(kThreads) wave_rays_kernel(
    const RtRaysArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < a.n;
  // a finished regen lane (sample_i >= spp) traces nothing: it draws
  // nothing, and K5 / K6 walk it from the park origin rt_wave_bounce
  // moved it to as its last path ended, along kParkUnit
  const bool finished = in && a.alive == nullptr && a.sample != nullptr &&
                        a.sample[i] >= a.spp;
  if (a.segs != nullptr) {  // the same for every thread of the grid
    const bool live = in && (a.alive != nullptr ? a.alive[i] != 0
                                                : !finished);
    const int count = __syncthreads_count(live);
    if (threadIdx.x == 0 && count > 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.segs),
                static_cast<unsigned long long>(count));
  }
  float jit[3] = {0.0f, 0.0f, 0.0f};
  // every thread of the grid: the block's barrier and ticket
  if (kCoherent) tile_draw(a, i, in && !finished, jit);
  if (!in) return;
  if (finished) {
    a.unit[0][i] = kParkUx;
    a.unit[1][i] = kParkUy;
    a.unit[2][i] = kParkUz;
    a.inv_len[i] = 1.0f;
    return;
  }
  const size_t n = static_cast<size_t>(a.n);
  if (!kCoherent) {
    uint32_t k0, k1;
    const uint32_t b = a.bounce != nullptr
                           ? static_cast<uint32_t>(a.bounce[i])
                           : static_cast<uint32_t>(a.bounce_const);
    lane_key(a.keys, a.n, i, a.sample, b, k0, k1);
    if (a.antialias)
      for (int r = 0; r < 3; ++r) jit[r] = lane_draw(k0, k1, r);
    for (int r = 3; r < a.rows; ++r)
      a.draws[(r - 3) * n + i] = lane_draw(k0, k1, r);
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
  const int blocks = (args->n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (args->keys != nullptr)
    wave_rays_kernel<false><<<blocks, kThreads, 0, st>>>(*args);
  else
    wave_rays_kernel<true><<<blocks, kThreads, 0, st>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
