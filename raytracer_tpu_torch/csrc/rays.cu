// The wavefront iteration's ray set-up before K5 / K6, and coherent
// sampling's tile draw as rows (sm_90a).
//
// rt_wave_rays is not a TPU kernel. In the JAX package XLA fuses its work
// around the Pallas hit kernel inside the jitted loop: the lane draw
// (raytracer_tpu/ops/rng.py:75-101) or coherent sampling's tile draw
// (:104-127), the antialias jitter (ops/scatter.py:34) and the padding and
// normalisation before the hit (ops/intersect_pallas.py:728-741). One
// thread a lane: it draws in registers (draw.cuh's lane_key and lane_draw,
// as rt_lane_randoms does), or, in the coherent arm, takes its tile's
// bundle (draw.cuh's tile_key and tile_value, as rt_tile_randoms does):
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
//
// rt_tile_randoms is not a TPU kernel either: coherent sampling's draw
// (raytracer_tpu/ops/rng.py:104-127), one bundle of 7 or 8 values per
// `tile` consecutive lanes, which JAX draws in XLA, written as (7|8, n)
// rows, each value repeated over its tile's lanes. No path launches it:
// rt_wave_rays draws the bundle itself (above); it stays for callers
// that want the rows (ops/rng.py tile_rows, tile_randoms, tile_rows_at).
// Plain version: ops/rng.py::tile_randoms_reference. Under a replayed
// CUDA graph the key is the tile key in device memory folded with the
// iteration counter there (draw.cuh's tile_key).
//
// What bounds it on an H100: the bytes it writes, 4 a lane and row (the
// bundle's 3 threefry calls a value are ~6,000 values on 800,000 lanes).
// What the design does about it: a block covers 1024 lanes (4 a thread).
// Where `tile` is a multiple of that span the block lies in one tile: its
// first `rows` threads draw the bundle once into shared memory (draw.cuh's
// tile_key and tile_value) and every thread stores it over its 4 lanes of
// each row, as one 16-byte store where the rows start 16-byte aligned
// (n % 4 == 0), else as 4 coalesced scalar stores; the last tile is cut
// at n. Where it is not (a small tile), each lane draws its own tile's
// values with the same functions, in the same kernel.

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

struct RtTileArgs {
  unsigned int key0, key1;  // the iteration's key, unless key_dev is set
  float* out;               // (rows, n)
  int n, rows, tile;        // rows 7, or 8 with the russian-roulette draw
  // Set under CUDA-graph replay: the iteration's key is
  // fold_in((key_dev[0], key_dev[1]), iter_dev[0]), read when the kernel
  // runs (uint32 values held in int64), not when it was captured.
  const long long* key_dev;
  const long long* iter_dev;
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

// rt_tile_randoms: a block of kTileSpan lanes (the top of this file).
constexpr int kTileLanes = 4;                     // lanes a thread
constexpr int kTileSpan = kTileLanes * kThreads;  // lanes a block

__global__ void __launch_bounds__(kThreads)
    tile_randoms_kernel(const RtTileArgs a) {
  const size_t n = static_cast<size_t>(a.n);
  const uint32_t nt = static_cast<uint32_t>((a.n + a.tile - 1) / a.tile);
  const int base = blockIdx.x * kTileSpan;
  if (a.tile % kTileSpan != 0) {  // a small tile: each lane draws its own
    uint32_t k0, k1;
    tile_key(a.key_dev, a.iter_dev, a.key0, a.key1, k0, k1);
    for (int j = 0; j < kTileLanes; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      if (i >= a.n) break;
      const uint32_t t = static_cast<uint32_t>(i / a.tile);
      for (int row = 0; row < a.rows; ++row)
        a.out[row * n + i] = tile_value(k0, k1, row, nt, t);
    }
    return;
  }
  // the block lies in one tile: draw its bundle once
  __shared__ float bundle[8];
  if (threadIdx.x < a.rows) {
    uint32_t k0, k1;
    tile_key(a.key_dev, a.iter_dev, a.key0, a.key1, k0, k1);
    bundle[threadIdx.x] = tile_value(k0, k1, threadIdx.x, nt,
                                     static_cast<uint32_t>(base / a.tile));
  }
  __syncthreads();
  const bool vec = (a.n & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
  if (vec) {  // n % 4 == 0: the thread's 4 lanes lie inside the frame
    const int i = base + kTileLanes * threadIdx.x;
    if (i >= a.n) return;
    for (int row = 0; row < a.rows; ++row) {
      const float v = bundle[row];
      *reinterpret_cast<float4*>(a.out + row * n + i) =
          make_float4(v, v, v, v);
    }
    return;
  }
  for (int j = 0; j < kTileLanes; ++j) {
    const int i = base + j * kThreads + threadIdx.x;
    if (i >= a.n) return;
    for (int row = 0; row < a.rows; ++row) a.out[row * n + i] = bundle[row];
  }
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

int rt_tile_randoms(const RtTileArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  if (args->tile <= 0 || args->rows < 7 || args->rows > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (args->n + kTileSpan - 1) / kTileSpan;
  tile_randoms_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
