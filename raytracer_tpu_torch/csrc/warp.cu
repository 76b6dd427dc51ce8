// Temporal-history kernels for Hopper (sm_90a): the warp gather (K7) and
// the temporal frame's epilogue with its fused history reprojection.
//
// rt_warp_gather replaces K7 of raytracer_tpu,
//   ops/warp.py:52-101  _kernel, via banded_gather :104 (pallas_call :129):
// out[i] = valid[i] ? values[idx[i]] : 0 over int32 words. The TPU kernel
// reduces each 32x128 output tile's [min, max] source row, DMAs that band
// of the plane into VMEM pages and resolves every lane with a row-select
// sweep, because its vector unit has no per-lane random load
// (warp.py:9-24). A GPU thread loads its own word, so there is no band,
// page or sweep here: one thread per query, one 4-byte load.
//
// rt_temporal_frame is not a TPU kernel: it is XLA's fusion after the
// megakernel in the JAX temporal step (renderer.py:355-391, _tstep and
// _tstep_warp), one thread a pixel, reading K1's (5, n_pad) output in
// place. Static arm (_tstep, :365-367): accum = (mean + accum * w) /
// (w + 1) and w + 1, in place, each pixel reading only itself. Warp arm
// (_tstep_warp, :369-377, :386-388; the first frame after a move): the
// pixel's primary ray from the current camera basis (camera.cuh's
// camera_ray: the first normalisation, the rays _gather_history takes, so
// no ray array is read), its depth (row 4), the history gather
// (warp.cuh's gather_pixel: renderer.py:53-122, _pack_history_body then
// _gather_history, fused per pixel, K7's load inside) and the blend,
// written to a fresh accumulation and weight plane, never the one it
// reads from. Both arms also add up the frame's segment count (row 3, the
// pixels [0, n)), as the plain version's out[3, :n].sum(dtype=float64)
// does: exactly, since the counts are integers. Scanline pixel order
// only: pixel i is screen pixel (i % width, i / width).
// Plain versions: ops/warp.py::warp_gather_reference and
// temporal_frame_reference (gather_history_reference: pack_history over
// the whole plane, then the gather; then film.temporal_update).
//
// What bounds them on an H100: bytes. rt_temporal_frame moves 48 B a
// pixel in the static arm (mean and segments, accumulation and weight
// read, the last two written) and 52 B in the warp arm (mean, segments
// and depth read, 16 B of old pixel, 16 B written): 398 and 431 MB at
// 3840x2160, 0.119 and 0.129 ms; the warp arm's ~120 float operations a
// pixel are far below the 67 TFLOP/s line. rt_warp_gather moves 13 B a
// query. Under a small camera move neighbouring threads read neighbouring
// source pixels, so the "random" loads coalesce much as a stream does.
// What the design does about that: one pass, no intermediate in device
// memory (the warp frame's rays, packed plane and gathered history never
// leave registers), each output written once; loads are not vectorised.
//
// Numerics: warp.cuh's and camera.cuh's; the blend is
// (h * w + m) / (w + 1) with IEEE division, as film.temporal_update's
// mul_, add_ and div_ round on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "camera.cuh"
#include "warp.cuh"

extern "C" {

struct RtWarpGatherArgs {
  const int* values;           // (m,)
  const int* idx;              // (n,)
  const unsigned char* valid;  // (n,) bool
  int* out;                    // (n,)
  int m, n;
};

struct RtTemporalArgs {
  const float* out;    // K1's (5, stride) output: mean rows 0-2, the
                       // lanes' segment counts row 3, depth row 4
  const float* accum;  // (n, 3): static arm this view's accumulation,
                       // warp arm the old view's
  const float* wpix;   // (n,) its weights
  float* accum_out;    // (n, 3) out; the static arm's is accum
  float* w_out;        // (n,) out; the static arm's is wpix
  unsigned long long* seg_acc;  // (2,) zero at launch, zero after it
  double* segs;        // out: the segment counts of pixels [0, n), added
  float cpos[3], ctl[3], cdu[3], cdv[3];      // the current camera
  float pos[3], tl[3], du[3], dv[3], nrm[3];  // the old pinhole
  float focal, dudu, dvdv;
  float history;       // the history cap on the old weights
  float scale;         // HIST_MAX / 511^2: radiance per squared code
  long long stride;
  int width, height, warp;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    warp_gather_kernel(const RtWarpGatherArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  a.out[i] =
      a.valid[i] ? __ldg(a.values + warp::clamp_index(a.idx[i], a.m)) : 0;
}

// The frame's segment count: the threads' sums of the lanes' counts
// (integers in float32) added exactly in 64 bits, one atomic add a block;
// the last block to add (the blocks done, counted after a fence) writes
// the sum and zeroes the two words for the next launch. So no zeroing runs
// between frames.
__device__ __forceinline__ void add_segments(const RtTemporalArgs& a,
                                             unsigned long long c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  __shared__ unsigned long long warp_sum[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long sum = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) sum += warp_sum[k];
  atomicAdd(a.seg_acc, sum);
  __threadfence();
  if (atomicAdd(a.seg_acc + 1, 1ull) == gridDim.x - 1) {
    __threadfence();
    *a.segs = static_cast<double>(atomicAdd(a.seg_acc, 0ull));
    a.seg_acc[0] = 0;
    a.seg_acc[1] = 0;
  }
}

// Pixel i's blend (after the gather in the warp arm); returns its lane
// segment count.
template <bool kWarp>
__device__ __forceinline__ float frame_pixel(const RtTemporalArgs& a,
                                             int i) {
  const size_t i3 = 3 * static_cast<size_t>(i);
  const size_t stride = static_cast<size_t>(a.stride);
  float hist[3], w;
  if constexpr (kWarp) {
    float d[3];
    camera_ray(i, a.width, a.cpos, a.ctl, a.cdu, a.cdv, d);
    warp::gather_pixel(a, i, a.cpos, d, a.out[4 * stride + i], hist, w);
  } else {
    // accum and wpix are written below: plain loads, not read-only ones
#pragma unroll
    for (int c = 0; c < 3; ++c) hist[c] = a.accum[i3 + c];
    w = a.wpix[i];
  }
  const float w1 = w + 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a.accum_out[i3 + c] = (hist[c] * w + a.out[c * stride + i]) / w1;
  a.w_out[i] = w1;
  return a.out[3 * stride + i];
}

// At most kFrameBlocks blocks, each thread striding over the pixels, so
// that the segment count takes few atomic adds on its one word (a block of
// 256 pixels each would make 32,400 at 3840x2160).
constexpr int kFrameBlocks = 2048;

template <bool kWarp>
__global__ void __launch_bounds__(kThreads)
    temporal_frame_kernel(const RtTemporalArgs a) {
  const int n = a.width * a.height;
  unsigned long long segs = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    segs += static_cast<unsigned long long>(frame_pixel<kWarp>(a, i));
  add_segments(a, segs);
}

}  // namespace

extern "C" {

int rt_warp_gather(const RtWarpGatherArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int blocks = (args->n + kThreads - 1) / kThreads;
  warp_gather_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

int rt_temporal_frame(const RtTemporalArgs* args, void* stream) {
  const int n = args->width * args->height;
  if (n <= 0) return 0;
  const int need = (n + kThreads - 1) / kThreads;
  const int blocks = need < kFrameBlocks ? need : kFrameBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->warp)
    temporal_frame_kernel<true><<<blocks, kThreads, 0, s>>>(*args);
  else
    temporal_frame_kernel<false><<<blocks, kThreads, 0, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
