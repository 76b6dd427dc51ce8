// The temporal frame's primary rays, K1's padded input (sm_90a).
//
// rt_camera_rays is not a TPU kernel. In the JAX package's temporal step
// (raytracer_tpu/runtime/renderer.py:355-362, :378) XLA fuses the primary
// rays (raytracer_tpu/models/camera.py:83-107) with the padding and the
// second normalisation in front of the megakernel
// (raytracer_tpu/ops/megakernel.py:1189-1202). One thread a padded lane:
// lane i < n gets the camera position and the unit direction of scanline
// pixel i (camera.cuh's camera_ray), a pad lane o = 0, d = (1, 0, 0); every
// direction is then multiplied by rsqrtf of its squared length. It writes
// the (3, n_pad) o and d that rt_megakernel reads. Plain version:
// models/camera.py::camera_rays_reference, which is
// ops/megakernel.py::pad_rays over models/camera.py::primary_rays.
//
// What bounds it on an H100: bytes. It reads a few dozen bytes of camera
// basis and writes 24 B a padded lane (8,323,072 lanes at 3840x2160 and
// pixpack 8: 199.8 MB, 0.060 ms at 3.35 TB/s); its ~40 float operations a
// lane are far below the 67 TFLOP/s line. What the design does about it:
// one pass, each plane written once with coalesced stores, nothing read.
//
// Numerics: as camera.cuh, then the second normalisation as pad_rays's
// torch ops: the squared length (x*x + y*y) + z*z, rsqrtf as torch.rsqrt,
// one product a component.

#include <cuda_runtime.h>
#include <stdint.h>

#include "camera.cuh"

extern "C" {

struct RtCameraRaysArgs {
  float* o;  // (3, n_pad) out, rows of n_pad
  float* d;  // (3, n_pad) out
  float pos[3], tl[3], du[3], dv[3];  // the camera's basis
  int n, n_pad, width;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    camera_rays_kernel(const RtCameraRaysArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_pad) return;
  float o[3] = {0.0f, 0.0f, 0.0f};
  float d[3] = {1.0f, 0.0f, 0.0f};
  if (i < a.n) {
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = a.pos[c];
    camera_ray(i, a.width, a.pos, a.tl, a.du, a.dv, d);
  }
  const float inv = rsqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  const size_t stride = static_cast<size_t>(a.n_pad);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.o[c * stride + i] = o[c];
    a.d[c * stride + i] = d[c] * inv;
  }
}

}  // namespace

extern "C" {

int rt_camera_rays(const RtCameraRaysArgs* args, void* stream) {
  if (args->n_pad <= 0) return 0;
  const int blocks = (args->n_pad + kThreads - 1) / kThreads;
  camera_rays_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
