// The primary ray of one pixel, from the camera's basis (sm_90a).
//
// models/camera.py::primary_rays over the scanline pixel order, for one
// pixel: the point tl + du * x + dv * y of the screen plane for pixel
// (x, y) = (i % width, i / width), the direction from the camera position
// to it and its first normalisation. The origin is the camera position.
// camera.cu (rt_camera_rays, K1's padded input) and warp.cu
// (rt_temporal_frame's warp arm, the rays _gather_history takes) call it.
//
// Numerics as the plain version's torch ops on the card (the sources are
// built with --fmad=false): each product and sum rounds on its own, in
// torch's order (tl + du * x) + dv * y, then - pos; the length is
// torch.linalg.vector_norm's on the card, whose reduction splits the three
// squares over two threads (x^2 + z^2 on one, y^2 on the other) and adds
// the two partial sums, so sqrt((x*x + z*z) + y*y), correctly rounded; the
// division is IEEE.

#pragma once

__device__ __forceinline__ void camera_ray(int i, int width,
                                           const float* pos,
                                           const float* tl,
                                           const float* du,
                                           const float* dv, float d[3]) {
  const float x = static_cast<float>(i % width);
  const float y = static_cast<float>(i / width);
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = ((tl[c] + du[c] * x) + dv[c] * y) - pos[c];
  const float len = sqrtf((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1]);
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = v[c] / len;
}
