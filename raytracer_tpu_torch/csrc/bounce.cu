// The wavefront samplers' bounce after the hit, fused (sm_90a).
//
// rt_wave_bounce is not a TPU kernel: in the JAX package XLA fuses the
// resolve after the Pallas hit kernel (raytracer_tpu/ops/
// intersect_pallas.py:851-906) and the elementwise body of a bounce
// (ops/integrator.py:59-126, and the regeneration bookkeeping of
// :251-355) around that kernel inside its jitted loop. The port ran that
// body as ~100 separate torch launches a bounce; this kernel does all of
// it in one. It reads K5's 12 raw outputs (t along the unit direction,
// code, u, v, centre or normal, material id, colour, smoothness), or K6's
// 9 (colour30 and smooth|mat decoded here as K5 decodes them), 1 / |d|
// and the direction traced, and resolves the hit as
// intersect_cuda.resolve does: t rescaled, the point, the sphere normal
// and (a template argument) its lat/long UV, the triangle normal flipped
// against the ray. Then the sky on a miss, the emission, the material
// lookup (ops/tables.py), the texture (ops/textures.py, the image atlas
// gathered here: the wavefront's own layout, not K4's plane), the scatter
// (ops/scatter.py), russian roulette, and, in its regen arm, the path end,
// the pixel sum, the sample and bounce counters, the restart on the lane's
// primary ray and the parking of a lane as its last sample ends (a lane
// that enters finished returns once its sample is loaded). One thread a
// lane, on the (3, n) SoA state, updated in place, with the lane's randoms
// from rt_wave_rays. Both arms (scan: an alive mask, no regeneration; regen)
// are template arguments. Plain version: ops/bounce.py::
// wave_bounce_reference.
//
// Numerics. Bitwise with the plain version's torch ops on the card: built
// with --fmad=false, each product and sum rounds on its own as a torch
// elementwise op does, in the same order (torch's (a0*b0 + a1*b1) + a2*b2);
// IEEE division and sqrtf as torch.div and torch.sqrt, a division by a
// float scalar as torch's CUDA kernel does it (times the float32
// reciprocal); rsqrtf as torch.rsqrt, asinf and acosf as torch.asin and
// torch.acos; torch.clamp and torch.amax let a NaN through (clamp_max,
// clamp_min, clamp2, max_nan); textures._trunc_int sends NaN to 0 and
// clamps to +-2147483520 before truncating (__float2int_rz alone would
// saturate at 2^31 - 1, another parity); int32 sums wrap as torch's do
// (unsigned).
//
// What bounds it on an H100: bytes. Each lane reads its state, the hit
// kernel's raw outputs and its randoms once and writes its state once,
// ~250 bytes a lane on the regen arm; the material rows and texels are
// few and stay in L1/L2. The design: a simple kernel, one pass, no
// staging; the resolve costs no bytes of its own; a finished regen lane
// (sample_i >= spp) costs its 4-byte sample, since nothing it would read
// or write changes its pixel.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct RtBounceArgs {
  // lane state, updated in place: (3, n) rows and (n,) columns
  float* o[3];
  float* d[3];
  float* thru[3];
  float* rad[3];
  float* ior;
  unsigned char* alive;  // scan arm: the alive mask in and out
  float* pixel_sum[3];   // regen arm
  int* sample;           // regen arm
  int* bounce;           // regen arm
  const float* o0p[3];   // regen arm: the lane's primary ray
  const float* d0p[3];
  // this bounce's inputs
  const float* dj[3];     // the (jittered) direction traced
  const void* raw[12];    // K5's 12 outputs, or K6's 9 (pa, pb last)
  const float* inv_len;   // 1 / |dj| (t is along dj / |dj|)
  const float* gauss[3];
  const float* fresnel;
  const float* rr;  // the russian-roulette uniform; null when off
  // the scene's material and texture tables, (M,) or (M, 3) row-major
  const int* mat_type;
  const float* mat_ior;
  const float* mat_emit;
  const int* tex_type;
  const float* tex_light;
  const float* tex_dark;
  const float* tex_nsq;
  const int* tex_off;
  const int* tex_w;
  const int* tex_h;
  const float* atlas;  // (atlas_rows, 3); one row: no image texture
  int atlas_rows;
  float sky[3];
  int n;
  int bounce_const;  // scan arm: the bounce index russian roulette reads
  int rr_start;      // settings.russian_roulette (0: off)
  int limit, spp;
  int fix_exit_ior, has_refractive, emissive_terminates;
  int regen;      // 1: the regen arm, 0: the scan arm
  int blocked;    // 1: raw holds K6's 9 outputs
  int sphere_uv;  // scene.needs_sphere_uv: resolve the sphere UV
};

}  // extern "C"

namespace {

constexpr int kMatEmissive = 1, kMatRefractive = 2;
constexpr int kTexColour = 0, kTexGradient = 1, kTexChecker = 2,
              kTexImage = 3;
constexpr float kTruncLim = 2147483520.0f;  // largest float32 < 2^31
constexpr float kParkOrigin = 1e13f;
constexpr float kInf = 1e30f;  // sweep.INF: a miss
// torch.pi / 2.0 and the float32 reciprocal torch's CUDA division by the
// scalar torch.pi multiplies by
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kInvPi = 1.0f / 3.14159265358979323846f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.clamp with one bound: a NaN passes through.
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return is_nan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}

// torch.clamp with both bounds.
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.amax's pairwise rule: a NaN wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (is_nan(a) || a > b) ? a : b;
}

// textures._trunc_int: NaN -> 0, clamped to +-kTruncLim, toward zero.
__device__ __forceinline__ int trunc_int(float x) {
  if (is_nan(x)) return 0;
  return __float2int_rz(fminf(fmaxf(x, -kTruncLim), kTruncLim));
}

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// scatter._normalize: a * rsqrt(a . a), no epsilon guard.
__device__ __forceinline__ V3 normalize(V3 a) {
  const float r = rsqrtf(dot3(a, a));
  return V3{a.x * r, a.y * r, a.z * r};
}

__device__ __forceinline__ V3 load3(const float* const p[3], int i) {
  return V3{p[0][i], p[1][i], p[2][i]};
}

__device__ __forceinline__ void store3(float* const p[3], int i, V3 a) {
  p[0][i] = a.x;
  p[1][i] = a.y;
  p[2][i] = a.z;
}

__device__ __forceinline__ V3 row3(const float* t, int m) {
  return V3{t[3 * m], t[3 * m + 1], t[3 * m + 2]};
}

// K5's colour30 channel and smoothness decode (megakernel.cu, K6's
// sweep.decode_colour30 / decode_smooth_mat).
__device__ __forceinline__ float c30(int pa, int shift) {
  return static_cast<float>((pa >> shift) & 1023) * (1.0f / 1023.0f);
}

// The hit as intersect_cuda.resolve gives it, from the raw outputs.
struct Resolved {
  bool hit;
  V3 point, normal;
  float u, v;
  int mat_id;
};

template <bool kBlocked, bool kSphereUV>
__device__ __forceinline__ Resolved resolve(const RtBounceArgs& a, int i,
                                            V3 o, V3 dj) {
  const float t_unit = static_cast<const float*>(a.raw[0])[i];
  const int code = static_cast<const int*>(a.raw[1])[i];
  // t along the caller's direction: where(t < INF, t * inv_len, INF)
  const float t = t_unit < kInf ? t_unit * a.inv_len[i] : kInf;
  Resolved r;
  r.hit = t < kInf;
  const bool is_tri = (code & 1) == 1;
  const float safe_t = r.hit ? t : 0.0f;
  r.point = V3{o.x + dj.x * safe_t, o.y + dj.y * safe_t, o.z + dj.z * safe_t};
  const V3 c{static_cast<const float*>(a.raw[4])[i],
             static_cast<const float*>(a.raw[5])[i],
             static_cast<const float*>(a.raw[6])[i]};
  // sphere: c is the centre; outward normal and lat/long UV
  // (src/objects.cu:66, 82-97)
  const V3 rel{r.point.x - c.x, r.point.y - c.y, r.point.z - c.z};
  const float rmag = rsqrtf(clamp_min(dot3(rel, rel), 1e-24f));
  const V3 sph_n{rel.x * rmag, rel.y * rmag, rel.z * rmag};
  float sph_u = 0.0f, sph_v = 0.0f;
  if (kSphereUV) {
    const float theta = asinf(clamp2(sph_n.y, -1.0f, 1.0f));
    const float phi = acosf(clamp2(sph_n.x, -1.0f, 1.0f));
    sph_u = (theta + kHalfPi) * kInvPi;
    const float v_ratio = (1.0f - phi * kInvPi) * 0.5f;
    const float behind = r.point.z > c.z ? 1.0f : 0.0f;
    sph_v = behind + (1.0f - 2.0f * behind) * v_ratio;
  }
  // triangle: c is the geometric normal, flipped against the ray
  // (src/objects.cu:158)
  const float flip = 1.0f - 2.0f * (dot3(c, dj) > 0.0f ? 1.0f : 0.0f);
  r.normal = is_tri ? V3{c.x * flip, c.y * flip, c.z * flip} : sph_n;
  r.u = is_tri ? static_cast<const float*>(a.raw[2])[i] : sph_u;
  r.v = is_tri ? static_cast<const float*>(a.raw[3])[i] : sph_v;
  r.mat_id = kBlocked ? static_cast<const int*>(a.raw[8])[i] & 0xFFFF
                      : static_cast<const int*>(a.raw[7])[i];
  return r;
}

template <bool kBlocked>
__device__ __forceinline__ V3 hit_colour(const RtBounceArgs& a, int i) {
  if (kBlocked) {
    const int pa = static_cast<const int*>(a.raw[7])[i];
    return V3{c30(pa, 20), c30(pa, 10), c30(pa, 0)};
  }
  return V3{static_cast<const float*>(a.raw[8])[i],
            static_cast<const float*>(a.raw[9])[i],
            static_cast<const float*>(a.raw[10])[i]};
}

template <bool kBlocked>
__device__ __forceinline__ float hit_smooth(const RtBounceArgs& a, int i) {
  if (kBlocked)
    return static_cast<float>(
               (static_cast<const int*>(a.raw[8])[i] >> 16) & 255) *
           (1.0f / 255.0f);
  return static_cast<const float*>(a.raw[11])[i];
}

template <bool kRegen, bool kBlocked, bool kSphereUV>
__global__ void __launch_bounds__(256)
    wave_bounce_kernel(const RtBounceArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  int sample_i = 0, bounce_i = 0, bounces_done;
  bool alive;
  if (kRegen) {
    sample_i = a.sample[i];
    // a finished lane (all its samples traced) keeps its state: it reads
    // none of the hit kernel's outputs or its randoms and stores nothing
    if (sample_i >= a.spp) return;
    bounce_i = a.bounce[i];
    alive = true;
    bounces_done = bounce_i;
  } else {
    alive = a.alive[i] != 0;
    bounces_done = a.bounce_const;
  }
  V3 o = load3(a.o, i);
  V3 thru = load3(a.thru, i);
  V3 rad = load3(a.rad, i);
  const V3 dj = load3(a.dj, i);
  float cur_ior = a.ior[i];
  const Resolved res = resolve<kBlocked, kSphereUV>(a, i, o, dj);
  const bool hit = res.hit;

  // a miss adds the sky and ends the path (src/raytracer.cu:76-80)
  const bool miss = alive && !hit;
  rad.x = rad.x + (miss ? thru.x * a.sky[0] : 0.0f);
  rad.y = rad.y + (miss ? thru.y * a.sky[1] : 0.0f);
  rad.z = rad.z + (miss ? thru.z * a.sky[2] : 0.0f);

  // emission adds, else the throughput takes the texture colour
  // (src/raytracer.cu:86-90)
  const int m = res.mat_id;
  const int mtype = a.mat_type[m];
  const bool is_em = mtype == kMatEmissive;
  const bool live_hit = alive && hit;
  const bool em_add = live_hit && is_em;
  const V3 emit = row3(a.mat_emit, m);
  rad.x = rad.x + (em_add ? thru.x * emit.x : 0.0f);
  rad.y = rad.y + (em_add ? thru.y * emit.y : 0.0f);
  rad.z = rad.z + (em_add ? thru.z * emit.z : 0.0f);

  // the texture (textures.py:22-61): all four types, one selected
  const float u = res.u, v = res.v;
  const int ttype = a.tex_type[m];
  const float nsq = a.tex_nsq[m];
  const int uc = trunc_int(u * nsq), vc = trunc_int(v * nsq);
  const bool light =
      ((static_cast<unsigned>(uc) + static_cast<unsigned>(vc)) & 1u) == 0u;
  V3 tex = ttype == kTexColour ? hit_colour<kBlocked>(a, i)
                               : V3{0.0f, 0.0f, 0.0f};
  if (ttype == kTexGradient) tex = V3{u, v, 0.0f};
  if (ttype == kTexChecker)
    tex = light ? row3(a.tex_light, m) : row3(a.tex_dark, m);
  if (a.atlas_rows > 1 && ttype == kTexImage) {
    const int w = a.tex_w[m], h = a.tex_h[m];
    const int ui =
        min(max(trunc_int(static_cast<float>(w - 1) * u), 0), w - 1);
    const int vi =
        min(max(trunc_int(static_cast<float>(h - 1) * v), 0), h - 1);
    const int flat = static_cast<int>(static_cast<unsigned>(a.tex_off[m]) +
                                      static_cast<unsigned>(vi) *
                                          static_cast<unsigned>(w) +
                                      static_cast<unsigned>(ui));
    tex = row3(a.atlas, min(max(flat, 0), a.atlas_rows - 1));
  }
  if (live_hit && !is_em) {
    thru.x = thru.x * tex.x;
    thru.y = thru.y * tex.y;
    thru.z = thru.z * tex.z;
  }

  // the scatter (scatter.py:68-149): every model, selected by material
  const V3 nrm = res.normal;
  const V3 g = load3(a.gauss, i);
  const float gflip = dot3(g, nrm) < 0.0f ? -1.0f : 1.0f;
  const V3 ru = normalize(V3{g.x * gflip, g.y * gflip, g.z * gflip});
  const V3 diffuse = normalize(V3{nrm.x + ru.x, nrm.y + ru.y, nrm.z + ru.z});
  const float s2 = 2.0f * dot3(dj, nrm);
  const V3 spec =
      normalize(V3{dj.x - nrm.x * s2, dj.y - nrm.y * s2, dj.z - nrm.z * s2});
  const float sm = hit_smooth<kBlocked>(a, i);
  const V3 refl = normalize(V3{diffuse.x + (spec.x - diffuse.x) * sm,
                               diffuse.y + (spec.y - diffuse.y) * sm,
                               diffuse.z + (spec.z - diffuse.z) * sm});
  V3 new_d = refl;
  float new_ior = cur_ior;
  if (a.has_refractive) {
    // sphere normals stay outward: d . n > 0 means exiting (ray.cu:84-96)
    const float mior = a.mat_ior[m];
    const bool exiting = dot3(nrm, dj) > 0.0f;
    const float n1 = exiting ? mior : cur_ior;
    const float exit_ior = a.fix_exit_ior ? 1.0f : cur_ior;
    const float n2 = exiting ? exit_ior : mior;
    const float sgn = exiting ? 1.0f : -1.0f;
    const V3 rn{nrm.x * sgn, nrm.y * sgn, nrm.z * sgn};
    const float cos1 = clamp_max(dot3(dj, rn), 1.0f);
    const float sin1 = sqrtf(clamp_min(1.0f - cos1 * cos1, 0.0f));
    const float sin2 = clamp_max(n1 * sin1 / n2, 1.0f);
    const float cos2 = sqrtf(clamp_min(1.0f - sin2 * sin2, 0.0f));
    const bool tir = sin1 > n2 / n1;
    const float sq0 = (n1 - n2) / (n1 + n2);
    const float r0 = sq0 * sq0;
    const float mm = 1.0f - cos1;
    const float m2 = mm * mm;
    const float refl_coeff = r0 + (1.0f - r0) * (m2 * m2 * mm);
    const bool do_reflect = tir || (refl_coeff > a.fresnel[i]);
    // normal incidence, theta1 == 0 (src/ray.cu:116-121)
    const float safe_sin1 = sin1 == 0.0f ? 1.0f : sin1;
    V3 perp{0.0f, 0.0f, 0.0f};
    if (sin1 != 0.0f)
      perp = V3{(dj.x - rn.x * cos1) / safe_sin1,
                (dj.y - rn.y * cos1) / safe_sin1,
                (dj.z - rn.z * cos1) / safe_sin1};
    const V3 refr = normalize(V3{rn.x * cos2 + perp.x * sin2,
                                 rn.y * cos2 + perp.y * sin2,
                                 rn.z * cos2 + perp.z * sin2});
    const bool is_refr = mtype == kMatRefractive;
    if (is_refr && !do_reflect) new_d = refr;
    const bool upd = a.fix_exit_ior ? (is_refr && !do_reflect) : is_refr;
    if (upd) new_ior = n2;
  }
  V3 d = dj;
  if (live_hit) {
    o = res.point;
    d = new_d;
    cur_ior = new_ior;
  }

  bool cont = live_hit;
  if (a.emissive_terminates) cont = cont && !is_em;
  if (a.rr != nullptr) {
    // russian roulette: survive with p = clamp(max(throughput), 0.05, 1)
    const float mx = max_nan(max_nan(thru.x, thru.y), thru.z);
    const float p = is_nan(mx) ? mx : fminf(fmaxf(mx, 0.05f), 1.0f);
    const bool eligible = cont && (bounces_done + 1 >= a.rr_start);
    const bool survive = a.rr[i] < p;
    if (eligible && survive) {
      thru.x = thru.x / p;
      thru.y = thru.y / p;
      thru.z = thru.z / p;
    }
    cont = cont && !(eligible && !survive);
  }

  if (kRegen) {
    // a path ends on a miss or termination, or at the bounce limit; the
    // lane regenerates onto its pixel's next sample
    const bool path_end = alive && (!cont || bounce_i + 1 >= a.limit);
    V3 ps = load3(a.pixel_sum, i);
    ps.x = ps.x + (path_end ? rad.x : 0.0f);
    ps.y = ps.y + (path_end ? rad.y : 0.0f);
    ps.z = ps.z + (path_end ? rad.z : 0.0f);
    store3(a.pixel_sum, i, ps);
    const int new_sample = path_end ? sample_i + 1 : sample_i;
    a.sample[i] = new_sample;
    a.bounce[i] = path_end ? 0 : (alive ? bounce_i + 1 : bounce_i);
    if (path_end) {
      o = load3(a.o0p, i);
      d = load3(a.d0p, i);
      thru = V3{1.0f, 1.0f, 1.0f};
      rad = V3{0.0f, 0.0f, 0.0f};
      cur_ior = 1.0f;
    }
    if (new_sample >= a.spp) {
      // park the lane its last path end finished far away: the ray set-up
      // walks it from there along its park direction, which enters no
      // box; d here is what rebin / lanesort bucket it by
      o = V3{kParkOrigin, kParkOrigin, kParkOrigin};
      d = V3{1.0f, 0.0f, 0.0f};
    }
  } else {
    a.alive[i] = cont ? 1 : 0;
  }
  store3(a.o, i, o);
  store3(a.d, i, d);
  store3(a.thru, i, thru);
  store3(a.rad, i, rad);
  a.ior[i] = cur_ior;
}

}  // namespace

extern "C" {

int rt_wave_bounce(const RtBounceArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const int blocks = (args->n + 255) / 256;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int arm = (args->regen ? 4 : 0) + (args->blocked ? 2 : 0) +
                  (args->sphere_uv ? 1 : 0);
  switch (arm) {
#define RT_BOUNCE_ARM(k, R, B, U) \
  case k:                         \
    wave_bounce_kernel<R, B, U><<<blocks, 256, 0, st>>>(*args); break;
    RT_BOUNCE_ARM(0, false, false, false)
    RT_BOUNCE_ARM(1, false, false, true)
    RT_BOUNCE_ARM(2, false, true, false)
    RT_BOUNCE_ARM(3, false, true, true)
    RT_BOUNCE_ARM(4, true, false, false)
    RT_BOUNCE_ARM(5, true, false, true)
    RT_BOUNCE_ARM(6, true, true, false)
    RT_BOUNCE_ARM(7, true, true, true)
#undef RT_BOUNCE_ARM
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
