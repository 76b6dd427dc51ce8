"""Smoke run of raytracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

Run from the root of a checkout, on a machine with one NVIDIA card (the
kernels are built for sm_90a, an H100). It builds the CUDA kernels from
``raytracer_tpu_torch/csrc``, holds each against its plain PyTorch version
on the card (``rt_nearest_hit``, ``rt_fetch_image``, and ``rt_megakernel``
on scenes 4, 2 and 0, bitwise), drives two paths through ``Renderer`` at
1000x800, 20 spp, 5 bounces and times them: the bench.py path (scene 4) and the
image-texture path (scene 2, the 256x512 earth), then times one frame of
each bench scene of benchmarks/suite.py through the kernel.

Then the wavefront samplers: the iteration's ray set-up
``rt_wave_rays`` (1M and 800,000 lanes; regen, scan and coherent arms;
phase 8), K5
``rt_hit_resolve`` (65,536 and 1M rays over scenes 4 and 2) and K6
``rt_hit_resolve_blocked`` with K5 beside it (65,536 and 1M rays over
stress100k) against their plain versions, one ``Renderer`` frame of each
sampler (regen, scan, rebin, lanesort) against the plain route with rebin
and lanesort bitwise equal to regen, ``rt_wave_bounce`` (the resolve and
the bounce after the hit, fused) against its plain version on K5's and
K6's raw outputs, bitwise, in both arms on 256x128 lanes of scenes 1-4,
stress100k and earth2048 and timed on scene 4's 1000x800 regen lanes
(phase 19), the ray set-up, K5 (K6 on the pyramid) and the bounce timed
on the 1000x800 lanes of the three regen cells with none, a frame's share
(73% on scene 4, 27% on scene 2, measured on the pyramid) and all of them
finished, the hit kernel with and without the regen loop's skip (phase
20),
and four regen paths through ``Renderer`` at 1000x800, 5
bounces: scene 4 at 20 spp (K5), per lane and with coherent sampling,
stress100k at 4 spp (K6) and the 1024x2048 earth at 20 spp (K5 + the
atlas gather), each with its frame ms, the graph replays and kernel
launches a frame (an iteration: the ray set-up, K5 or K6 and the bounce,
and no other entry point: the coherent ray set-up draws each tile's
bundle itself), one frame under
torch.profiler (the device ms of K5 / K6, the ray set-up and
``rt_wave_bounce``, the busy share, the kernel and graph launches the
host issued against the device ops that ran and their count an
iteration, the top kernels, and no torch.cat padding or torch resolve
among them) and its first frame against the plain route at 256x128. On
the card the wavefront samplers replay their iterations as CUDA graphs
(ops/wave_graph.py), so the launch counts come from each graph's
captured launches times its replays. Launches are read from the
program counts (utils/trace.py), which count every entry point, so each
check of a path's launches also finds any other entry point that ran.

Then the temporal fly-through (phase 13). A temporal frame on the card is
``rt_camera_rays`` (the padded primary rays from the camera basis, at a
camera's first frame), ``rt_megakernel`` and ``rt_temporal_frame`` (the
blend, and after a move the history gather before it). A 256x128 temporal
``Renderer`` through a frame, a move, a frame, two moves and a frame,
bitwise against the same steps composed from the plain versions, with its
launches; ``rt_camera_rays`` against its plain version, bitwise, on the
4K fly camera, bench.py's camera and a 130x70 film (pixpack 1 and 8);
``rt_warp_gather`` (K7) and both arms of ``rt_temporal_frame`` against
their plain versions, bitwise, on the 4K move's real projection (K7 also
on a full-range pattern), each new kernel
timed as a bare launch, by the profiler and through its wrapper beside
its bound; benchmarks/suite.py's fly-through, scene 4 at 3840x2160, 1
spp, 5 bounces, 16 camera moves each followed by a frame, timed with one
final sync, with its launches (16 of each of the three kernels, no K7 or
other entry point), then a static and a warp frame in CUDA events; and, in a
fresh process, a static frame, a warp frame and the 16-frame fly window
under torch.profiler: device ms by kernel, device ops, the busy share,
and no kernel but the three and the segment count's sum (no torch.cat,
rsqrt, norm, mul, add, div or fill) in the fly window.

Then coherent sampling and K5's counters (phase 14): (a) the coherent arm
of ``rt_megakernel`` against ``mega_reference``'s on scenes 4, 2 and 0 at
256x128, pixpack 1 and 8; (b) a coherent 256x128 regen ``Renderer``
frame (the ray set-up drawing the tile bundles) against the plain route;
(c) coherent against
per-lane sampling through ``Renderer`` at 1000x800, alternating, on the
scene-4 and stress10k megakernel paths (20 spp, pixpack 8) and the
scene-4 (20 spp, K5) and stress100k (4 spp, K6) regen paths, each
coherent first frame against the plain version (scene 4 whole, two
stress10k tiles, a 16-row band of each regen path); (d) the counting
``rt_hit_resolve`` against its plain version on
65,536 rays over scenes 4 and 2 at every G, and the mean primitive tests
per ray that the bounds below use (K6's counted by a plain-torch walk over
its blocked tables); (e) ``render_resilient`` over 3 frames with
one injected out-of-memory error, against an uninterrupted run.

Then multi-device rendering (phase 16): (a) a one-rank NCCL process group
(``initialize()`` from torchrun's environment) renders
``Renderer(sharding=pixel_sharding(make_mesh()))`` on scene 4 at
1000x800, 20 spp, in turns with the unsharded Renderer, bitwise, with
the frame ms of both; (b) the ranks of pixel meshes (world 2 and 4,
pixpack 1 and 8), an spp mesh (world 2) and a 2x2 hybrid mesh render in
turn on the one card through their local step, joined and held bitwise
against the unsharded scene-4 frame at 1024x1024, 20 spp (and the regen
sampler at 256x128), with each rank's ms and the max/mean over ranks,
rank 1 of the pixpack-8 pair also bitwise against ``mega_reference`` at
its tile offset, and the launches of the ranks' own local steps; (c)
``dryrun_multichip(1)`` in a spawned NCCL process. K4 and
``rt_wave_rays`` are timed as bare launches on prebuilt arguments
(``ms``; ``profiled_ms`` the profiler's device time a launch) beside
their wrappers (``wrapper_ms``).

Then the goldens and the rest of the public API (phases 17-18): scenes
0-4 at the goldens' settings (48x32, 24 spp) through the regen sampler's
kernel route, bitwise against the plain route, with each PSNR against
``tests/goldens`` (scenes 1-4 judged by tests/test_torch_golden.py's
bounds, scene 0 printed: its golden needs a mesh the repository lacks);
``trace`` on scene 4 at 1000x800, one sample, on a WaveScene whose graph
the warm-up call captures, kernel route against ``backend="plain"``,
bitwise; and ``Renderer.profile_frame`` on the
bench.py path, its Chrome trace read back for the megakernel's device
events, their ms and share of the window.

K1, K2, K5 and K6 run with G threads a lane slot (or ray), G picked by a
rule (``megakernel.mega_group``, ``sweep.nearest_group``,
``intersect_cuda.resolve_group`` and ``blocked_group``). Phase 2 prints
every group arm's registers, spills and resident warps per SM and the
rules' G on the main paths; phases 3, 5, 9, 10, 14a and 14d hold every
arm (the rule's G and G = 1, 2, 4, 8) bitwise against the plain versions.
With ``--parent DIR`` (an earlier tree of this repository, unpacked with
``git archive``), phase 15 times the K1 and K2 paths of phases 3, 6, 7, 13
and 14c and the K5 and K6 paths of phases 9, 10 and 12 (the three regen
paths' frame ms and busy shares) and phase 18a's ``trace`` on that tree
and on this checkout in turns (parent, change, change, parent), one
``scripts/k1_groups.py paths`` process per turn, and prints both; the
kernels line then carries the parent's times.

Every kernel in the closing ``{"kernels": ...}`` line carries its bound:
the larger of the bytes it must move over 3.35 TB/s and the FP32
operations this run's inputs need over 67 TFLOP/s, the H100 SXM's
published peaks. The BVH kernels' operations are the primitive tests that
their gates let through, counted on this run's rays by K5's counters
(``tests_per_ray``; K6's by a plain-torch walk over its blocked tables,
``blocked_walk_tests``), times the operations of one test, plus the work done
whatever the gates; the plain versions' brute-force count rides beside it
as ``plain_ops``. The megakernel has no counters: its
``tests_per_segment`` is an estimate, counted on the segments of a
scan-sampler frame of the same scene, camera and spp.

Every phase prints one line; any failed check raises, so the script exits
non-zero. It also exits non-zero, before printing any result, when no CUDA
device is available. The last line is ``{"ok": true, "device": {...}}``;
the line before it lists the kernels with their launches on the paths,
their error against the plain version and their times.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Tolerances against the plain PyTorch version on the card. Both evaluate
# the same IEEE float32 operations in the same order (the kernel is built
# without contraction into FMA) and draw the same hash bits, so they differ
# only where the kernel's per-thread cluster gate skips a box that the plain
# version (no gate) sweeps, or where torch's and the kernel's library calls
# round differently. A path that diverges changes its pixel by up to the
# full radiance, hence per-pixel quantiles instead of an all-pixel bound.
HIT_CODE_MISMATCH_MAX = 1e-4     # share of rays with another winner
HIT_T_REL_MAX = 1e-5             # |dt| / max(1, t) where the winner agrees
PIXEL_ABS = 1e-4                 # per-pixel |d radiance| ...
PIXEL_SHARE_MIN = 0.99           # ... met by at least this share of pixels
PIXEL_MEAN_ABS_MAX = 1e-3        # mean |d radiance| over all pixels
SEGS_REL_MAX = 5e-3              # traced segments of the frame
FRAME_MEAN_REL_MAX = 1e-3        # frame-mean radiance, kernel vs plain

KERNEL_SOURCE = "raytracer_tpu_torch/csrc/megakernel.cu"
WAVEFRONT_SOURCE = "raytracer_tpu_torch/csrc/wavefront.cu"
WARP_SOURCE = "raytracer_tpu_torch/csrc/warp.cu"
BOUNCE_SOURCE = "raytracer_tpu_torch/csrc/bounce.cu"
RAYS_SOURCE = "raytracer_tpu_torch/csrc/rays.cu"
CAMERA_SOURCE = "raytracer_tpu_torch/csrc/camera.cu"

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# device-memory bandwidth and non-tensor FP32 rate. Integer operations are
# counted at the FP32 rate; the card's INT32 rate is half of it, so the
# bound stays a lower bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# FP32 operations per step of the plain versions (csrc/sweep.cuh):
OPS_SPHERE = 20      # two 3-term dots, the half-b quadratic, sqrt, 2 compares
OPS_TRIANGLE = 45    # three Woop rows (6 + 5 each), divide, u, v, 5 compares
OPS_CULL = 6         # the one-way cull row and its compare
OPS_SHADE = 150      # a megakernel segment's randoms, jitter, material, books
OPS_RESOLVE = 20     # K5 / K6: the winner's parameters decoded (plain_ops)
OPS_FETCH = 20       # K4: clamps, the row and lane of one texel, decode
# threefry's integer adds, xors and shifts are counted at the FP32 rate;
# Hopper issues int32 at half the FP32 lanes a clock, so the draws' bounds
# are also given at that rate (``bound_ms_int32_rate``)
OPS_LANE = 1500      # 18 threefry evaluations (~77 ops) + 3 erfinv
OPS_RAYS = OPS_LANE + 30  # rt_wave_rays: the draw, jitter, 2 normalisations
OPS_TILE_VALUE = 190  # one tile draw value: 2 threefry evaluations + erfinv
OPS_COHERENT_LANE = 30  # rt_wave_rays' coherent arm a lane: jitter, 2 norms
OPS_CAMERA = 40      # rt_camera_rays: the screen point, two normalisations
OPS_FRAME = 120      # rt_temporal_frame's warp arm: the ray, the gather, blend
OPS_BLEND = 5        # its static arm: the blend of a pixel
FLY_W, FLY_H, FLY_MOVES = 3840, 2160, 16
HIST_SCALE = float(np.float32(8.0 / (511.0 * 511.0)))  # ops/warp.py _SCALE
W_KEPT_MIN = 0.5     # (w > 1) share among hit pixels after the last move
# phase 17: tests/test_golden.py's settings and tests/test_torch_golden.py's
# PSNR bounds (dB); scene 0's golden needs a mesh that is not in the
# repository, so its PSNR is printed and not judged
GOLDEN_SIZE, GOLDEN_SPP = (48, 32), 24
GOLDEN_PSNR_MIN = {1: 55.0, 2: 55.0, 3: 35.0, 4: 35.0}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled entry function: the group instances
    as megakernel<G2>, nearest_hit_kernel<G1>, hit_resolve_blocked_kernel<G8>
    (<G8, masked>: the regen loop's skip arm) or hit_resolve_kernel<G4,
    with_stats> (or <G4, masked>)."""
    m = re.search(r"(megakernel|nearest_hit_kernel)ILi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<G{m.group(2)}>"
    m = re.search(r"hit_resolve_blocked_kernelILi(\d+)ELb([01])E", mangled)
    if m:
        masked = ", masked" if m.group(2) == "1" else ""
        return f"hit_resolve_blocked_kernel<G{m.group(1)}{masked}>"
    m = re.search(r"hit_resolve_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
    if m:
        arm = ", with_stats" if m.group(2) == "1" else ""
        arm += ", masked" if m.group(3) == "1" else ""
        return f"hit_resolve_kernel<G{m.group(1)}{arm}>"
    m = re.search(r"wave_bounce_kernelILb([01])ELb([01])ELb([01])E",
                  mangled)
    if m:
        arms = [("scan", "regen"), ("K5", "K6"), ("", ", sphere uv")]
        return "wave_bounce_kernel<" + ", ".join(
            a[int(b)] for a, b in zip(arms[:2], m.groups()[:2])) + \
            arms[2][int(m.group(3))] + ">"
    m = re.search(r"temporal_frame_kernelILb([01])E", mangled)
    if m:
        return f"temporal_frame_kernel<{('static', 'warp')[int(m.group(1))]}>"
    m = re.search(r"wave_rays_kernelILb([01])E", mangled)
    if m:
        return f"wave_rays_kernel<{('lane', 'coherent')[int(m.group(1))]}>"
    return next((k for k in (
        "fetch_image_kernel", "warp_gather_kernel", "wave_rays_kernel",
        "camera_rays_kernel") if k in mangled), mangled)


def ptxas_summary(log: str) -> list:
    """'kernel: registers, spills' per entry function of nvcc's -v log."""
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in ln or "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


# rt_megakernel's and rt_nearest_hit's arms: the rule's G (None) and each
# forced G.
GROUP_ARMS = (None, 1, 2, 4, 8)


@contextlib.contextmanager
def forced_group(group):
    """Make every rt_megakernel launch in the block take ``group`` (None:
    the rule's), through the paths a user calls."""
    from raytracer_tpu_torch.ops import megakernel as mk
    real = mk._mega_cuda
    if group is not None:
        mk._mega_cuda = functools.partial(real, _group=group)
    try:
        yield
    finally:
        mk._mega_cuda = real


# rt_occupancy's kernels by name
ARM_KINDS = (("rt_megakernel", 0), ("rt_nearest_hit", 1),
             ("rt_hit_resolve", 2), ("rt_hit_resolve_blocked", 3))


def group_table(dev) -> dict:
    """Resident warps per SM of every K1, K2, K5 and K6 arm, and the G the
    rules pick on the main paths."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import sweep
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps = {name: {str(g): build.resident_threads(kind, g) // 32 // sms
                    for g in sweep.GROUPS}
             for name, kind in ARM_KINDS}
    packed = {"scene4": sweep.pack(rtt.build_scene(4, seed=0)[0]),
              "scene2": sweep.pack(rtt.build_scene(2)[0]),
              "stress10k": sweep.pack(stress_scene(10000)[0])}
    rule = {f"{k}_1000x800_pixpack8": mk.mega_group(
        lane_slots(1000, 800, 8), ps) for k, ps in packed.items()}
    rule["scene4_3840x2160_pixpack8"] = mk.mega_group(
        lane_slots(FLY_W, FLY_H, 8), packed["scene4"])
    rule["rt_nearest_hit_1M_rays_scene4"] = sweep.nearest_group(
        1 << 20, packed["scene4"])
    packed["stress100k"] = sweep.pack(stress_scene(100000)[0])
    for k in ("scene4", "scene2", "stress100k"):
        for n in (1 << 16, 1 << 20):
            rule[f"rt_hit_resolve_{n}_rays_{k}"] = ic.resolve_group(
                n, packed[k])
    for n in (1 << 16, 800_000, 1 << 20):
        rule[f"rt_hit_resolve_blocked_{n}_rays"] = ic.blocked_group(n)
    return {"resident_warps_per_sm": warps, "sms": sms,
            "gate_depth": {k: sweep.gate_depth(ps)
                           for k, ps in packed.items()},
            "rule_group": rule}


def lane_slots(width: int, height: int, pixpack: int) -> int:
    """rt_megakernel's lane slots for a frame: whole tiles of 4096."""
    from raytracer_tpu_torch.ops import megakernel as mk
    tiles = -(-width * height // (mk.MEGA_TILE * pixpack))
    return tiles * mk.MEGA_TILE


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def pixel_diff(a, b) -> dict:
    """Per-pixel agreement of two (3, N) or (N, 3) radiance tensors."""
    err = (a - b).abs().reshape(-1, 3) if a.shape[-1] == 3 else \
        (a - b).abs().T
    per_px = err.amax(dim=1)
    return {"share_within": float((per_px <= PIXEL_ABS).float().mean()),
            "mean_abs": float(err.mean()), "max_abs": float(err.max())}


def check_pixels(stats: dict, what: str) -> None:
    check(stats["share_within"] >= PIXEL_SHARE_MIN,
          f"{what}: {stats['share_within']:.6f} of pixels within "
          f"{PIXEL_ABS} (need >= {PIXEL_SHARE_MIN})")
    check(stats["mean_abs"] <= PIXEL_MEAN_ABS_MAX,
          f"{what}: mean |d| {stats['mean_abs']:.3g} > {PIXEL_MEAN_ABS_MAX}")


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the FP32 rate, whichever is larger."""
    b_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    o_ms = n_ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def gated_bound(n_bytes: float, n_ops: float, plain_ops: float) -> dict:
    """``bound`` of a kernel whose cluster gates skip primitive tests:
    ``n_ops`` counts only the work done whatever the gates, and the plain
    version's brute-force count is kept apart as ``plain_ops``."""
    rec = bound(n_bytes, n_ops)
    rec["plain_ops"] = plain_ops
    return rec


def tensor_bytes(*objs) -> int:
    """Bytes of the given tensors and of the tensor attributes of the
    given objects (one level: a PackedScene, blocked tables)."""
    import torch
    total = 0
    for x in objs:
        ts = [x] if isinstance(x, torch.Tensor) else [
            v for v in vars(x).values() if isinstance(v, torch.Tensor)]
        total += sum(t.numel() * t.element_size() for t in ts)
    return total


def sweep_ops(scene) -> int:
    """FP32 operations of one brute-force nearest hit over the scene, as
    the plain versions sweep (the kernels' gates skip most of them)."""
    tri = OPS_TRIANGLE + (OPS_CULL if scene.has_one_way else 0)
    return scene.num_spheres * OPS_SPHERE + scene.num_triangles * tri


def primitive_ops(scene, tests: float) -> float:
    """FP32 operations of ``tests`` primitive tests a ray (K5's count):
    a pool without clusters is counted whole at its own cost; the rest at
    the clustered pool's cost, or at the cheaper of the two when both
    pools are clustered (a lower bound)."""
    tri = OPS_TRIANGLE + (OPS_CULL if scene.has_one_way else 0)
    s_cl = scene.sph_clusters.shape[0] > 0
    t_cl = scene.tri_clusters.shape[0] > 0
    flat_s = 0 if s_cl else scene.sph_center.shape[0]
    flat_t = 0 if t_cl else scene.tri_v0.shape[0]
    rest = max(tests - flat_s - flat_t, 0.0)
    per = (min(OPS_SPHERE, tri) if s_cl and t_cl else
           OPS_SPHERE if s_cl else tri if t_cl else 0)
    return flat_s * OPS_SPHERE + flat_t * tri + rest * per


def hit_rays(dev, n_rays: int):
    """Phase 3's numpy-seeded rays in scene 4's box, unit directions."""
    import torch
    g = np.random.default_rng(1)
    o = np.stack([g.uniform(-6, 6, n_rays), g.uniform(-1.5, 3.0, n_rays),
                  g.uniform(-2, 11, n_rays)]).astype(np.float32)
    d = g.standard_normal((3, n_rays)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


def phase_hits(dev, n_rays: int) -> dict:
    """rt_nearest_hit against the plain nearest hit on numpy-seeded rays,
    at the rule's G and at every forced G (each bitwise), timed at each."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import sweep
    scene, _ = rtt.build_scene(4, seed=0, device=dev)
    ps = sweep.pack(scene)
    o, d = hit_rays(dev, n_rays)
    want = sweep.nearest_hit_reference(ps, o, d)
    by_group = {}
    for g in GROUP_ARMS:
        out = sweep.nearest_hit(ps, o, d, _group=g)
        by_group[str(g)] = {"bitwise": all(bool(torch.equal(a, b))
                                           for a, b in zip(out, want))}
    for g in GROUP_ARMS:           # timed once every arm has run
        by_group[str(g)]["ms"] = cuda_ms(
            lambda: sweep.nearest_hit(ps, o, d, _group=g), 5)
    got = sweep.nearest_hit(ps, o, d)
    same = got[1] == want[1]
    mismatch = float((~same).float().mean())
    t_g, t_w = got[0][same], want[0][same]
    t_rel = float(((t_g - t_w).abs() / t_w.abs().clamp(min=1.0)).max())
    fields_equal = all(bool(torch.equal(got[i][same], want[i][same]))
                       for i in range(4, 9))
    plain_ms = cuda_ms(lambda: sweep.nearest_hit_reference(ps, o, d))
    rec = {"rays": n_rays, "code_mismatch": mismatch, "t_rel_max": t_rel,
           "winner_params_equal": fields_equal,
           "hit_share": float((want[0] < sweep.INF).float().mean()),
           "group": sweep.nearest_group(n_rays, ps),
           "ms": by_group["None"]["ms"], "by_group": by_group,
           "plain_ms": plain_ms}
    rec.update(gated_bound(n_rays * (24 + 36) + tensor_bytes(ps), 0,
                           n_rays * sweep_ops(scene)))
    print("phase 3 rt_nearest_hit vs plain:", json.dumps(rec), flush=True)
    check(mismatch <= HIT_CODE_MISMATCH_MAX,
          f"winner code mismatch {mismatch} > {HIT_CODE_MISMATCH_MAX}")
    check(t_rel <= HIT_T_REL_MAX, f"hit t rel err {t_rel} > {HIT_T_REL_MAX}")
    check(fields_equal, "winner parameters differ where the winner agrees")
    for g, r in by_group.items():
        check(r["bitwise"], f"rt_nearest_hit at group {g} differs from "
              "the plain nearest hit")
    return rec


def phase_fetch(dev, n: int) -> dict:
    """rt_fetch_image (K4 alone) against the plain fetch, bitwise, on
    numpy-seeded queries over a plane holding the library's earth (256x512,
    1024 packed rows) and a 1024x2048 procedural earth (16,384 rows).
    Timed as a bare launch on prebuilt arguments (``ms``, and the
    profiler's ``profiled_ms``) and through the wrapper (``wrapper_ms``,
    its checks, allocation and argument packing in front of each
    launch)."""
    import ctypes

    import torch

    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.models.materials import Material, Texture
    from raytracer_tpu_torch.models.scene import SceneBuilder
    from raytracer_tpu_torch.models.scenes import procedural_earth_texture
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.utils.image import (TextureLibrary,
                                                 find_texture_library)
    earth = TextureLibrary(find_texture_library()).get("earth.png")
    b = SceneBuilder()
    for k, img in enumerate((earth, procedural_earth_texture(1024))):
        b.add_sphere((k, 0, 3), 0.5, Material.standard(
            Texture.from_image(img), 0))
    b.add_sphere((0, 2, 3), 0.5, Material.default())
    scene = b.build(device=dev)
    ms = mk.MegaScene(scene)
    g = np.random.default_rng(2)
    u = g.uniform(-0.02, 1.02, n).astype(np.float32)
    v = g.uniform(-0.02, 1.02, n).astype(np.float32)
    mid = g.integers(0, ms.mat.shape[1], n).astype(np.int32)
    u, v, mid = (torch.as_tensor(x, device=dev) for x in (u, v, mid))

    def plain():
        m = ms.mat[:, mid.long()]
        return torch.stack(mk.fetch_image_reference(
            ms.tex, ms.img_rows, u, v, m[mk._M_TW], m[mk._M_TH],
            m[mk._M_TROW]))

    got = mk.fetch_image(ms, u, v, mid)
    want = plain()
    out = torch.empty_like(got)
    args = build.FetchArgs(
        tex=ms.tex.data_ptr(), img_rows=ms.img_rows, mat=ms.mat.data_ptr(),
        n_mat=ms.mat.shape[1], u=u.data_ptr(), v=v.data_ptr(),
        mat_id=mid.data_ptr(),
        out=(ctypes.c_void_p * 3)(*[out[i].data_ptr() for i in range(3)]),
        n=n)
    rec = {"queries": n, "img_rows": ms.img_rows,
           "layout": [list(x[1:]) for x in scene.img_layout],
           "bitwise": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max()),
           **bare_times("rt_fetch_image", args, dev, "fetch_image_kernel"),
           "wrapper_ms": cuda_ms(lambda: mk.fetch_image(ms, u, v, mid), 20),
           "plain_ms": cuda_ms(plain, 5), "library_ms": None}
    rec["bare_launch_bitwise"] = bool(torch.equal(out, want))
    rec.update(bound(n * 24 + tensor_bytes(ms.tex, ms.mat), n * OPS_FETCH))
    # the rule for a redesign: a kernel at half its bound or better is
    # left alone
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    print("phase 4 rt_fetch_image vs plain:", json.dumps(rec), flush=True)
    check(rec["bitwise"], "rt_fetch_image differs from the plain fetch")
    check(rec["bare_launch_bitwise"],
          "rt_fetch_image's bare launch differs from the plain fetch")
    return rec


def camera_rays(width: int, height: int, dev, **cam):
    from raytracer_tpu_torch import CameraConfig
    from raytracer_tpu_torch.models.camera import (build_camera,
                                                   morton_order,
                                                   primary_rays)
    cfg = CameraConfig(width=width, height=height, **cam)
    o, d = primary_rays(build_camera(cfg), width, height,
                        pixel_order=morton_order(width, height), device=dev)
    return o.T.contiguous(), d.T.contiguous()


def mega_vs_plain(ms, settings, o, d, frame_key, pixpack=None) -> dict:
    """Kernel frames at every arm of GROUP_ARMS against one plain frame on
    the same inputs: per arm the pixel statistics, whether radiance,
    depth and segments are bitwise the plain version's, and the launches
    of the coherent arm."""
    import torch

    from raytracer_tpu_torch.ops import megakernel as mk
    o_p, d_p, seed, kw = mk.mega_inputs(ms, settings, o, d, frame_key,
                                        pixpack=pixpack)
    ref = mk.mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    n = o.shape[1]
    segs_ref = float(ref[3, :n].double().sum())
    out = {}
    for g in GROUP_ARMS:
        before = _counts()
        with forced_group(g):
            mean, segs, depth = mk.render_sample_mean_mega(
                ms, settings, o, d, frame_key, want_depth=True,
                pixpack=pixpack)
        stats = pixel_diff(mean, ref[:3, :n])
        stats["segs_rel"] = abs(float(segs) - segs_ref) / segs_ref
        hit_k, hit_r = depth < mk.INF, ref[4, :n] < mk.INF
        stats["depth_hit_mismatch"] = float((hit_k != hit_r).float().mean())
        stats["frame_mean_rel"] = abs(float(mean.mean()) - float(
            ref[:3, :n].mean())) / float(ref[:3, :n].mean())
        stats["bitwise"] = bool(torch.equal(mean, ref[:3, :n])
                                and torch.equal(depth, ref[4, :n])
                                and float(segs) == segs_ref)
        stats["coherent_launches"] = (_counts() - before)[
            "rt_megakernel.coherent"]
        out[str(g)] = stats
    return out


def phase_mega_small(dev, num: int, width: int, height: int,
                     coherent: bool = False) -> None:
    """rt_megakernel against mega_reference on scene ``num`` at a small
    size, pixpack 1 and 8, at every arm of GROUP_ARMS, bitwise; with
    ``coherent``, the coherent arms (phase 14a), each launch checked to
    take it."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    scene, sky = rtt.build_scene(num, device=dev)
    ms = mk.MegaScene(scene)
    settings = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                                  antialias=True,
                                  coherent=coherent).with_sky(sky)
    o, d = camera_rays(width, height, dev)
    phase = "14a coherent" if coherent else "5"
    for k in (1, 8):
        arms = mega_vs_plain(ms, settings, o, d, rng.fold_in(rng.key(0), 3),
                             pixpack=k)
        print(f"phase {phase} rt_megakernel vs mega_reference scene {num} "
              f"{width}x{height} spp 4 pixpack {k}, by group (None: the "
              "rule's):", json.dumps(arms), flush=True)
        for g, stats in arms.items():
            what = f"scene {num} pixpack {k} group {g}"
            check(stats["coherent_launches"] == int(coherent),
                  f"{what}: {stats['coherent_launches']} launches of the "
                  "coherent arm")
            check_pixels(stats, what)
            check(stats["segs_rel"] <= SEGS_REL_MAX,
                  f"{what}: segments differ by {stats['segs_rel']:.3g}")
            check(stats["bitwise"], f"{what}: not bitwise mega_reference")


def renderer_vs_mega_reference(dev, r, first, tiles=None) -> dict:
    """A megakernel Renderer's first frame (``first``, (N, 3)) against
    mega_reference on the same rays and key. With ``tiles`` = (t0, t1),
    only the pixels of megakernel tiles t0 <= t < t1 (4096 * pixpack
    pixels each): the plain version runs on them alone, its tile offset
    moved to t0, so it draws what those tiles drew in the whole frame."""
    import torch

    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    o_p, d_p, seed, kw = mk.mega_inputs(r._mega, r.settings, r._o.T,
                                        r._d.T, rng.frame_key(r.base_key, 0))
    n = first.shape[0]
    a, b = 0, o_p.shape[1]
    if tiles is not None:
        per = mk.MEGA_TILE * kw["pixpack"]
        a, b = tiles[0] * per, tiles[1] * per
        check(b <= n, f"tiles {tiles} past the frame's {n} pixels")
        o_p, d_p = o_p[:, a:b].contiguous(), d_p[:, a:b].contiguous()
        seed = (seed[0], seed[1], seed[2] + tiles[0])
    t0 = time.perf_counter()
    ref = mk.mega_reference(r._mega.packed, r._mega.mat, o_p, d_p, seed,
                            **kw)
    _sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    m = min(b, n) - a
    got, want = first[a:a + m], ref[:3, :m]
    stats = pixel_diff(got, want.T)
    stats["bitwise"] = bool(torch.equal(got, want.T))
    stats["frame_mean_rel"] = abs(float(got.mean()) - float(
        want.mean())) / float(want.mean())
    stats.update(pixels=m, first_pixel=a, plain_ms=plain_ms)
    return stats


def sweep_group(r) -> int:
    """The G that the rule picks for a megakernel Renderer's frame."""
    from raytracer_tpu_torch.ops import megakernel as mk
    slots = lane_slots(r._n_local, 1, r.settings.pixpack)
    return mk.mega_group(slots, r._mega.packed)


def check_frame(stats: dict, what: str) -> None:
    check_pixels(stats, what)
    check(stats["frame_mean_rel"] <= FRAME_MEAN_REL_MAX,
          f"{what}: frame-mean radiance differs by "
          f"{stats['frame_mean_rel']:.3g}")


def phase_path(dev, num: int, width: int, height: int, spp: int) -> dict:
    """One path: Renderer on scene ``num``, one warm-up frame + 5 frames,
    with the launch counts taken just before and read just after; its
    first frame bitwise against mega_reference; one full-size kernel
    frame timed at the rule's G."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    scene, sky = rtt.build_scene(num, seed=0) if num == 4 else \
        rtt.build_scene(num)
    settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                  antialias=True).with_sky(sky)
    cam = rtt.CameraConfig(width=width, height=height)

    r = rtt.Renderer(scene, cam, settings, seed=0, device=dev)
    before = _counts()
    r.render_frame(block=True)
    first = r.accum.clone()
    rec = r.render_frames(5)
    c = _counts() - before
    launches, image_launches = c["rt_megakernel"], c["rt_megakernel.image"]
    r.check_health()
    out = {"scene": num, "img_rows": r._mega.img_rows,
           "pixpack": r.settings.pixpack, "launches": launches,
           "image_launches": image_launches,
           "mrays_per_sec": rec["mrays_per_sec"],
           "frame_ms": rec["frame_ms"] / rec["frames"],
           "segments_per_frame": rec["segments"] / rec["frames"]}
    check(launches == 6, f"scene {num} path launched rt_megakernel "
          f"{launches} times, expected 6 (1 warm-up + 5 frames)")
    want_image = 6 if scene.has_image_tex else 0
    check(image_launches == want_image,
          f"scene {num} path ran the image fetch in {image_launches} "
          f"launches, expected {want_image}")

    # the first frame against the plain version on the same rays and key
    stats = renderer_vs_mega_reference(dev, r, first)
    plain_ms = stats.pop("plain_ms")
    out.update(vs_plain=stats, plain_ms=plain_ms)
    fkey = rng.frame_key(r.base_key, 0)
    o_p = mk.mega_inputs(r._mega, r.settings, r._o.T, r._d.T, fkey)[0]

    # one full-size frame through the kernel, timed with CUDA events
    timed = {}

    def one_kernel_frame():
        timed["segs"] = mk.render_sample_mean_mega(
            r._mega, r.settings, r._o.T, r._d.T, fkey)[1]

    one_kernel_frame()
    out.update(ms=cuda_ms(one_kernel_frame, 3), group=sweep_group(r))
    out["timed_segments"] = float(timed["segs"])
    out.update(gated_bound(
        o_p.shape[1] * (24 + 20) + tensor_bytes(r._mega.packed, r._mega.mat,
                                                r._mega.tex),
        float(timed["segs"]) * OPS_SHADE,
        float(timed["segs"]) * (sweep_ops(scene) + OPS_SHADE)))

    # checkpoint round trip: the next frame is bitwise the same
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt.npz"
        r.save_checkpoint(path)
        r2 = rtt.Renderer(scene, cam, settings, seed=123, device=dev)
        r2.load_checkpoint(path)
    r.render_frame(block=True)
    r2.render_frame(block=True)
    out["checkpoint_bitwise"] = bool(torch.equal(r.accum, r2.accum))
    print(f"phase 6 scene {num} path {width}x{height} spp {spp}:",
          json.dumps(out), flush=True)
    print(f"phase 6 scene {num}, one {width}x{height} frame: kernel "
          f"{out['ms']:.3f} ms at G {out['group']}, mega_reference "
          f"{plain_ms:.3f} ms",
          flush=True)
    check_frame(stats, f"scene {num} path frame vs mega_reference")
    check(stats["bitwise"], f"scene {num} path frame not bitwise "
          "mega_reference")
    check(out["checkpoint_bitwise"], "checkpoint round trip not bitwise")
    check(np.isfinite(out["mrays_per_sec"]) and out["mrays_per_sec"] > 0,
          "no ray rate")
    return out


# benchmarks/suite.py's scenes at their sizes: (name, builder, width,
# height, spp, camera position); 5 bounces each.
BENCH = (
    ("rtiow_trio_640x360_100spp", "rtiow_trio_scene", {}, 640, 360, 100,
     (0.0, 0.0, 0.0)),
    ("cube_1280x720_200spp", "cube_scene", {}, 1280, 720, 200,
     (0.0, 0.0, 0.0)),
    ("monkey_1920x1080_100spp", "monkey_light_scene", {}, 1920, 1080, 100,
     (0.0, 0.0, 0.0)),
    ("stress10k_1000x800_20spp", "stress_10k_scene", {}, 1000, 800, 20,
     (0.0, 1.0, -4.0)),
    ("stress100k_1000x800_4spp", "stress_10k_scene",
     {"num": 100000, "seed": 1}, 1000, 800, 4, (0.0, 1.0, -4.0)),
    ("earth2048_1000x800_20spp", None, {}, 1000, 800, 20, (0.0, 0.0, 0.0)),
)


def bench_frame(dev, entry):
    """One entry of BENCH, ready to render: (the scene, a function that
    renders its frame through render_sample_mean_mega and returns (mean,
    segments), the lane slots, the pixpack (8 at spp <= 32, else 1), the
    scene's build seconds)."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models import bench_scenes
    from raytracer_tpu_torch.models.scenes import procedural_earth_texture
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    _, fn, kw, width, height, spp, pos = entry
    t0 = time.perf_counter()
    if fn is None:
        scene, sky = rtt.build_scene(
            2, earth_image=procedural_earth_texture(1024))
    else:
        scene, sky = getattr(bench_scenes, fn)(**kw)
    ms = mk.MegaScene(scene.to(dev))
    build_s = time.perf_counter() - t0
    settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                  antialias=True).with_sky(sky)
    o, d = camera_rays(width, height, dev, position=pos)
    k = 8 if spp <= 32 else 1

    def frame():
        return mk.render_sample_mean_mega(
            ms, settings, o, d, rng.frame_key(rng.key(0), 0), pixpack=k)
    return scene, ms, frame, lane_slots(width, height, k), k, build_s


def phase_bench(dev) -> list:
    """One frame of each bench scene through the kernel, at the Renderer's
    auto pixpack (8 at spp <= 32, else 1), timed at the rule's G."""
    import torch

    from raytracer_tpu_torch.ops import megakernel as mk
    recs = []
    for entry in BENCH:
        scene, ms, frame, slots, k, build_s = bench_frame(dev, entry)
        res = {"out": frame()}                 # warm-up
        kernel_ms = cuda_ms(lambda: res.update(out=frame()))
        mean, segs = res["out"]
        rec = {"scene": entry[0], "spheres": scene.num_spheres,
               "triangles": scene.num_triangles, "img_rows": ms.img_rows,
               "pixpack": k, "build_s": build_s, "frame_ms": kernel_ms,
               "group": mk.mega_group(slots, ms.packed),
               "segments": float(segs),
               "mrays_per_sec": float(segs) / kernel_ms / 1e3,
               "finite": bool(torch.isfinite(mean).all()),
               "mean_radiance": float(mean.mean())}
        print("phase 7 bench frame:", json.dumps(rec), flush=True)
        check(rec["finite"], f"{entry[0]}: non-finite radiance")
        check(rec["segments"] > 0, f"{entry[0]}: no segments traced")
        recs.append(rec)
    return recs


def _hit_agreement(got, want) -> dict:
    """Winner code mismatch, t error where the winners agree, and whether
    every other output is equal there (K5 / K6 against a reference)."""
    import torch
    same = got[1] == want[1]
    t_g, t_w = got[0][same], want[0][same]
    return {"code_mismatch": float((~same).float().mean()),
            "t_rel_max": float(((t_g - t_w).abs()
                                / t_w.abs().clamp(min=1.0)).max()),
            "t_abs_max": float((t_g - t_w).abs().max()),
            "params_equal": all(torch.equal(a[same], b[same])
                                for a, b in zip(got[2:], want[2:])),
            "hit_share": float((want[0] < 1e30).float().mean())}


def check_hits(rec: dict, what: str) -> None:
    check(rec["code_mismatch"] <= HIT_CODE_MISMATCH_MAX,
          f"{what}: winner code mismatch {rec['code_mismatch']} > "
          f"{HIT_CODE_MISMATCH_MAX}")
    check(rec["t_rel_max"] <= HIT_T_REL_MAX,
          f"{what}: hit t rel err {rec['t_rel_max']} > {HIT_T_REL_MAX}")
    check(rec["params_equal"],
          f"{what}: winner parameters differ where the winner agrees")


def field_rays(dev, n: int, seed: int, scene):
    """n rays with origins uniform in the box of the scene's sphere
    centres and triangle corners, directions uniform on the sphere."""
    import torch
    pts = np.concatenate([scene.sph_center.cpu().numpy(),
                          scene.tri_v0.cpu().numpy()])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    g = np.random.default_rng(seed)
    o = np.stack([g.uniform(lo[k], hi[k], n) for k in range(3)])
    d = g.standard_normal((3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=dev),
            torch.as_tensor(d.astype(np.float32), device=dev))


RAYS_FIELDS = ("dj", "unit", "inv_len", "gauss", "fresnel", "rr")


def rays_agreement(got, want, done=None) -> dict:
    """rt_wave_rays' outputs (a WaveRays) against the plain version's:
    every output of a live lane, the share of equal values and the
    largest difference; with ``done`` (the finished lanes, sample_i >=
    spp), whose dj and draws are unspecified, ``parked``: their unit
    direction and 1 / |d| are ``rays.PARK_UNIT`` and 1."""
    import torch

    from raytracer_tpu_torch.ops.rays import PARK_UNIT
    live = slice(None) if done is None else ~done
    pairs = [(getattr(got, k)[..., live], getattr(want, k)[..., live])
             for k in RAYS_FIELDS if getattr(want, k) is not None]
    parked = True
    if done is not None:
        park = torch.tensor(PARK_UNIT, device=done.device)[:, None]
        parked = bool((got.unit[:, done] == park).all()
                      and (got.inv_len[done] == 1.0).all())
    pairs = [(a, w) for a, w in pairs if w.numel()]  # no live lane
    return {"bitwise": parked and all(bool(torch.equal(a, w))
                                      for a, w in pairs),
            "parked": parked,
            "equal_share": {k: float((a == w).float().mean())
                            for k, (a, w) in zip(RAYS_FIELDS, pairs)},
            "max_abs_err": max([0.0] + [float((a - w).abs().max())
                                        for a, w in pairs])}


def coherent_graph_replay(d, s, dev) -> dict:
    """rt_wave_rays' coherent arm keyed by fold_in(key_dev, iter_dev[0])
    in device memory, captured in a CUDA graph and replayed twice: each
    replay against the plain version under the host's fold_in(key, it),
    and the counter advanced by exactly one (the ticket left zero)."""
    import torch

    from raytracer_tpu_torch.ops import rays
    from raytracer_tpu_torch.ops import rng
    key_dev = torch.zeros(2, dtype=torch.int64, device=dev)
    rng.set_key(key_dev, rng.key(0))
    iter_dev = torch.tensor([3, 0], dtype=torch.int64, device=dev)
    segs = [torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(2)]
    kw = dict(sample_i=s, spp=20, with_rr=True)
    rays.wave_rays(d, key_dev=key_dev, iter_dev=iter_dev, segs=segs[0],
                   **kw)  # warm-up: iteration 3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = rays.wave_rays(d, key_dev=key_dev, iter_dev=iter_dev,
                             segs=segs[0], **kw)
    bitwise, counters, err = True, [], 0.0
    for it in (4, 5):
        for x in segs:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        counters.append(iter_dev.tolist())
        want = rays.wave_rays(d, tile_key=rng.fold_in(rng.key(0), it),
                              segs=segs[1], plain=True, **kw)
        agree = rays_agreement(got, want, s >= 20)
        bitwise = bitwise and agree["bitwise"]
        err = max(err, agree["max_abs_err"])
    del graph
    return {"bitwise": bitwise and counters == [[5, 0], [6, 0]],
            "counters": counters, "max_abs_err": err,
            "segments": int(segs[0]),
            "segments_equal": int(segs[0]) == int(segs[1])}


def phase_wave_rays(dev, sizes=(1 << 20, 1000 * 800)) -> dict:
    """rt_wave_rays (the wavefront iteration's ray set-up) against its
    plain version on each size's lanes: the regen arm (per-pixel keys of
    a frame, random samples and bounces, the sample fold, the count of
    sample_i < spp, a sixth of the lanes finished), the scan arm (one
    bounce, the alive mask counted) and the coherent arm (the 1024-lane
    tiles' bundles drawn in the kernel under a host tile key, and under
    the key and iteration counter in device memory, captured in a CUDA
    graph and replayed twice, each replay against the host-keyed plain
    version and the counter advanced by one), antialias and russian
    roulette on; every output of a live lane bitwise, a finished lane's
    park direction, and the counts equal. The regen arm timed bare on
    prebuilt arguments (``ms``, ``profiled_ms``), through the wrapper
    (``wrapper_ms``) and the plain version (``plain_ms``),
    beside its bound: each lane reads its key (16 bytes), sample, bounce
    (8) and direction (12) once and writes its jittered and unit
    direction, 1 / |d| and 5 draws (48); ~OPS_RAYS operations; a finished
    lane reads its sample and writes its unit direction and 1 / |d| (20).
    The coherent arm (1024-lane tiles) timed the same way (``coherent``)
    beside its bytes: a live lane reads its sample and direction (16) and
    writes the same 48; its draw is 3 threefry calls a value a block.
    Returns the records by size."""
    import torch

    from raytracer_tpu_torch.ops import rays
    from raytracer_tpu_torch.ops import rng
    recs = {}
    for n in sizes:
        g = np.random.default_rng(16)
        keys = rng.per_ray_keys(rng.frame_key(rng.key(0), 0),
                                torch.arange(n, device=dev))
        s = torch.as_tensor(g.integers(0, 24, n).astype(np.int32),
                            device=dev)
        b = torch.as_tensor(g.integers(0, 5, n).astype(np.int32), device=dev)
        d = torch.as_tensor(g.standard_normal((3, n)).astype(np.float32),
                            device=dev)
        tile_key = rng.fold_in(rng.key(0), 3)
        arms = {"regen": dict(keys=keys, sample_i=s, bounce=b, spp=20),
                "scan": dict(keys=keys, bounce=3, alive=s < 12),
                "coherent": dict(tile_key=tile_key, sample_i=s, spp=20)}
        # the finished lanes: their dj and draws are unspecified
        done = {"regen": s >= 20, "scan": None, "coherent": s >= 20}
        checks, wants = {}, {}
        for arm, kw in arms.items():
            segs = [torch.zeros((), dtype=torch.int64, device=dev)
                    for _ in range(2)]
            got = rays.wave_rays(d, with_rr=True, segs=segs[0], **kw)
            want = rays.wave_rays(d, with_rr=True, segs=segs[1], plain=True,
                                  **kw)
            checks[arm] = rays_agreement(got, want, done[arm])
            checks[arm].update(segments=int(segs[0]),
                               segments_equal=int(segs[0]) == int(segs[1]))
            wants[arm] = want
        checks["coherent_graph"] = coherent_graph_replay(d, s, dev)
        rec = {"lanes": n, "checks": checks,
               "bitwise": all(c["bitwise"] and c["segments_equal"]
                              for c in checks.values()),
               "max_abs_err": max(c["max_abs_err"] for c in checks.values())}
        def timed(arm):
            """The arm bare (its last launch held against the plain
            version), through its wrapper and its plain version."""
            seg = torch.zeros((), dtype=torch.int64, device=dev)
            out = rays.WaveRays(torch.empty_like(d), torch.empty_like(d),
                                torch.empty(n, device=dev), None, None)
            draws = torch.empty((5, n), device=dev)
            args = rays.rays_args(d, out, draws, with_rr=True, segs=seg,
                                  **arms[arm])
            t = bare_times("rt_wave_rays", args, dev, "wave_rays_kernel")
            t["bare_launch_bitwise"] = rays_agreement(
                rays.WaveRays(out.dj, out.unit, out.inv_len, draws[0:3],
                              draws[3], draws[4]),
                wants[arm], done[arm])["bitwise"]
            kw = dict(arms[arm], with_rr=True)
            t.update(wrapper_ms=cuda_ms(lambda: rays.wave_rays(d, **kw), 20),
                     plain_ms=cuda_ms(lambda: rays.wave_rays(
                         d, plain=True, **kw), 3), library_ms=None)
            return t

        rec.update(timed("regen"))
        # a finished lane reads its sample and writes its unit and inv_len
        live = int((s < 20).sum())
        rec.update(bound(live * (16 + 8 + 12 + 48) + (n - live) * 20,
                         live * OPS_RAYS))
        rec["bound_ms_int32_rate"] = \
            live * OPS_RAYS / (PEAK_OPS_PER_S / 2) * 1e3
        nt = -(-n // 1024)
        coh = timed("coherent")
        coh.update(bound(live * (4 + 12 + 48) + (n - live) * 20,
                         live * OPS_COHERENT_LANE + 8 * nt * OPS_TILE_VALUE))
        coh["bound_share"] = coh["bound_ms"] / coh["ms"]
        rec["coherent"] = coh
        print(f"phase 8 rt_wave_rays vs plain, {n} lanes (regen, scan and "
              "coherent arms):", json.dumps(rec), flush=True)
        check(rec["bitwise"], f"rt_wave_rays differs from its plain version "
              f"on {n} lanes: {json.dumps(checks)}")
        check(rec["bare_launch_bitwise"]
              and coh["bare_launch_bitwise"],
              "rt_wave_rays' bare launch differs")
        recs[n] = rec
    return recs


def by_group(run, want, plain_ms=None, repeats: int = 3) -> dict:
    """``run(g)`` (a kernel wrapper at G = g, None the rule's) at every arm
    of GROUP_ARMS: whether its outputs are bitwise ``want``, then, once
    every arm has run, its CUDA-event ms."""
    import torch
    out = {}
    for g in GROUP_ARMS:
        got = run(g)
        out[str(g)] = {"bitwise": all(bool(torch.equal(a, b))
                                      for a, b in zip(got, want))}
    for g in GROUP_ARMS:
        out[str(g)]["ms"] = cuda_ms(lambda: run(g), repeats)
    return out


def check_by_group(arms: dict, what: str) -> None:
    for g, r in arms.items():
        check(r["bitwise"], f"{what} at group {g} differs from its plain "
              "version")


def phase_k5(dev, sizes=(1 << 16, 1 << 20)) -> dict:
    """K5 (rt_hit_resolve) against the plain K5 on field rays over scenes 4
    and 2, at the rule's G and every forced G, each bitwise, timed at each;
    the record of scene 4's last size feeds the kernels line."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    recs = {}
    for num in (4, 2):
        scene, _ = rtt.build_scene(num, seed=0, device=dev) if num == 4 \
            else rtt.build_scene(num, device=dev)
        ws = ic.WaveScene(scene)
        check(not ws.blocked, f"scene {num} routed to K6")
        for n in sizes:
            o, d = field_rays(dev, n, 7 + num, scene)
            want = ic.hit_resolve_unit(ws, o, d, plain=True)
            rec = _hit_agreement(ic.hit_resolve_unit(ws, o, d), want)
            rec["by_group"] = by_group(
                lambda g: ic.hit_resolve_unit(ws, o, d, _group=g), want,
                repeats=5)
            rec.update(rays=n, group=ic.resolve_group(n, ws.packed),
                       ms=rec["by_group"]["None"]["ms"],
                       plain_ms=cuda_ms(lambda: ic.hit_resolve_unit(
                           ws, o, d, plain=True)))
            rec.update(gated_bound(n * (24 + 48) + tensor_bytes(ws.packed),
                                   0, n * (sweep_ops(scene) + OPS_RESOLVE)))
            print(f"phase 9 rt_hit_resolve (K5) vs plain, scene {num}, {n} "
                  "rays, by group (None: the rule's):", json.dumps(rec),
                  flush=True)
            check_hits(rec, f"K5 scene {num}")
            check_by_group(rec["by_group"], f"K5 scene {num}, {n} rays")
            recs[num] = rec
    return recs


@functools.lru_cache(maxsize=None)
def stress_scene(num: int):
    """bench_scenes.stress_10k_scene(num, seed 1), built once per run."""
    from raytracer_tpu_torch.models import bench_scenes
    return bench_scenes.stress_10k_scene(num=num, seed=1)


def phase_k6(dev, n_check: int, n_time: int) -> dict:
    """K6 (rt_hit_resolve_blocked) and K5 (rt_hit_resolve over the
    resident pools) on stress100k field rays, n_check of them and the
    n_time that K6 is timed on (about the ~800k rays a K6 launch gets on
    the stress100k path): each at the rule's G and every forced G, bitwise
    with its plain version and timed at each; K6 against K5, which may
    differ only on exact ties (their tie orders differ)."""
    import torch

    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene, _ = stress_scene(100000)
    scene = scene.to(dev)
    wb = ic.WaveScene(scene)
    check(wb.blocked, "stress100k not routed to K6 by fits_smem")
    wr = ic.WaveScene(scene, blocked=False)
    out = {"blocks": wb.tables.nblocks}
    for n, seed in ((n_check, 11), (n_time, 12)):
        o, d = field_rays(dev, n, seed, scene)
        plain6 = ic.hit_resolve_unit(wb, o, d, plain=True)
        plain5 = ic.hit_resolve_unit(wr, o, d, plain=True)
        k6 = ic.hit_resolve_unit(wb, o, d)
        rec = _hit_agreement(k6, plain6)
        rec["by_group"] = by_group(
            lambda g: ic.hit_resolve_unit(wb, o, d, _group=g), plain6)
        k5 = ic.hit_resolve_unit(wr, o, d)
        rec["k5_by_group"] = by_group(
            lambda g: ic.hit_resolve_unit(wr, o, d, _group=g), plain5)
        differ = k6[1] != k5[1]
        rec.update(rays=n, group=ic.blocked_group(n),
                   k5_group=ic.resolve_group(n, wr.packed),
                   ms=rec["by_group"]["None"]["ms"],
                   k5_ms=rec["k5_by_group"]["None"]["ms"],
                   vs_k5_code_mismatch=int(differ.sum()),
                   vs_k5_mismatch_ties_only=torch.equal(k6[0][differ],
                                                        k5[0][differ]))
        if n == n_time:
            rec["plain_ms"] = cuda_ms(lambda: ic.hit_resolve_unit(
                wb, o, d, plain=True))
            rec.update(gated_bound(
                n * (24 + 36) + tensor_bytes(wb.tables), 0,
                n * (sweep_ops(scene) + OPS_RESOLVE)))
        print(f"phase 10 rt_hit_resolve_blocked (K6) and rt_hit_resolve "
              f"(K5) vs plain, stress100k, {n} rays, by group (None: the "
              "rule's):", json.dumps(rec), flush=True)
        check_hits(rec, f"K6 vs plain K6 on {n} rays")
        check_by_group(rec["by_group"], f"K6 on {n} rays")
        check_by_group(rec["k5_by_group"], f"K5 on {n} stress100k rays")
        check(rec["vs_k5_mismatch_ties_only"],
              f"K6 and K5 pick other winners at other distances on {n} rays")
        out[n] = rec
    rec = dict(out[n_time])
    rec.update(blocks=out["blocks"], check_rays=out[n_check])
    return rec


def phase_samplers(dev, width: int, height: int) -> dict:
    """One frame of each wavefront sampler through Renderer on the card
    (scene 4, 4 spp), counts taken just before and read just after;
    each frame against the plain route on the same rays and key, rebin
    and lanesort bitwise equal to regen, and a checkpoint round trip."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import rng
    scene, sky = rtt.build_scene(4, seed=0)
    cam = rtt.CameraConfig(width=width, height=height,
                           position=(0.0, 0.5, -6.0))
    frames, recs = {}, {}
    for s in ("regen", "scan", "rebin", "lanesort"):
        settings = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                                      antialias=True,
                                      sampler=s).with_sky(sky)
        r = rtt.Renderer(scene, cam, settings, seed=0, device=dev)
        before = _counts()
        r.render_frame(block=True)
        launches = _launches(before)
        r.check_health()
        frames[s] = r.accum.clone()
        ref, ref_segs = integ.render_sample_mean(
            r.packed_scene, settings, r._o, r._d,
            rng.frame_key(r.base_key, 0), ray_idx=r._ray_idx,
            backend="plain")
        stats = pixel_diff(frames[s], ref)
        segs = r.total_segments
        stats["segs_rel"] = abs(segs - float(ref_segs)) / float(ref_segs)
        with tempfile.TemporaryDirectory() as tmp:
            r.save_checkpoint(f"{tmp}/ckpt.npz")
            r2 = rtt.Renderer(scene, cam, settings, seed=123, device=dev)
            r2.load_checkpoint(f"{tmp}/ckpt.npz")
        r.render_frame(block=True)
        r2.render_frame(block=True)
        recs[s] = {"launches": launches, "segments": segs,
                   "vs_plain": stats,
                   "checkpoint_bitwise": bool(torch.equal(r.accum, r2.accum))}
        check(launches["rt_hit_resolve"] > 0
              and launches["rt_wave_rays"] == launches["rt_hit_resolve"]
              and launches["rt_wave_bounce"] == launches["rt_hit_resolve"]
              and set(launches) == set(WAVE_ENTRIES),
              f"sampler {s}: the Renderer frame launched {launches}")
        check_pixels(stats, f"sampler {s} frame vs the plain route")
        check(stats["segs_rel"] <= SEGS_REL_MAX,
              f"sampler {s}: segments differ by {stats['segs_rel']:.3g}")
        check(recs[s]["checkpoint_bitwise"],
              f"sampler {s}: checkpoint round trip not bitwise")
    for s in ("rebin", "lanesort"):
        recs[s]["bitwise_regen"] = bool(
            torch.equal(frames[s], frames["regen"])
            and recs[s]["segments"] == recs["regen"]["segments"])
    print(f"phase 11 Renderer frame per sampler, scene 4 {width}x{height} "
          "spp 4, vs the plain route; rebin / lanesort bitwise == regen:",
          json.dumps(recs), flush=True)
    check(all(recs[s]["bitwise_regen"] for s in ("rebin", "lanesort")),
          "rebin or lanesort differs from regen")
    return recs


# the entry points of a wavefront iteration and of a temporal frame
WAVE_ENTRIES = ("rt_hit_resolve", "rt_hit_resolve_blocked", "rt_wave_rays",
                "rt_wave_bounce")
TEMPORAL_ENTRIES = ("rt_megakernel", "rt_camera_rays", "rt_temporal_frame",
                    "rt_warp_gather")


def _counts():
    """The program counts so far (utils/trace.py): the launches by entry
    point (``rt_X``) and arm (``rt_X.arm``), the graph replays and
    captures and the regen loop's lane-iterations."""
    from raytracer_tpu_torch.utils import trace
    return trace.counts()


def _launches(before, entries=WAVE_ENTRIES) -> dict:
    """The launches since ``before`` (a ``_counts()``) by entry point: each
    of ``entries``, 0 where it did not launch, and every other entry point
    that launched, so that a check of a path's launches also finds any
    other kernel."""
    out = dict.fromkeys(entries, 0)
    out.update((k, v) for k, v in (_counts() - before).items()
               if k.startswith("rt_") and "." not in k)
    return out


def device_shares(fn, names, absent=(), all_ops=False) -> dict:
    """One call of ``fn()`` under torch.profiler, ending in a synchronise:
    the window's host ms, the device time (the self device time of the
    device's own events, summed: the host ops that launched kernels carry
    their kernels' time too, ``host_ops_device_ms``, and counted with them
    it was counted twice), the device's busy share of the window, and for
    each kernel
    named in ``names`` its device ms and its share of the device time and
    of the window. Shares are null where the profiler saw no device
    time. ``absent_seen``: the device kernels whose names hold one of
    ``absent``, with their counts; with ``all_ops``, ``device_kernels``:
    every device op, [name, ms, count]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def calls(name):
        return sum(e.count for e in events if e.key == name)
    kernels = sorted(((dev_us(e) / 1e3, e.key, e.count) for e in events
                      if dev_us(e) and str(e.device_type).endswith("CUDA")),
                     reverse=True)
    total = sum(ms for ms, _, _ in kernels)
    rec = {"window_ms": window_ms, "device_ms": total,
           "host_ops_device_ms": sum(dev_us(e) for e in events) / 1e3
           - total,
           "busy_share": total / window_ms if total else None,
           # what the host issued: kernel launches and graph launches
           "host_kernel_launches": calls("cudaLaunchKernel"),
           "host_graph_launches": calls("cudaGraphLaunch"),
           "device_ops": sum(c for _, _, c in kernels),
           "top_device_ms": [[name[:60], ms, c]
                             for ms, name, c in kernels[:8]],
           "absent_seen": [[name[:80], c] for _, name, c in kernels
                           if any(a in name for a in absent)]}
    if all_ops:
        rec["device_kernels"] = [[name[:160], ms, c]
                                 for ms, name, c in kernels]
    for name in names:
        ms = sum(t for t, key, _ in kernels if name in key)
        rec[name] = {"device_ms": ms,
                     "count": sum(c for _, key, c in kernels if name in key),
                     "share_of_device": ms / total if total else None,
                     "share_of_window": ms / window_ms if total else None}
    return rec


# device kernels the wavefront iteration no longer runs: the padding's
# torch.cat and the torch resolve's rsqrt, asin and acos (each now inside
# rt_wave_rays or rt_wave_bounce)
RESOLVE_OPS = ("CatArrayBatchedCopy", "rsqrt", "asin", "acos")


def phase_wave_path(dev, name: str, scene, sky, spp: int, pos,
                    width=1000, height=800, check_size=(256, 128),
                    coherent: bool = False) -> dict:
    """One regen path through Renderer (``coherent``: coherent sampling):
    a warm-up frame (it captures the graphs) and 5 frames, counts taken
    just before and read just after, with the graph replays the host
    issued: an iteration launches rt_wave_rays, K5 / K6 and rt_wave_bounce
    once each and no other entry point (the coherent ray set-up draws the
    tile bundles itself). One more frame under torch.profiler:
    the device ms of K5 /
    K6, the ray set-up and rt_wave_bounce and their shares, the device's
    busy share, the kernel and graph launches the host issued against the
    device ops that ran (and their count an iteration), the top kernels,
    and no torch.cat padding or torch resolve (RESOLVE_OPS) run once an
    iteration (the per-frame keys stack once a frame). Then its
    first frame at check_size through the kernel route against the plain
    route."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import rng
    settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                  antialias=True, sampler="regen",
                                  coherent=coherent).with_sky(sky)
    cam = rtt.CameraConfig(width=width, height=height, position=pos)
    r = rtt.Renderer(scene, cam, settings, seed=0, device=dev)
    before = _counts()
    r.render_frame(block=True)
    rec = r.render_frames(5)
    launches = _launches(before)
    replays = (_counts() - before)["graph.replay"]
    r.check_health()
    out = {"path": name, "spp": spp, "coherent": coherent,
           "blocked": r.packed_scene.blocked, "launches": launches,
           "graph_replays_per_frame": replays / (rec["frames"] + 1),
           "kernel_launches_per_frame": {
               k: v / (rec["frames"] + 1) for k, v in launches.items()},
           "frame_ms": rec["frame_ms"] / rec["frames"],
           "mrays_per_sec": rec["mrays_per_sec"],
           "segments_per_frame": rec["segments"] / rec["frames"]}
    hit_kernel = "rt_hit_resolve_blocked" if out["blocked"] else \
        "rt_hit_resolve"
    # an iteration is three kernels: the ray set-up, the hit, the bounce
    check(launches[hit_kernel] > 0
          and launches["rt_wave_rays"] == launches[hit_kernel]
          and launches["rt_wave_bounce"] == launches[hit_kernel]
          and set(launches) == set(WAVE_ENTRIES),
          f"{name}: the path launched {launches}")
    iterations = launches[hit_kernel] / (rec["frames"] + 1)
    prof = device_shares(
        lambda: r.render_frame(block=True),
        ("hit_resolve_blocked_kernel", "hit_resolve_kernel",
         "wave_rays_kernel", "wave_bounce_kernel"),
        absent=RESOLVE_OPS, all_ops=coherent)
    prof.update(iterations=iterations,
                device_ops_per_iteration=prof["device_ops"] / iterations)
    out["profiled_frame"] = prof

    w, h = check_size
    o, d = camera_rays(w, h, dev, position=pos)
    order = camera_order(w, h, dev)
    fkey = rng.frame_key(rng.key(0), 0)
    mean, segs = integ.render_sample_mean(r.packed_scene, settings, o.T,
                                          d.T, fkey, ray_idx=order)
    t0 = time.perf_counter()
    ref, ref_segs = integ.render_sample_mean(r.packed_scene, settings, o.T,
                                             d.T, fkey, ray_idx=order,
                                             backend="plain")
    _sync(dev)
    stats = pixel_diff(mean, ref)
    stats["segs_rel"] = abs(float(segs) - float(ref_segs)) / float(ref_segs)
    stats["plain_frame_ms"] = (time.perf_counter() - t0) * 1e3
    out["vs_plain"] = stats
    print(f"phase 12 wavefront path {name} {width}x{height} spp {spp}:",
          json.dumps(out), flush=True)
    check_pixels(stats, f"{name} first frame vs the plain route")
    check(stats["segs_rel"] <= SEGS_REL_MAX,
          f"{name}: segments differ by {stats['segs_rel']:.3g}")
    check(np.isfinite(out["mrays_per_sec"]) and out["mrays_per_sec"] > 0,
          f"{name}: no ray rate")
    # once a frame is the per-frame work (rng.per_ray_keys' stack); once
    # an iteration would be the padding or a resolve
    check(all(c < iterations for _, c in prof["absent_seen"]),
          f"{name}: the padding or a torch resolve ran every iteration of "
          f"the profiled frame: {prof['absent_seen']}")
    return out


def camera_order(width: int, height: int, dev):
    import torch

    from raytracer_tpu_torch.models.camera import morton_order
    return torch.as_tensor(morton_order(width, height), device=dev)


def phase_wave_paths(dev) -> list:
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models.scenes import procedural_earth_texture
    paths = []
    scene, sky = rtt.build_scene(4, seed=0)
    paths.append(phase_wave_path(dev, "scene4_regen", scene, sky, 20,
                                 (0.0, 0.0, 0.0)))
    paths.append(phase_wave_path(dev, "scene4_coherent_regen", scene, sky,
                                 20, (0.0, 0.0, 0.0), coherent=True))
    scene, sky = stress_scene(100000)
    paths.append(phase_wave_path(dev, "stress100k_regen", scene, sky, 4,
                                 (0.0, 1.0, -4.0)))
    scene, sky = rtt.build_scene(2,
                                 earth_image=procedural_earth_texture(1024))
    paths.append(phase_wave_path(dev, "earth2048_regen", scene, sky, 20,
                                 (0.0, 0.0, 0.0)))
    return paths


# -- phase 19: rt_wave_bounce, the wavefront bounce after the hit -----------

# the settings the bounce is held under besides phase 12's (5 bounces,
# antialias): russian roulette from bounce 2 with the exit-IOR fix and
# emissive termination
BOUNCE_VARIANTS = {"base": {}, "rr_fix_emissive": {
    "russian_roulette": 2, "fix_exit_ior": True,
    "emissive_terminates": True}}


def bounce_scenes(dev) -> list:
    """(name, scene, sky, camera position): scenes 1-4 (phase 17's
    cameras, scene 4 at phase 12's), stress100k (K6, phase 12's camera)
    and earth2048 (scene 2 with the 1024x2048 procedural earth)."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models.scenes import procedural_earth_texture
    out = []
    for num in (1, 2, 3, 4):
        scene, sky = rtt.build_scene(num, device=dev,
                                     **({"seed": 0} if num == 4 else {}))
        out.append((f"scene{num}", scene, sky, (0.0, 0.0, 0.0)))
    big, sky = stress_scene(100000)
    out.append(("stress100k", big.to(dev), sky, (0.0, 1.0, -4.0)))
    earth, sky = rtt.build_scene(2, device=dev,
                                 earth_image=procedural_earth_texture(1024))
    out.append(("earth2048", earth, sky, (0.0, 0.0, 0.0)))
    return out


def bounce_lanes(dev, ws, settings, pos, width, height, regen):
    """The lane state of ``width`` x ``height`` camera rays (Morton order,
    frame key (0, 0)) and a function that sets up (rt_wave_rays) and
    traces (K5 or K6, by ``ws``) the next bounce's inputs through the
    kernel route: the argument tuple of ``wave_bounce`` after
    ``settings``, the hit kernel's raw outputs in it."""
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import rng
    from raytracer_tpu_torch.ops.intersect_cuda import hit_raw
    from raytracer_tpu_torch.ops.rays import wave_rays
    o, d = camera_rays(width, height, dev, position=pos)
    keys = rng.per_ray_keys(rng.frame_key(rng.key(0), 0),
                            camera_order(width, height, dev))
    use_rr = settings.russian_roulette > 0
    if regen:
        st = integ._regen_state(o, d, keys)
    else:
        st = integ._scan_state(o, d)

    def inputs(b):
        if regen:
            rays = wave_rays(st["d"], keys=keys, sample_i=st["sample_i"],
                             bounce=st["bounce_i"], with_rr=use_rr)
        else:
            rays = wave_rays(st["d"], keys=keys, bounce=b, with_rr=use_rr)
        raw = hit_raw(ws, st["o"], rays.unit)
        return (st, rays.dj, raw, rays.inv_len, rays.gauss, rays.fresnel,
                rays.rr)
    return st, inputs


def bounce_vs_plain(dev, ws, settings, pos, width, height, regen,
                    bounces: int = 4) -> dict:
    """``bounces`` bounces of rt_wave_bounce against wave_bounce_reference
    on the same inputs (K5's or K6's raw outputs), each output tensor
    compared, with the share of equal values and the largest difference;
    the state advances with the kernel's."""
    import torch

    from raytracer_tpu_torch.ops import bounce as tb
    st, inputs = bounce_lanes(dev, ws, settings, pos, width, height, regen)
    kw = {"regen": regen}
    bitwise, max_abs, equal, total = True, 0.0, 0, 0
    for b in range(bounces):
        args = (ws.scene, settings) + inputs(b)
        got = tb.wave_bounce(*args, bounce=b, **kw)
        want = tb.wave_bounce_reference(*args, bounce=b, **kw)
        for k in want:
            bitwise = bitwise and bool(torch.equal(got[k], want[k]))
            same = (got[k] == want[k]) | (torch.isnan(got[k].float())
                                          & torch.isnan(want[k].float()))
            equal += int(same.sum())
            total += same.numel()
            if want[k].is_floating_point():
                max_abs = max(max_abs, float(torch.nan_to_num(
                    (got[k] - want[k]).abs()).max()))
        st.update(got)
    return {"bitwise": bitwise, "max_abs_err": max_abs,
            "equal_share": equal / total,
            "raw_outputs": "K6" if ws.blocked else "K5"}


def fresh_launch_times(launch, restore, kernel: str,
                       repeats: int = 20) -> dict:
    """Milliseconds of ``launch()`` (a bare launch that updates its state
    in place) when every launch starts from the same state: ``restore()``
    before each, outside the timed interval. ``ms``: the mean of CUDA
    events around each launch; ``profiled_ms``: the profiler's device time
    of ``kernel`` a launch (None where it saw none)."""
    import torch
    restore()
    launch()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(repeats)]
    for start, stop in events:
        restore()
        start.record()
        launch()
        stop.record()
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in events) / repeats

    def loop():
        for _ in range(repeats):
            restore()
            launch()
    dev_ms = device_shares(loop, (kernel,))[kernel]["device_ms"]
    return {"ms": ms, "profiled_ms": dev_ms / repeats if dev_ms else None}


def bounce_bytes(args, want) -> tuple:
    """rt_wave_bounce's bytes bound on ``args`` (``wave_bounce``'s
    positional arguments, the state third, K5's raw outputs fifth) and
    the counts it rests on, from the plain version's result ``want``: a
    live lane reads its state, pixel sum, traced direction, raw t and code
    and 1 / |d| and writes its state (156 bytes); a live hit also reads
    its material id, uv, centre or normal, Gaussian, smoothness and
    Fresnel draw (44), its colour (12) on a colour texture or its texel
    (12) on an image; a path end reads the lane's primary ray (24); a
    finished lane reads its sample (4); the material table once."""
    from raytracer_tpu_torch.ops.intersect_cuda import resolve
    scene, settings, st = args[:3]
    rec_hit, shade = resolve(args[4], st["o"], args[3], args[5],
                             scene.needs_sphere_uv)
    alive = st["sample_i"] < settings.rays_per_pixel
    live = alive & rec_hit.hit
    ends = int((want["sample_i"] != st["sample_i"]).sum())
    ttype = scene.tex_type[shade.mat_id.long()]
    n_alive = int(alive.sum())
    n_bytes = (n_alive * 156 + (alive.numel() - n_alive) * 4
               + 44 * int(live.sum()) + 24 * ends
               + 12 * int((live & ((ttype == 0) | (ttype == 3))).sum())
               + tensor_bytes(scene.mat_type, scene.mat_ior, scene.mat_emit,
                              scene.tex_type, scene.tex_light,
                              scene.tex_dark, scene.tex_nsq,
                              scene.tex_offset, scene.tex_width,
                              scene.tex_height))
    return n_bytes, {"live_lanes": n_alive, "live_hits": int(live.sum()),
                     "path_ends": ends}


def phase_wave_bounce(dev, check_size=(256, 128),
                      time_size=(1000, 800)) -> dict:
    """Phase 19: rt_wave_bounce against its plain version on the card,
    bitwise, in both arms (regen with parking), 4 bounces of check_size
    camera lanes, under phase 12's settings and BOUNCE_VARIANTS, on scenes
    1-4, stress100k and earth2048; then timed on phase 12's scene-4 regen
    lanes at time_size (the inputs of their third bounce): bare launches
    each from the same state (``fresh_launch_times``: ``ms``,
    ``profiled_ms``), through the wrapper on copies (``wrapper_ms``) and
    the plain version (``plain_ms``), beside its bytes bound counted on
    these inputs (``bounce_bytes``). The stress100k cases feed it K6's raw
    outputs, the others K5's."""
    import torch

    import ctypes

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.ops import bounce as tb
    from raytracer_tpu_torch.ops.intersect_cuda import WaveScene
    w, h = check_size
    checks = {}
    for name, scene, sky, pos in bounce_scenes(dev):
        ws = WaveScene(scene)
        for variant, extra in BOUNCE_VARIANTS.items():
            s = rtt.RenderSettings(rays_per_pixel=2, reflect_limit=5,
                                   antialias=True, **extra).with_sky(sky)
            for arm in ("scan", "regen"):
                checks[f"{name}_{variant}_{arm}"] = bounce_vs_plain(
                    dev, ws, s, pos, w, h, arm == "regen")
    rec = {"checks": checks, "bitwise": all(
        r["bitwise"] for r in checks.values()),
        "max_abs_err": max(r["max_abs_err"] for r in checks.values()),
        "equal_share": min(r["equal_share"] for r in checks.values())}

    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    ws = WaveScene(scene)
    s = rtt.RenderSettings(rays_per_pixel=20, reflect_limit=5,
                           antialias=True, sampler="regen").with_sky(sky)
    w, h = time_size
    st, inputs = bounce_lanes(dev, ws, s, (0.0, 0.0, 0.0), w, h, True)
    for b in range(2):
        st.update(tb.wave_bounce(ws.scene, s, *inputs(b), regen=True))
    args = (ws.scene, s) + inputs(2)
    want = tb.wave_bounce_reference(*args, regen=True)
    n = w * h
    n_bytes, counts = bounce_bytes(args, want)
    timed = {k: v.clone() for k, v in st.items()}
    bare = tb.bounce_args(ws.scene, s, timed, *args[3:], regen=True)
    lib = build.load()
    stream = ctypes.c_void_p(build.stream(dev))

    def restore():
        for k, x in st.items():
            timed[k].copy_(x)
    rec.update(fresh_launch_times(
        lambda: lib.rt_wave_bounce(ctypes.byref(bare), stream), restore,
        "wave_bounce_kernel"))
    restore()
    lib.rt_wave_bounce(ctypes.byref(bare), stream)
    rec["bare_launch_bitwise"] = all(
        bool(torch.equal(timed[k], want[k])) for k in want)
    rec.update(lanes=n, **counts,
               wrapper_ms=cuda_ms(lambda: tb.wave_bounce(
                   *args, regen=True), 20),
               plain_ms=cuda_ms(lambda: tb.wave_bounce_reference(
                   *args, regen=True), 3),
               library_ms=None)
    rec.update(bound(n_bytes, 0.0))
    print(f"phase 19 rt_wave_bounce vs plain on raw K5 / K6 outputs, "
          f"{check_size[0]}x{check_size[1]} lanes, scenes 1-4, stress100k "
          f"(K6), earth2048, both arms; timed on scene 4's {w}x{h} regen "
          "lanes:", json.dumps(rec), flush=True)
    check(rec["bitwise"], "rt_wave_bounce differs from its plain version: "
          + json.dumps({k: v for k, v in checks.items()
                        if not v["bitwise"]}))
    check(rec["bare_launch_bitwise"], "rt_wave_bounce's bare launch differs")
    return rec


# -- phase 20: finished regen lanes in the ray set-up, K5 / K6, the bounce --

# the regen cells' scenes (perfbench/configs: upstream scene number or the
# SPD pyramid's level), camera positions and the share of a frame's
# lane-iterations whose lane has finished (PERF.md §5; None: measured by
# running the loop to its end first)
FINISHED_CELLS = {"rtiow_scene4": (4, {"num_spheres": 100, "seed": 0},
                                   (0.0, 0.5, -6.0), 0.73),
                  "earth_scene2": (2, {}, (0.0, 0.0, 0.0), 0.27),
                  "spd_tetra6": ("spd", {"level": 6}, (0.0, 0.0, 0.0),
                                 None)}


def finished_state(st: dict, done, spp: int) -> dict:
    """A copy of the regen state ``st`` with the lanes ``done`` finished
    and parked, as the loop leaves a lane whose last sample ended."""
    import torch

    from raytracer_tpu_torch.ops.bounce import PARK_ORIGIN
    out = {k: v.clone() for k, v in st.items()}
    out["sample_i"] = torch.where(done, torch.clamp(st["sample_i"], min=spp),
                                  st["sample_i"])
    out["o"] = torch.where(done[None, :], PARK_ORIGIN, st["o"])
    out["d"] = torch.where(done[None, :], torch.tensor(
        [[1.0], [0.0], [0.0]], device=done.device), st["d"])
    return out


def hit_ms(ws, o, unit, repeats: int = 10, **mask):
    """The hit kernel's (K5, or K6 on a blocked scene) device ms a launch
    on (o, unit) by the profiler, over ``repeats`` ``hit_raw`` calls
    (``mask``: its ``sample_i`` and ``spp``); None where it recorded
    none."""
    from raytracer_tpu_torch.ops.intersect_cuda import hit_raw
    name = "hit_resolve_blocked_kernel" if ws.blocked else \
        "hit_resolve_kernel"
    rec = device_shares(lambda: [hit_raw(ws, o, unit, **mask)
                                 for _ in range(repeats)], (name,))[name]
    return rec["device_ms"] / rec["count"] if rec["count"] else None


def finished_share(route, st: dict, spp: int) -> float:
    """The share of a frame's lane-iterations whose lane was finished:
    the regen loop run on a copy of ``st`` to its end, 1 - segments /
    (lanes x iterations)."""
    from raytracer_tpu_torch.ops import integrator as integ
    st = {k: v.clone() for k, v in st.items()}
    it = 0
    while it < spp * route.settings.reflect_limit and bool(
            (st["sample_i"] < spp).any()):
        integ._regen_iteration(route, st, it, False, False)
        it += 1
    return 1.0 - float(st["segs"]) / (st["o"].shape[1] * it)


def phase_finished_lanes(dev, cell: str, width: int = 1000,
                         height: int = 800, spp: int = 100) -> list:
    """Phase 20: what a finished regen lane (sample_i >= spp: all its
    samples traced) costs rt_wave_rays, K5 (K6 on the pyramid) and
    rt_wave_bounce. The
    width x height lanes of ``cell``'s scene at its regen cell's camera
    and settings (FINISHED_CELLS; spp, 5 bounces, antialias, the sky where
    the scene has one), run through the regen loop's iterations on the
    kernel route. Four states, by the cell's finished share f: ``none``
    (after 2 iterations, every lane live), ``loop`` (the loop's own state
    at the first iteration with f or more of its lanes finished),
    ``random`` (f of the lanes of ``none``, drawn at random, finished and
    parked: nearly every warp mixed) and ``all`` (every lane of ``loop``
    finished and parked). On each: rt_wave_rays bare on prebuilt
    arguments (``bare_times``) beside its bound (a live lane's 84 bytes
    and OPS_RAYS operations, a finished lane's 20 bytes), the hit kernel
    by the profiler's device time a launch over 10 ``hit_raw`` calls,
    without the loop's mask (``hit_profiled_ms``: the walk of a parked
    lane, as the parent ran it) and with it (``hit_masked_profiled_ms``:
    a finished lane skipped), on ``loop`` also with its finished lanes
    unparked, on their primary rays (``hit_unparked_profiled_ms``), and
    rt_wave_bounce bare, each launch from the same state
    (``fresh_launch_times``), beside ``bounce_bytes``; the kernels'
    outputs held bitwise against the plain versions (a finished lane's
    parked direction, its state unchanged), the masked hit's live rows
    against the unmasked launch's and the bounce on the masked hit's
    outputs against the plain bounce."""
    import ctypes

    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.ops import bounce as tb
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import rays, rng
    from raytracer_tpu_torch.ops.intersect_cuda import (WaveScene, hit_raw,
                                                        unit_rays)
    from raytracer_tpu_torch.models import bench_scenes
    num, kwargs, pos, share = FINISHED_CELLS[cell]
    if num == "spd":
        scene, sky = bench_scenes.spd_tetra_scene(device=dev, **kwargs)
    else:
        scene, sky = rtt.build_scene(num, device=dev, **kwargs)
    s = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                           antialias=True, sampler="regen",
                           sky_colour=(0.8, 1.0, 1.0)).with_sky(sky)
    ws = WaveScene(scene)
    o, d = camera_rays(width, height, dev, position=pos)
    keys = rng.per_ray_keys(rng.frame_key(rng.key(0), 0),
                            camera_order(width, height, dev))
    route = integ._Route(ws, s, "pallas")
    st = integ._regen_state(o, d, keys)
    n = o.shape[1]
    if share is None:
        share = finished_share(route, st, spp)
    states, it = {}, 0
    while it < spp * s.reflect_limit:
        if it == 2:
            states["none"] = ({k: v.clone() for k, v in st.items()}, it)
        if float((st["sample_i"] >= spp).float().mean()) >= share:
            states["loop"] = ({k: v.clone() for k, v in st.items()}, it)
            break
        integ._regen_iteration(route, st, it, False, False)
        it += 1
    gen = torch.Generator(device=dev).manual_seed(20)
    pick = torch.rand(n, generator=gen, device=dev) < share
    states["random"] = (finished_state(states["none"][0], pick, spp), 2)
    states["all"] = (finished_state(
        states["loop"][0], torch.ones(n, dtype=torch.bool, device=dev),
        spp), states["loop"][1])
    use_rr = s.russian_roulette > 0
    rows = 8 if use_rr else 7
    lib = build.load()
    stream = ctypes.c_void_p(build.stream(dev))
    recs = []
    for name, (st0, at) in states.items():
        done = st0["sample_i"] >= spp
        live = int((~done).sum())
        kw = dict(keys=keys, sample_i=st0["sample_i"], bounce=st0["bounce_i"],
                  with_rr=use_rr, spp=spp)
        seg = torch.zeros((), dtype=torch.int64, device=dev)
        draws = torch.empty((rows - 3, n), device=dev)
        out = rays.WaveRays(torch.empty_like(o), torch.empty_like(o),
                            torch.empty(n, device=dev), draws[0:3], draws[3],
                            draws[4] if use_rr else None)
        args = rays.rays_args(st0["d"], out, draws, segs=seg, **kw)
        rays_rec = bare_times("rt_wave_rays", args, dev, "wave_rays_kernel")
        rays_rec.update(bound(live * 84 + (n - live) * 20, live * OPS_RAYS))
        agree = rays_agreement(out, rays.wave_rays(st0["d"], plain=True,
                                                   **kw), done)
        rays_rec["bitwise"] = agree["bitwise"]
        raw = hit_raw(ws, st0["o"], out.unit)
        mask = dict(sample_i=st0["sample_i"], spp=spp)
        masked = hit_raw(ws, st0["o"], out.unit, **mask)
        hit = {"kernel": "K6" if ws.blocked else "K5",
               "profiled_ms": hit_ms(ws, st0["o"], out.unit),
               "masked_profiled_ms": hit_ms(ws, st0["o"], out.unit, **mask),
               "unparked_profiled_ms": None,
               "masked_live_rows_bitwise": all(
                   bool(torch.equal(a[~done], b[~done]))
                   for a, b in zip(masked, raw))}
        if name == "loop":  # the finished lanes on their primary rays
            hit["unparked_profiled_ms"] = hit_ms(
                ws, torch.where(done[None, :], st0["o0p"], st0["o"]),
                torch.where(done[None, :], unit_rays(st0["d0p"])[0],
                            out.unit))
        bargs = (scene, s, st0, out.dj, raw, out.inv_len, out.gauss,
                 out.fresnel, out.rr)
        want = tb.wave_bounce_reference(*bargs, regen=True)
        on_masked = tb.wave_bounce(scene, s, st0, out.dj, masked,
                                   *bargs[5:], regen=True)
        hit["bounce_on_masked_bitwise"] = all(
            bool(torch.equal(on_masked[k], want[k])) for k in want)
        n_bytes, counts = bounce_bytes(bargs, want)
        timed = {k: v.clone() for k, v in st0.items()}
        bare = tb.bounce_args(scene, s, timed, *bargs[3:], regen=True)

        def restore():
            for k, x in st0.items():
                timed[k].copy_(x)
        bounce_rec = fresh_launch_times(
            lambda: lib.rt_wave_bounce(ctypes.byref(bare), stream), restore,
            "wave_bounce_kernel")
        restore()
        lib.rt_wave_bounce(ctypes.byref(bare), stream)
        bounce_rec["bitwise"] = all(
            bool(torch.equal(timed[k], want[k]))
            and bool(torch.equal(want[k][..., done], st0[k][..., done]))
            for k in want)
        bounce_rec.update(bound(n_bytes, 0.0), **counts)
        recs.append({"state": name, "iteration": at, "lanes": n,
                     "finished_share": 1.0 - live / n,
                     "rt_wave_rays": rays_rec, "hit": hit,
                     "rt_wave_bounce": bounce_rec})
    print(f"phase 20 finished regen lanes, {cell} {width}x{height} at "
          f"{spp} spp ({cell}.regen's camera and settings, a frame's "
          f"finished share {share:.4f}): rt_wave_rays, K5 / K6, "
          "rt_wave_bounce by state:", json.dumps(recs), flush=True)
    check(all(r["rt_wave_rays"]["bitwise"] and r["rt_wave_bounce"]["bitwise"]
              and r["hit"]["masked_live_rows_bitwise"]
              and r["hit"]["bounce_on_masked_bitwise"] for r in recs),
          "a finished-lane state differs from the plain versions")
    return recs


def fly_camera(i: int, width: int, height: int):
    """benchmarks/suite.py:93-96's pose i: 0.25 ahead and 0.02 rad of yaw
    per move from (0, 0.5, -6)."""
    from raytracer_tpu_torch import CameraConfig
    return CameraConfig(width=width, height=height,
                        position=(0.0, 0.5, -6.0 + 0.25 * i), y_rot=0.02 * i)


def fly_settings():
    import raytracer_tpu_torch as rtt
    scene, sky = rtt.build_scene(4, seed=0)
    return scene, rtt.RenderSettings(rays_per_pixel=1, reflect_limit=5,
                                     antialias=True).with_sky(sky)


def history_inputs(dev, r, cam):
    """The inputs of the next warp frame if ``r`` moved to ``cam``: its
    rays, the kernel's primary-hit depth there, the old accumulation and
    weights with the history cap, and the old pinhole; and the
    megakernel's (5, n_pad) output of that frame."""
    from raytracer_tpu_torch.models.camera import build_camera, primary_rays
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    o, d = primary_rays(build_camera(cam), cam.width, cam.height, device=dev)
    out, n = mk.mega_frame(r._mega, r.settings, o.T, d.T,
                           rng.frame_key(r.base_key, 99))
    old = build_camera(r.camera_cfg)
    return (o.contiguous(), d.contiguous(), out[4, :n], r.accum.clone(),
            r._wpix.clone(), 8.0, old.position, old.tl_pixel, old.delta_u,
            old.delta_v), out


def index_history(n: int, dev):
    """An old accumulation whose pack at pixel j is the word
    ``(j << 5) | 31`` (j < 2^27): each channel holds the decode of one
    9-bit digit of j, which packs back to that digit. With weights 31 and
    a cap of 31, the gather's hist spells the source pixel of every valid
    pixel and w > 0 exactly there (``source_pixels``)."""
    import torch
    j = torch.arange(n, dtype=torch.int32, device=dev)
    q = torch.stack([(j >> s) & 511 for s in (18, 9, 0)], 1).float()
    return (q * q) * HIST_SCALE, torch.full((n,), 31.0, device=dev), 31.0


def source_pixels(hist, w):
    """The source pixel of each pixel that the gather gave over
    ``index_history``, -1 where it gave no weight."""
    import torch
    q = torch.round(torch.sqrt((hist / HIST_SCALE).double())).int()
    j = (q[:, 0] << 18) | (q[:, 1] << 9) | q[:, 2]
    return torch.where(w > 0, j, -1)


def launch_once(name: str, args, dev):
    """One bare launch of the kernel ``name`` on prebuilt arguments,
    checked; returns a function that launches it again unchecked."""
    import ctypes

    from raytracer_tpu_torch.kernels import build
    lib = build.load()
    fn = getattr(lib, name)
    stream = ctypes.c_void_p(build.stream(dev))
    build.check(lib, fn(ctypes.byref(args), stream), name)
    return lambda: fn(ctypes.byref(args), stream)


def launch_ms(name: str, args, dev, repeats: int = 20) -> float:
    """CUDA-event milliseconds of the bare kernel launch ``name`` on
    prebuilt arguments: no wrapper, checks or allocation in front of it."""
    return cuda_ms(launch_once(name, args, dev), repeats)


def profiled_launch_ms(name: str, args, dev, kernel: str,
                       repeats: int = 20):
    """Device milliseconds per bare launch of ``name`` on prebuilt
    arguments: torch.profiler's device time of ``kernel`` over
    ``repeats`` launches, over the launches it recorded. Back-to-back CUDA
    events measure the kernel only where it outlasts the host's issue of
    the next launch; this does not depend on that. None where the profiler
    saw no device time."""
    import ctypes

    from raytracer_tpu_torch.kernels import build
    fn = getattr(build.load(), name)
    stream = ctypes.c_void_p(build.stream(dev))
    rec = device_shares(lambda: [fn(ctypes.byref(args), stream)
                                 for _ in range(repeats)], (kernel,))
    ms, count = rec[kernel]["device_ms"], rec[kernel]["count"]
    return ms / count if ms else None, count


def bare_times(name: str, args, dev, kernel: str) -> dict:
    """``ms``: CUDA events over bare launches (``launch_ms``);
    ``profiled_ms``: the profiler's device time a launch."""
    profiled, count = profiled_launch_ms(name, args, dev, kernel)
    return {"ms": launch_ms(name, args, dev), "profiled_ms": profiled,
            "profiled_launches": count}


def phase_history(dev, args, width, height) -> tuple:
    """The source pixels of a real move's projection (the plain history
    gather over ``index_history``), then rt_warp_gather (K7 alone) on that
    move's indices (a coherent band) and on a full-range random pattern,
    each against its plain version, bitwise. Times: the bare kernel launch
    on prebuilt arguments (``ms``), the same through the wrapper
    (``wrapper_ms``), the plain version and index_select. Returns the
    move's valid share and source pixels, and K7's records."""
    import torch

    from raytracer_tpu_torch.ops import warp
    n = width * height
    # the source pixels: the same move over the index accumulation
    by_index = (*args[:3], *index_history(n, dev), *args[6:])
    idx = source_pixels(*warp.gather_history(width, height, *by_index))
    flat = idx.clamp(min=0)
    hrec = {"pixels": n, "valid_share": float((idx >= 0).float().mean()),
            "source_pixels": int(torch.unique(idx[idx >= 0]).numel())}

    g = np.random.default_rng(13)
    values = torch.as_tensor(g.integers(-2**31, 2**31 - 1, n,
                                        dtype=np.int64).astype(np.int32),
                             device=dev)
    patterns = {
        "coherent_band": (flat, idx >= 0),
        "full_range": (torch.as_tensor(g.integers(0, n, n).astype(np.int32),
                                       device=dev),
                       torch.as_tensor(g.uniform(size=n) < 0.8,
                                       device=dev))}
    grec = {}
    for name, (q, valid) in patterns.items():
        got = warp.warp_gather(values, q, valid)
        want = warp.warp_gather_reference(values, q, valid)
        out = torch.empty_like(got)
        gargs = warp._gather_args(values, q, valid, out)
        read = int(torch.unique(q[valid]).numel())
        grec[name] = {
            "queries": n, "words_read": read,
            "bitwise": bool(torch.equal(got, want)),
            "max_abs_err": float((got - want).abs().max()),
            "ms": launch_ms("rt_warp_gather", gargs, dev),
            "wrapper_ms": cuda_ms(lambda: warp.warp_gather(values, q, valid),
                                  20),
            "plain_ms": cuda_ms(
                lambda: warp.warp_gather_reference(values, q, valid), 5),
            "library_ms": cuda_ms(lambda: torch.index_select(values, 0, q),
                                  20)}
        grec[name]["bare_launch_bitwise"] = bool(torch.equal(out, got))
        # idx, valid and out once; the words read once each
        grec[name].update(bound(n * (4 + 1 + 4) + read * 4, 3 * n))
        check(grec[name]["bitwise"], f"rt_warp_gather differs on {name}")
        check(grec[name]["bare_launch_bitwise"],
              f"rt_warp_gather's bare launch differs on {name}")
    print("phase 13 rt_warp_gather (K7) vs plain:", json.dumps(grec),
          flush=True)
    return hrec, grec


def phase_camera_rays(dev) -> dict:
    """rt_camera_rays against camera_rays_reference on the card, bitwise
    on every padded lane (pad lanes o = 0, d = (1, 0, 0)): the
    fly-through's camera at 3840x2160, pixpack 8 (its shape on the path),
    bench.py's camera at 1000x800 (pixpack 8 and 1) and a 130x70 film
    (pixpack 1 and 8: not whole tiles, and smaller than one). Timed on the
    4K camera: bare launch (``ms``), profiler, wrapper and plain version."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models import camera
    cases = {"fly_3840x2160_pixpack8": (fly_camera(1, FLY_W, FLY_H), 8),
             "bench_1000x800_pixpack8": (rtt.CameraConfig(1000, 800), 8),
             "bench_1000x800_pixpack1": (rtt.CameraConfig(1000, 800), 1),
             "odd_130x70_pixpack1": (fly_camera(3, 130, 70), 1),
             "odd_130x70_pixpack8": (fly_camera(3, 130, 70), 8)}
    rec = {}
    for name, (cfg, k) in cases.items():
        cam = camera.build_camera(cfg)
        w, h = cfg.width, cfg.height
        got = camera.camera_rays(cam, w, h, k, dev)
        want = camera.camera_rays_reference(cam, w, h, k, dev)
        n = w * h
        pad_d = torch.tensor([[1.0], [0.0], [0.0]], device=dev)
        rec[name] = {
            "pixels": n, "lanes": got.o.shape[1],
            "bitwise": bool(torch.equal(got.o, want.o)
                            and torch.equal(got.d, want.d)
                            and (got.n, got.pixpack) == (want.n, k)),
            "pad_lanes": bool(not got.o[:, n:].any() and torch.equal(
                got.d[:, n:], pad_d.expand(3, got.o.shape[1] - n))),
            "max_abs_err": float((got.d - want.d).abs().max()),
            "d_equal_share": float((got.d == want.d).all(0).float().mean())}
    top = rec["fly_3840x2160_pixpack8"]
    cam = camera.build_camera(cases["fly_3840x2160_pixpack8"][0])
    o = torch.empty((3, top["lanes"]), device=dev)
    d = torch.empty_like(o)
    args = camera._camera_args(cam, o, d, FLY_W * FLY_H, FLY_W)
    top.update(bare_times("rt_camera_rays", args, dev, "camera_rays_kernel"))
    ref = camera.camera_rays_reference(cam, FLY_W, FLY_H, 8, dev)
    top.update(
        wrapper_ms=cuda_ms(lambda: camera.camera_rays(cam, FLY_W, FLY_H, 8,
                                                      dev), 20),
        plain_ms=cuda_ms(lambda: camera.camera_rays_reference(
            cam, FLY_W, FLY_H, 8, dev), 3),
        library_ms=None,
        bare_launch_bitwise=bool(torch.equal(o, ref.o)
                                 and torch.equal(d, ref.d)))
    # o and d written once; nothing read but the basis
    top.update(bound(24 * top["lanes"], OPS_CAMERA * top["lanes"]))
    print("phase 13 rt_camera_rays vs camera_rays_reference:",
          json.dumps(rec), flush=True)
    for name, r in rec.items():
        check(r["bitwise"] and r["pad_lanes"],
              f"rt_camera_rays differs from its plain version on {name}")
    check(top["bare_launch_bitwise"], "rt_camera_rays' bare launch differs")
    return top


def phase_temporal_frame(dev, out, accum, wpix, old, new, width, height,
                         sources: int) -> dict:
    """rt_temporal_frame against temporal_frame_reference on the card on
    the fly-through's 4K frame (the megakernel's output ``out``), bitwise
    with the segment count: the static arm over the accumulation and
    weights, and the warp arm gathering them from the old camera ``old``
    into ``new`` (the move phase_history projects, whose ``sources`` old
    pixels it reads). Each arm timed as a bare launch on
    prebuilt arguments (``ms``), by the profiler and through the wrapper;
    the plain version beside it."""
    import torch

    from raytracer_tpu_torch.ops import warp
    n = width * height
    src = warp.history_source(accum, wpix, 8.0, old)
    rec = {}
    for arm in ("static", "warp"):
        extra = () if arm == "static" else (src, new, width, height)
        got = warp.temporal_frame(out, n, accum.clone(), wpix.clone(),
                                  *extra)
        want = warp.temporal_frame_reference(out, n, accum.clone(),
                                             wpix.clone(), *extra)
        a, w = accum.clone(), wpix.clone()
        if arm == "static":
            planes = (a, w)                 # in place
            # mean and segments read; the accumulation and weights read
            # and written
            moved = n * (16 + 2 * 16)
        else:
            planes = (torch.empty_like(a), torch.empty_like(w))
            # mean, segments and depth read, the outputs written once; the
            # old accumulation and weight only at the source pixels read
            moved = n * (16 + 4 + 16) + sources * 16
        segs = torch.empty((), dtype=torch.float64, device=dev)
        args = warp._frame_args(out, n, a, w, *planes, segs,
                                *(extra or (None, None, width, height)))
        launch_once("rt_temporal_frame", args, dev)
        bare_bitwise = bool(torch.equal(planes[0], want[0])
                            and torch.equal(planes[1], want[1])
                            and float(segs) == float(want[2]))
        rec[arm] = {
            "pixels": n, "segments": float(want[2]),
            "bitwise": bool(torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])
                            and float(got[2]) == float(want[2])),
            "bare_launch_bitwise": bare_bitwise,
            "max_abs_err": max(float((got[0] - want[0]).abs().max()),
                               float((got[1] - want[1]).abs().max())),
            **bare_times("rt_temporal_frame", args, dev,
                         "temporal_frame_kernel"),
            "wrapper_ms": cuda_ms(lambda: warp.temporal_frame(
                out, n, a, w, *extra), 20),
            "plain_ms": cuda_ms(lambda: warp.temporal_frame_reference(
                out, n, a, w, *extra), 3),
            "library_ms": None,
            **bound(moved, n * (OPS_FRAME if extra else OPS_BLEND))}
    rec["warp"]["kept_share"] = float((want[1] > 1).float().mean())
    print(f"phase 13 rt_temporal_frame vs temporal_frame_reference, "
          f"{width}x{height}, static and warp arms:", json.dumps(rec),
          flush=True)
    for arm, r in rec.items():
        check(r["bitwise"], f"rt_temporal_frame's {arm} arm differs")
        check(r["bare_launch_bitwise"],
              f"rt_temporal_frame's {arm} bare launch differs")
    return rec


def phase_temporal_vs_plain(dev, width, height) -> dict:
    """A temporal Renderer frame, a move and the first warp frame on the
    card, then two moves and a frame, against the same steps composed from
    the plain versions (camera_rays_reference, mega_reference,
    temporal_frame_reference) on the same keys, bitwise; each frame is
    rt_camera_rays (at a camera's first frame), rt_megakernel and
    rt_temporal_frame, and no other entry point."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models import camera
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng, warp
    scene, settings = fly_settings()
    cams = [fly_camera(i, width, height) for i in range(4)]
    r = rtt.Renderer(scene, cams[0], settings, seed=0, device=dev,
                     temporal=True)
    before = _counts()
    r.render_frame(block=True)
    r.move_camera(cams[1])
    r.render_frame(block=True)
    r.move_camera(cams[2])
    r.move_camera(cams[3])
    r.render_frame(block=True)
    launches = _launches(before, TEMPORAL_ENTRIES)
    n = width * height
    accum = torch.zeros((n, 3), device=dev)
    wpix = torch.zeros(n, device=dev)
    stash = None
    for k, cfg in enumerate((cams[0], cams[1], cams[3])):
        cam = camera.build_camera(cfg)
        rays = camera.camera_rays_reference(cam, width, height,
                                            r.settings.pixpack, dev)
        o_p, d_p, seed, kw = mk.mega_inputs(r._mega, r.settings, rays, None,
                                            rng.frame_key(r.base_key, k))
        out = mk.mega_reference(r._mega.packed, r._mega.mat, o_p, d_p, seed,
                                **kw)
        accum, wpix, segs = warp.temporal_frame_reference(
            out, n, accum, wpix, stash, cam, width, height)
        # the next move keeps this view
        stash = warp.history_source(accum, wpix, 8.0, cam)
    stats = pixel_diff(r.accum, accum)
    stats["bitwise"] = bool(torch.equal(r.accum, accum)
                            and torch.equal(r._wpix, wpix)
                            and float(r._last_segs) == float(segs))
    stats["weights_equal_share"] = float((r._wpix == wpix).float().mean())
    rec = {"launches": launches, "vs_plain": stats,
           "kept_share": float((wpix > 1).float().mean())}
    print(f"phase 13 temporal Renderer frame, move, warp frame, two moves, "
          f"warp frame, {width}x{height}, vs the plain steps:",
          json.dumps(rec), flush=True)
    check(launches == {"rt_megakernel": 3, "rt_camera_rays": 3,
                       "rt_temporal_frame": 3, "rt_warp_gather": 0},
          f"temporal frames launched {launches}")
    check(stats["bitwise"], "temporal frames differ from the plain steps")
    return rec


# device ops a temporal frame may run on the card: the camera rays (at a
# camera's first frame), the megakernel and the epilogue (the segment
# count's sum is inside it); anything else (torch.cat, rsqrt, the norm, a
# mul, add or div, a fill, the sum's cast) would be a torch pass over the
# frame
TEMPORAL_KERNELS = ("camera_rays_kernel", "megakernel",
                    "temporal_frame_kernel")
# the kernels whose device time phase 13 reads, the parent's too
TEMPORAL_NAMES = TEMPORAL_KERNELS + ("sum_functor",)


def fly_profile_leg() -> dict:
    """Phase 13's profile: the fly-through's Renderer after a warm frame
    and move; one static frame, one warp frame (a move and its frame) and
    the fly window (FLY_MOVES moves, each followed by a frame) under
    torch.profiler, each with its device ms by kernel, device ops, busy
    share and every device op. Runs on whichever raytracer_tpu_torch is
    imported (scripts/k1_groups.py times the parent tree with it)."""
    import torch

    import raytracer_tpu_torch as rtt
    dev = torch.device("cuda", 0)
    scene, settings = fly_settings()
    r = rtt.Renderer(scene, fly_camera(0, FLY_W, FLY_H), settings, seed=0,
                     device=dev, temporal=True)
    r.render_frame(block=True)
    r.move_camera(fly_camera(0, FLY_W, FLY_H))
    r.render_frame(block=True)

    def fly():
        for i in range(FLY_MOVES):
            r.move_camera(fly_camera(i, FLY_W, FLY_H))
            r.render_frame()
    out = {"static": device_shares(r.render_frame, TEMPORAL_NAMES,
                                   all_ops=True),
           "warp": device_shares(
               lambda: (r.move_camera(fly_camera(1, FLY_W, FLY_H)),
                        r.render_frame()), TEMPORAL_NAMES, all_ops=True),
           "fly": device_shares(fly, TEMPORAL_NAMES, all_ops=True)}
    out["fly"]["device_ops_per_frame"] = out["fly"]["device_ops"] / FLY_MOVES
    out["fly"]["others"] = [k for k in out["fly"]["device_kernels"]
                            if not any(t in k[0] for t in TEMPORAL_KERNELS)]
    out["finite"] = bool(torch.isfinite(r.accum).all())
    return out


def phase_fly_profile() -> dict:
    """``fly_profile_leg`` in a fresh process (a late profiler session in
    this long process once recorded no device events; phase 18b)."""
    import pathlib
    here = pathlib.Path(__file__).resolve().parent
    code = ("import json, chip_smoke; print(json.dumps("
            "chip_smoke.fly_profile_leg()))")
    run = subprocess.run([sys.executable, "-c", code], cwd=here,
                         capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, "fly-through profile process failed: "
          + run.stderr[-2000:])
    prof = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"phase 13 fly-through scene 4 {FLY_W}x{FLY_H} under "
          "torch.profiler: a static frame, a warp frame and the fly window",
          json.dumps(prof), flush=True)
    for leg in ("static", "warp", "fly"):
        check(prof[leg]["megakernel"]["device_ms"] > 0,
              f"the profiled {leg} frame recorded no megakernel")
    check(prof["finite"], "profiled fly-through not finite")
    check(not prof["fly"]["others"], "kernels other than the temporal "
          f"frame's ran in the fly window: {prof['fly']['others']}")
    counts = {k: sum(c for name, _, c in prof["fly"]["device_kernels"]
                     if k in name) for k in TEMPORAL_KERNELS}
    check(all(c == FLY_MOVES for c in counts.values()),
          f"the fly window ran {counts}, not one of each a frame")
    return prof


def phase_flythrough(dev) -> dict:
    """benchmarks/suite.py:66-109 on the port: scene 4 at 4K, 1 spp, 5
    bounces, a temporal Renderer; a warm frame and a warm move, then
    FLY_MOVES moves each followed by a frame, one final sync, counts set
    taken just before and read just after. The kernel checks of the new
    kernels and K7 run on this run's first real move, before the timed
    loop; the profiled frames after it."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models.camera import build_camera
    from raytracer_tpu_torch.ops import megakernel as mk
    scene, settings = fly_settings()
    r = rtt.Renderer(scene, fly_camera(0, FLY_W, FLY_H), settings, seed=0,
                     device=dev, temporal=True)
    r.render_frame(block=True)
    r.move_camera(fly_camera(0, FLY_W, FLY_H))
    r.render_frame(block=True)
    rays_rec = phase_camera_rays(dev)
    args, out = history_inputs(dev, r, fly_camera(1, FLY_W, FLY_H))
    hrec, grec = phase_history(dev, args, FLY_W, FLY_H)
    frec = phase_temporal_frame(
        dev, out, args[3], args[4], build_camera(r.camera_cfg),
        build_camera(fly_camera(1, FLY_W, FLY_H)), FLY_W, FLY_H,
        hrec["source_pixels"])
    del args, out

    before = _counts()
    t0 = time.perf_counter()
    segs = []
    for i in range(FLY_MOVES):
        r.move_camera(fly_camera(i, FLY_W, FLY_H))
        r.render_frame(block=(i == FLY_MOVES - 1))
        segs.append(r._last_segs)
    dt = time.perf_counter() - t0
    launches = _launches(before, TEMPORAL_ENTRIES)
    hits = r._depth < mk.INF
    kept = float((r._wpix[hits] > 1).float().mean())
    r.check_health()
    segments = float(sum(float(x) for x in segs))
    rec = {"frames": FLY_MOVES, "width": FLY_W, "height": FLY_H,
           "group": sweep_group(r),
           "fps": FLY_MOVES / dt, "mrays_per_sec": segments / dt / 1e6,
           "frame_ms": dt / FLY_MOVES * 1e3, "segments": segments,
           "launches": launches, "hit_share": float(hits.float().mean()),
           "w_gt_1_share_of_hits": kept,
           "w_gt_1_share_of_all": float((r._wpix > 1).float().mean()),
           "finite": bool(torch.isfinite(r.accum).all())}
    # one static frame (no move) and one warp frame (a move), alternating
    static, moving = [], []
    for k in range(3):
        static.append(cuda_ms(lambda: r.render_frame()))
        cam = fly_camera(FLY_MOVES + k, FLY_W, FLY_H)
        moving.append(cuda_ms(lambda: (r.move_camera(cam),
                                       r.render_frame())))
    rec.update(static_frame_ms=static, warp_frame_ms=moving)
    print(f"phase 13 fly-through scene 4 {FLY_W}x{FLY_H} 1 spp:",
          json.dumps(rec), flush=True)
    check(launches == {"rt_megakernel": FLY_MOVES,
                       "rt_camera_rays": FLY_MOVES,
                       "rt_temporal_frame": FLY_MOVES, "rt_warp_gather": 0},
          f"fly-through launched {launches}")
    check(kept > W_KEPT_MIN, f"(w > 1) on {kept} of the hit pixels after "
          f"the last move (need > {W_KEPT_MIN})")
    check(rec["finite"], "fly-through accumulation not finite")
    del r
    prof = phase_fly_profile()
    return {"fly": rec, "history": hrec, "gather": grec, "rays": rays_rec,
            "frame": frec, "profile": prof}


# -- phase 14: coherent sampling, K5's counters, elastic recovery ------------

def phase_coherent_regen(dev, width: int, height: int) -> dict:
    """(b) One coherent regen frame through Renderer on the card (scene 4,
    4 spp): K5, rt_wave_rays and rt_wave_bounce once an iteration and no
    other entry point, the ray set-up drawing the tile bundles itself;
    against the plain route on the same rays and key."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import rng
    scene, sky = rtt.build_scene(4, seed=0)
    cam = rtt.CameraConfig(width=width, height=height,
                           position=(0.0, 0.5, -6.0))
    settings = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                                  antialias=True, sampler="regen",
                                  coherent=True).with_sky(sky)
    r = rtt.Renderer(scene, cam, settings, seed=0, device=dev)
    before = _counts()
    r.render_frame(block=True)
    launches = _launches(before)
    r.check_health()
    ref, ref_segs = integ.render_sample_mean(
        r.packed_scene, settings, r._o, r._d, rng.frame_key(r.base_key, 0),
        ray_idx=r._ray_idx, backend="plain")
    stats = pixel_diff(r.accum, ref)
    stats["segs_rel"] = abs(r.total_segments - float(ref_segs)) / float(
        ref_segs)
    rec = {"launches": launches, "segments": r.total_segments,
           "vs_plain": stats}
    print(f"phase 14b coherent regen Renderer frame, scene 4 {width}x"
          f"{height} spp 4, vs the plain route:", json.dumps(rec), flush=True)
    check(launches["rt_hit_resolve"] > 0
          and launches["rt_wave_rays"] == launches["rt_hit_resolve"]
          and launches["rt_wave_bounce"] == launches["rt_hit_resolve"]
          and set(launches) == set(WAVE_ENTRIES),
          f"coherent regen frame launched {launches}")
    check_pixels(stats, "coherent regen frame vs the plain route")
    check(stats["segs_rel"] <= SEGS_REL_MAX,
          f"coherent regen: segments differ by {stats['segs_rel']:.3g}")
    return rec


def _path_counts(before) -> dict:
    """The launches since ``before`` (``_launches``), K1's among them, and
    of those K1's coherent arm's."""
    out = _launches(before, WAVE_ENTRIES + ("rt_megakernel",))
    out["coherent_arm"] = (_counts() - before)["rt_megakernel.coherent"]
    return out


def regen_band_vs_plain(dev, r, rows) -> dict:
    """Rows r0 <= y < r1 of a regen Renderer's camera as a frame of their
    own (row-major, keyed by their global pixel indices), at the
    Renderer's settings and first frame key: the kernel route against the
    plain route on the same rays. The coherent draws belong to the lane
    position in the frame traced, so the band is its own frame and is not
    compared with the whole frame's pixels."""
    import torch

    from raytracer_tpu_torch.models.camera import build_camera, primary_rays
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import rng
    cam = r.camera_cfg
    order = np.arange(rows[0] * cam.width, rows[1] * cam.width,
                      dtype=np.int32)
    o, d = primary_rays(build_camera(cam), cam.width, cam.height,
                        pixel_order=order, device=dev)
    idx = torch.as_tensor(order, device=dev)
    fkey = rng.frame_key(r.base_key, 0)
    mean, segs = integ.render_sample_mean(r.packed_scene, r.settings, o, d,
                                          fkey, ray_idx=idx)
    t0 = time.perf_counter()
    ref, ref_segs = integ.render_sample_mean(r.packed_scene, r.settings, o,
                                             d, fkey, ray_idx=idx,
                                             backend="plain")
    _sync(dev)
    stats = pixel_diff(mean, ref)
    stats["frame_mean_rel"] = abs(float(mean.mean()) - float(
        ref.mean())) / float(ref.mean())
    stats["segs_rel"] = abs(float(segs) - float(ref_segs)) / float(ref_segs)
    stats.update(rows=list(rows), pixels=len(order),
                 plain_ms=(time.perf_counter() - t0) * 1e3)
    return stats


def phase_coherent_paths(dev, width: int = 1000, height: int = 800) -> list:
    """(c) Coherent against per-lane sampling through Renderer at
    1000x800, 5 bounces: a warm-up frame each, then timed runs of
    render_frames in turns (per-lane, coherent, coherent, per-lane), the
    counts taken just before each run and read just after. Then the
    coherent Renderer's warm-up frame against the plain version: scene 4's
    whole frame against mega_reference; two megakernel tiles from the
    middle of stress10k's frame (at the path's pixpack, with their tile
    offset); and, for the scene-4 (20 spp, K5) and stress100k (4 spp, K6)
    regen paths, a band of 16 rows as a frame of its own, kernel route
    against plain route (the plain versions are too slow for the whole
    frame). A coherent regen iteration is three kernels, as a per-lane one
    is: rt_wave_rays (drawing the tile bundles), K5 / K6, rt_wave_bounce;
    no other entry point."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    paths = (("scene4_mega", rtt.build_scene(4, seed=0), "auto", 20,
              (0.0, 0.0, 0.0), 5),
             ("stress10k_mega", stress_scene(10000), "auto", 20,
              (0.0, 1.0, -4.0), 2),
             ("scene4_regen", rtt.build_scene(4, seed=0), "regen", 20,
              (0.0, 0.0, 0.0), 5),
             ("stress100k_regen", stress_scene(100000), "regen", 4,
              (0.0, 1.0, -4.0), 2))
    recs = []
    for name, (scene, sky), sampler, spp, pos, frames in paths:
        cam = rtt.CameraConfig(width=width, height=height, position=pos)
        rs = {}
        for coherent in (False, True):
            s = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                   antialias=True, sampler=sampler,
                                   coherent=coherent).with_sky(sky)
            rs[coherent] = rtt.Renderer(scene, cam, s, seed=0, device=dev)
            rs[coherent].render_frame(block=True)
        first = rs[True].accum.clone()
        mega = sampler != "regen"
        runs = {False: [], True: []}
        for coherent in (False, True, True, False):
            before = _counts()
            stat = rs[coherent].render_frames(frames)
            runs[coherent].append({"frame_ms": stat["frame_ms"]
                                   / stat["frames"],
                                   "mrays_per_sec": stat["mrays_per_sec"],
                                   "launches": _path_counts(before)})
        rec = {"path": name, "spp": spp, "frames_per_run": frames,
               "pixpack": rs[True].settings.pixpack}
        if mega:
            rec["group"] = sweep_group(rs[True])
        for coherent, key in ((False, "per_lane"), (True, "coherent")):
            rs[coherent].check_health()
            rec[key] = {
                "frame_ms": [x["frame_ms"] for x in runs[coherent]],
                "mrays_per_sec": [x["mrays_per_sec"] for x in runs[coherent]],
                "launches": runs[coherent][0]["launches"],
                "finite": bool(torch.isfinite(rs[coherent].accum).all())}
        if sampler == "regen":
            mid = height // 2
            vs = regen_band_vs_plain(dev, rs[True], (mid - 8, mid + 8))
        elif name == "stress10k_mega":
            t0 = width * height // (mk.MEGA_TILE * rs[True].settings.pixpack)
            t0 = t0 // 2 - 1
            vs = renderer_vs_mega_reference(dev, rs[True], first,
                                            tiles=(t0, t0 + 2))
        else:
            vs = renderer_vs_mega_reference(dev, rs[True], first)
        rec["coherent"]["vs_plain"] = vs
        print(f"phase 14c coherent vs per-lane, {name} {width}x{height} "
              f"spp {spp}:",
              json.dumps(rec), flush=True)
        check_frame(vs, f"{name}: coherent frame vs the plain version")
        if mega:
            check(vs["bitwise"], f"{name}: coherent frame not bitwise "
                  "mega_reference")
        if "segs_rel" in vs:
            check(vs["segs_rel"] <= SEGS_REL_MAX,
                  f"{name}: segments differ by {vs['segs_rel']:.3g}")
        coh = rec["coherent"]["launches"]
        if sampler == "regen":
            hit = coh["rt_hit_resolve_blocked"] + coh["rt_hit_resolve"]
            check(hit > 0 and coh["rt_wave_rays"] == hit
                  and coh["rt_wave_bounce"] == hit
                  and set(coh) == set(WAVE_ENTRIES) | {
                      "rt_megakernel", "coherent_arm"}
                  and coh["rt_megakernel"] == 0,
                  f"{name}: the coherent runs launched {coh}")
        else:
            check(coh["rt_megakernel"] == frames
                  and coh["coherent_arm"] == frames,
                  f"{name}: the coherent runs launched {coh}")
            check(rec["per_lane"]["launches"]["coherent_arm"] == 0,
                  f"{name}: the per-lane runs took the coherent arm")
        check(rec["coherent"]["finite"] and rec["per_lane"]["finite"],
              f"{name}: non-finite accumulation")
        recs.append(rec)
    return recs


def segment_tests(dev, scene, width: int, height: int, settings) -> dict:
    """An estimate of the mean primitive tests per traced segment of the
    timed megakernel frame (same scene, camera, spp and bounces): the
    megakernel has no counters, so the segments of a scan-sampler frame
    of that scene, camera and settings are counted instead, by K5's
    counting launch, on each bounce's live rays after the antialias
    jitter. The scan sampler draws other randoms than the megakernel, so
    its segments follow the same distribution but are not the timed
    frame's own."""
    import torch

    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import rng
    from raytracer_tpu_torch.ops.rays import wave_rays
    ws = ic.WaveScene(scene.to(dev), blocked=False)
    o0, d0 = camera_rays(width, height, dev)
    idx = camera_order(width, height, dev)
    use_rr = settings.russian_roulette > 0
    # the bounces run eagerly (no graph), the counting launch between the
    # ray set-up and the bounce, on the rays the bounce traces
    route = integ._Route(ws, settings, "pallas")
    fkey = rng.frame_key(rng.key(0), 0)
    tests = torch.zeros((), dtype=torch.float64, device=dev)
    segs = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(settings.rays_per_pixel):
        keys = rng.per_ray_keys(rng.sample_key(fkey, s), idx)
        st = integ._scan_state(o0, d0)
        for b in range(settings.reflect_limit):
            rays = wave_rays(st["d"], keys=keys, bounce=b,
                             antialias=settings.antialias, with_rr=use_rr)
            count = ic.hit_resolve_counted(ws.packed, st["o"], rays.unit)[12]
            tests += count[st["alive"]].double().sum()
            segs += st["alive"].sum()
            integ._bounce(route, st, rays, regen=False, bounce=b)
    return {"tests_per_segment": float(tests / segs),
            "segments": float(segs),
            "counted_on": f"estimate: the segments of a {width}x{height} "
                          f"scan-sampler frame at {settings.rays_per_pixel}"
                          " spp of the same scene and camera as the timed "
                          "megakernel frame (the megakernel has no "
                          "counters)"}


def phase_counters(dev, n_check: int, n_mean: int,
                   n_k6_walk: int = 1 << 16) -> dict:
    """(d) The counting rt_hit_resolve (K5's with_stats arm) against its
    plain version on n_check field rays over scenes 4 and 2 (every output
    equal where the winner agrees, every count equal), timed beside the
    plain K5 launch; then the mean tests per ray on the rays the kernels
    are timed on: phase 9's n_mean rays (K5), phase 3's rays (K2, through
    K5's walk) and K6's timed rays over stress100k (the counting launch
    called directly: intersection_stats raises there, as JAX's does); and
    an estimate of the mean tests per segment of the scene-4 and scene-2
    megakernel frames (K1, ``segment_tests``); and K6's tests per ray on
    the first n_k6_walk of its timed rays (``blocked_walk_tests``)."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import sweep
    rec = {}
    for num in (4, 2):
        scene, sky = rtt.build_scene(num, seed=0, device=dev) \
            if num == 4 else rtt.build_scene(num, device=dev)
        ps = sweep.pack(scene)
        o, d = field_rays(dev, n_check, 17 + num, scene)
        before = _counts()
        got = ic.hit_resolve_counted(ps, o, d)
        c = _counts() - before
        launched = (c["rt_hit_resolve"], c["rt_hit_resolve.stats"])
        want = ic.hit_resolve_counted(ps, o, d, plain=True)
        r = _hit_agreement(got[:12], want[:12])
        r["counts_equal"] = bool(torch.equal(got[12], want[12]))
        r["counts_max_abs_err"] = float((got[12] - want[12]).abs().max())
        r["launched"] = launched
        r["group"] = ic.resolve_group(n_check, ps)
        r["counts_equal_by_group"] = {
            str(g): bool(torch.equal(
                ic.hit_resolve_counted(ps, o, d, _group=g)[12], want[12]))
            for g in GROUP_ARMS}
        o, d = field_rays(dev, n_mean, 7 + num, scene)
        tests = ic.hit_resolve_counted(ps, o, d)[12]
        r["tests_per_ray"] = float(tests.double().mean())
        r["tests_per_ray_max"] = float(tests.max())
        ws = ic.WaveScene(scene, blocked=False)
        r["ms"] = cuda_ms(lambda: ic.hit_resolve_counted(ps, o, d), 5)
        r["k5_ms"] = cuda_ms(lambda: ic.hit_resolve_unit(ws, o, d), 5)
        r["plain_ms"] = cuda_ms(lambda: ic.hit_resolve_counted(
            ps, o, d, plain=True))
        # phase 6's timed frame: 1000x800, 20 spp, 5 bounces
        r["segments_estimate"] = segment_tests(
            dev, scene, 1000, 800, rtt.RenderSettings(
                rays_per_pixel=20, reflect_limit=5,
                antialias=True).with_sky(sky))
        r["brute_force_tests"] = scene.num_spheres + scene.num_triangles
        rec[num] = r
        print(f"phase 14d counting rt_hit_resolve vs plain, scene {num}, "
              f"{n_check} rays; tests per ray over {n_mean}:", json.dumps(r),
              flush=True)
        check_hits(r, f"counting K5 scene {num}")
        check(r["counts_equal"], f"scene {num}: primitive-test counts differ")
        for g, ok in r["counts_equal_by_group"].items():
            check(ok, f"scene {num}: primitive-test counts differ at G {g}")
        check(launched == (1, 1), f"scene {num}: launched {launched}")
    scene, _ = rtt.build_scene(4, seed=0, device=dev)
    o, d = hit_rays(dev, n_mean)
    rec["k2_tests_per_ray"] = float(ic.hit_resolve_counted(
        sweep.pack(scene), o, d)[12].double().mean())
    big, _ = stress_scene(100000)
    big = big.to(dev)
    check(not ic.fits_smem(big), "stress100k fits the SMEM budget")
    o, d = field_rays(dev, n_mean, 12, big)
    tests = ic.hit_resolve_counted(sweep.pack(big), o, d)[12]
    n_walk = min(n_k6_walk, n_mean)
    k6_tests = blocked_walk_tests(ic.WaveScene(big).tables, o[:, :n_walk],
                                  d[:, :n_walk])
    rec["stress100k"] = {"tests_per_ray": float(tests.double().mean()),
                         "tests_per_ray_max": float(tests.max()),
                         "k5_tests_per_ray_first": float(
                             tests[:n_walk].double().mean()),
                         "k6_tests_per_ray": float(k6_tests.double().mean()),
                         "k6_tests_per_ray_max": float(k6_tests.max()),
                         "k6_counted_on": f"the first {n_walk} of K6's "
                                          "timed rays, a plain-torch walk "
                                          "over the blocked tables",
                         "brute_force_tests": big.num_spheres
                         + big.num_triangles}
    print("phase 14d tests per ray: K2 on phase 3's rays "
          f"{rec['k2_tests_per_ray']:.3f}; stress100k, K5's walk over the "
          "resident pools and K6's over the blocked tables, on K6's timed "
          "rays:", json.dumps(rec["stress100k"]), flush=True)
    return rec


def blocked_walk_tests(bt, o, d):
    """The primitive tests of K6's walk per ray, in plain torch: blocks in
    index order, each block's sphere union (if b < sph_blocks), its supers
    and their clusters in index order, then its triangles the same way,
    every gate against the ray's running best t; each entered cluster adds
    its ``leaf`` slots, which the kernel tests. o, d (3, N), unit d ->
    (N,) float32. Measurement only: no kernel arm counts this."""
    import torch

    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import sweep
    best = torch.full((o.shape[1],), sweep.INF, device=o.device)
    tests = torch.zeros_like(best)
    inv = [torch.where(x == 0.0, sweep.INF, torch.reciprocal(x)) for x in d]
    cols = [x[:, None] for x in (*o, *d)]
    for b in range(bt.nblocks):
        for tri in (False, True):
            if b >= (bt.tri_blocks if tri else bt.sph_blocks):
                continue
            block = ic.TRI_BLOCK if tri else ic.SPH_BLOCK
            pool = (bt.trif if tri else bt.sphf)[:, b * block:(b + 1) * block]
            rc, rs = (bt.tc_rows, bt.ts_rows) if tri else (bt.sc_rows,
                                                           bt.ss_rows)
            leaf = bt.tri_leaf if tri else bt.sph_leaf
            cl = (bt.tri_cl if tri else bt.sph_cl)[b * rc:(b + 1) * rc]
            sup = (bt.tri_sup if tri else bt.sph_sup)[b * rs:(b + 1) * rs]
            union = ic._entered(bt.bbox[2 * b + int(tri)], o, inv, best)
            for g in range(rs):
                gate = union & ic._entered(sup[g], o, inv, best)
                if not bool(gate.any()):     # NaN filler rows end here
                    continue
                first, count = int(sup[g, 6]), int(sup[g, 7])
                for c in range(first, first + count):
                    hit = gate & ic._entered(cl[c], o, inv, best)
                    rows = pool[:, c * leaf:(c + 1) * leaf]
                    t = (sweep.triangle_tuv(rows, bt.has_one_way, *cols,
                                            fast_div=False)[0] if tri else
                         sweep.sphere_t(rows, *cols)).amin(dim=1)
                    tests = tests + torch.where(hit, float(leaf), 0.0)
                    best = torch.where(hit & (t < best), t, best)
    return tests


def phase_resilient(dev) -> dict:
    """(e) render_resilient over 3 frames on the card (scene 4, 256x128,
    mega path) with one injected out-of-memory error while rendering frame
    1: one rebuild, the recovered accumulator bitwise equal to an
    uninterrupted run's."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.runtime.elastic import render_resilient
    scene, sky = rtt.build_scene(4, seed=0)
    settings = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                                  antialias=True).with_sky(sky)
    cam = rtt.CameraConfig(width=256, height=128, position=(0.0, 0.5, -6.0))

    def base():
        return rtt.Renderer(scene, cam, settings, seed=0, device=dev)

    ref = base()
    for _ in range(3):
        ref.render_frame(block=True)
    calls = {"n": 0}

    def factory():
        calls["n"] += 1
        r = base()
        if calls["n"] == 1:
            real = r.render_frame

            def flaky(block=False):
                if r.frame_num == 1:
                    raise torch.cuda.OutOfMemoryError(
                        "CUDA out of memory (injected)")
                return real(block=block)
            r.render_frame = flaky
        return r

    with tempfile.TemporaryDirectory() as tmp:
        r = render_resilient(factory, 3, f"{tmp}/elastic.npz",
                             max_retries=2, backoff_s=0.0)
    rec = {"frames": r.frame_num, "factory_calls": calls["n"],
           "bitwise": bool(torch.equal(r.accum, ref.accum)),
           "device": str(r.accum.device)}
    print("phase 14e render_resilient, 3 frames, one injected transient "
          "error, vs an uninterrupted run:", json.dumps(rec), flush=True)
    check(rec["bitwise"] and calls["n"] == 2 and r.frame_num == 3,
          f"recovered run: {rec}")
    return rec


# -- phase 16: multi-device rendering -----------------------------------------

def shard_leg(leg: str, rec: dict) -> dict:
    rec = {"leg": leg, **rec}
    print(f"phase 16{leg[:1]} {leg}:", json.dumps(rec), flush=True)
    return rec


def phase_shard_group(dev, width: int = 1000, height: int = 800,
                      spp: int = 20, frames: int = 3) -> dict:
    """(a) A one-rank NCCL group (``initialize()`` from torchrun's
    environment, RANK=0, WORLD_SIZE=1) renders ``Renderer(sharding=
    pixel_sharding(make_mesh()))`` on scene 4 from bench.py's camera
    through ``render_frames``,
    in turns with the unsharded Renderer (sharded, plain, plain,
    sharded), ``frames`` frames a turn, the film bitwise after each pair;
    the frame ms of both is the collectives' cost at world 1. Counts taken
    before the sharded turns and read after each."""
    import torch
    import torch.distributed as dist

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.parallel import distributed, dryrun, mesh
    dryrun.join_env(0, 1, dryrun.free_port())
    distributed.initialize()
    try:
        scene, sky = rtt.build_scene(4, seed=0)
        settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                      antialias=True).with_sky(sky)
        # bench.py's camera: the main path's view
        cam = rtt.CameraConfig(width=width, height=height)
        placement = mesh.pixel_sharding(mesh.make_mesh())
        rs = rtt.Renderer(scene, cam, settings, seed=0, device=dev,
                          sharding=placement)
        ru = rtt.Renderer(scene, cam, settings, seed=0, device=dev)
        for r in (rs, ru):
            r.render_frame(block=True)   # warm-up, frame 0
        ms = {"sharded": [], "unsharded": []}
        launches, equal = 0, []
        for order in ((rs, ru), (ru, rs)):
            for r in order:
                sharded = r is rs
                before = _counts()
                rec = r.render_frames(frames)
                if sharded:
                    launches += (_counts() - before)["rt_megakernel"]
                ms["sharded" if sharded else "unsharded"].append(
                    rec["frame_ms"] / rec["frames"])
            equal.append(bool(torch.equal(
                torch.as_tensor(distributed.gather_image(rs.accum,
                                                         placement)),
                ru.accum.cpu())))
        out = shard_leg("a one-rank NCCL Renderer", {
            "backend": str(dist.get_backend()), "world": 1,
            "frame": f"scene 4 {width}x{height} {spp} spp 5 bounces",
            "pixpack": rs.settings.pixpack, "frames": rs.frame_num,
            "bitwise": all(equal), "launches": {"rt_megakernel": launches},
            "frame_ms": ms,
            "sharded_over_unsharded": float(np.mean(ms["sharded"])
                                            / np.mean(ms["unsharded"]))})
        check(out["backend"] == "nccl", f"16a: backend {out['backend']}")
        check(out["bitwise"], "16a: the sharded Renderer's film differs")
        check(launches == 2 * frames,
              f"16a: rt_megakernel launched {launches} times")
        return out
    finally:
        dist.destroy_process_group()


def phase_shard_ranks(dev, width: int = 1024, height: int = 1024,
                      spp: int = 20) -> list:
    """(b) The ranks of a mesh in turn on the one card, each through its
    local step (``shard.local_mean`` with its coordinates), then joined
    on the host side of the collective (pixel slices concatenated, sample
    slices averaged): scene 4 from bench.py's camera, mega, 20 spp, 5
    bounces. Pixel mode at
    world 2 and 4, pixpack 1 and 8, bitwise the unsharded frame (whole
    tiles: 256 at pixpack 1, 32 at 8); spp mode at world 2 and hybrid 2x2,
    bitwise the manual slice mean; the scene-4 regen sampler at 256x128
    over 2 ranks (K5), bitwise. Each rank's ms (CUDA events) and the
    max/mean over ranks, the ceiling of pixel mode's speed-up on N cards.
    Rank 1 of world 2 at pixpack 8 (a nonzero tile offset) is also held
    bitwise against ``mega_reference``, the plain K1, on its own slice at
    the offset its step gives it. The launches are those of the ranks'
    local steps alone: the counts are taken just before each rank's
    untimed call and read just after it; the unsharded references, the
    plain check and the timing repeats run outside those windows."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models.camera import (build_camera,
                                                   morton_order,
                                                   primary_rays)
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    from raytracer_tpu_torch.ops.intersect_cuda import WaveScene
    from raytracer_tpu_torch.parallel import shard
    scene, sky = rtt.build_scene(4, seed=0)
    scene = scene.to(dev)
    key = rng.key(0)

    def rays(w, h):
        order = morton_order(w, h)
        o, d = primary_rays(build_camera(rtt.CameraConfig(
            width=w, height=h)), w, h, pixel_order=order, device=dev)
        return torch.as_tensor(order, device=dev), o, d

    def whole(packed, s, idx, o, d, spp_rank=None):
        fkey = rng.frame_key(key if spp_rank is None
                             else rng.fold_in(key, spp_rank), 0)
        return integ.render_sample_mean(packed, s, o, d, fkey, ray_idx=idx)

    launches = collections.Counter(dict.fromkeys(
        ("rt_megakernel",) + WAVE_ENTRIES, 0))

    def counted(call):
        """``call()`` with its launches (``_launches`` from just before it
        to just after it) added to ``launches``."""
        before = _counts()
        out = call()
        launches.update(_launches(before, ("rt_megakernel",) + WAVE_ENTRIES))
        return out

    def ranks(packed, s, idx, o, d, world, spp=None):
        """Every rank's (mean, segs, ms) at pixel world ``world``."""
        out = []
        for r in range(world):
            rows = shard.shard_rows(o.shape[0], r, world)

            def call():
                return shard.local_mean(packed, s, idx[rows], o[rows],
                                        d[rows], 0, key, px=(r, world),
                                        spp=spp)
            mean, segs = counted(call)
            out.append((mean, float(segs), cuda_ms(call, 3)))
        return out

    def plain_rank(packed, s, o, d, r, world):
        """Rank ``r``'s slice through ``mega_reference`` at the tile offset
        its local step gives it: ((N_local, 3) mean, segments, offset)."""
        rows = shard.shard_rows(o.shape[0], r, world)
        n = rows.stop - rows.start
        offset = r * shard.local_tiles(packed, s, n)
        o_p, d_p, seed, kw = mk.mega_inputs(
            packed, s, o[rows].T, d[rows].T, rng.frame_key(key, 0), offset)
        out = mk.mega_reference(packed.packed, packed.mat, o_p, d_p, seed,
                                **kw)
        return (out[:3, :n].T, float(out[3, :n].sum(dtype=torch.float64)),
                offset)

    def load(parts):
        ms = [p[2] for p in parts]
        return {"rank_ms": ms, "max_over_mean": max(ms) / float(np.mean(ms))}

    legs = []
    idx, o, d = rays(width, height)
    ms = mk.MegaScene(scene)
    frame = f"scene 4 {width}x{height} {spp} spp 5 bounces"
    for pixpack in (1, 8):
        s = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                               antialias=True, pixpack=pixpack).with_sky(sky)
        ref, ref_segs = whole(ms, s, idx, o, d)
        unsharded_ms = cuda_ms(lambda: whole(ms, s, idx, o, d), 3)
        for world in (2, 4):
            parts = ranks(ms, s, idx, o, d, world)
            joined = torch.cat([p[0] for p in parts])
            rec = {"frame": frame, "local_tiles": shard.local_tiles(
                       ms, s, o.shape[0] // world),
                   "bitwise": bool(torch.equal(joined, ref)),
                   "segs_equal": sum(p[1] for p in parts) == float(ref_segs),
                   "unsharded_ms": unsharded_ms, **load(parts)}
            if world == 2 and pixpack == 8:
                t0 = time.perf_counter()
                plain, plain_segs, offset = plain_rank(ms, s, o, d, 1, world)
                _sync(dev)
                rec["rank1_vs_plain"] = {
                    "tile_offset": offset,
                    "bitwise": bool(torch.equal(parts[1][0], plain))
                    and parts[1][1] == plain_segs,
                    "max_abs_err": float((parts[1][0] - plain).abs().max()),
                    "plain_ms": (time.perf_counter() - t0) * 1e3}
                rec["bitwise"] = rec["bitwise"] and \
                    rec["rank1_vs_plain"]["bitwise"] and offset > 0
            legs.append(shard_leg(f"b pixel world {world} pixpack {pixpack}",
                                  rec))
    s = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                           antialias=True, pixpack=8).with_sky(sky)
    manual = (whole(ms, s, idx, o, d, 0)[0]
              + whole(ms, s, idx, o, d, 1)[0]) / 2.0
    parts = ranks(ms, s, idx, o, d, 1, spp=(0, 2)) + ranks(
        ms, s, idx, o, d, 1, spp=(1, 2))
    legs.append(shard_leg("b spp world 2", {
        "frame": frame, "bitwise": bool(torch.equal(
            (parts[0][0] + parts[1][0]) / 2.0, manual)), **load(parts)}))
    by_px = [ranks(ms, s, idx, o, d, 2, spp=(q, 2)) for q in (0, 1)]
    joined = torch.cat([(by_px[0][r][0] + by_px[1][r][0]) / 2.0
                        for r in (0, 1)])
    legs.append(shard_leg("b hybrid 2x2", {
        "frame": frame, "bitwise": bool(torch.equal(joined, manual)),
        **load(by_px[0] + by_px[1])}))

    s = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                           antialias=True, sampler="regen").with_sky(sky)
    ws = WaveScene(scene)
    idx, o, d = rays(256, 128)
    ref, ref_segs = whole(ws, s, idx, o, d)
    parts = ranks(ws, s, idx, o, d, 2)
    legs.append(shard_leg("b regen world 2", {
        "frame": f"scene 4 256x128 {spp} spp 5 bounces",
        "bitwise": bool(torch.equal(torch.cat([p[0] for p in parts]), ref)),
        "segs_equal": sum(p[1] for p in parts) == float(ref_segs),
        **load(parts)}))
    legs.append(shard_leg("b launches of the ranks' local steps",
                          dict(launches)))
    for leg in legs[:-1]:
        check(leg["bitwise"] and leg.get("segs_equal", True),
              f"16b {leg['leg']} differs from the unsharded frame")
    # one K1 launch a rank's step: pixel worlds 2 and 4 at two pixpacks,
    # two spp ranks, four hybrid ranks
    check(launches["rt_megakernel"] == 2 * (2 + 4) + 2 + 4
          and launches["rt_hit_resolve"] > 0,
          f"16b: the virtual ranks launched {launches}")
    return legs


def phase_shard_dryrun() -> dict:
    """(c) ``dryrun_multichip(1)``: one NCCL process on the card,
    spawned, running every leg of the dry run."""
    from raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    dryrun_multichip(1, device="cuda")
    return shard_leg("c dryrun_multichip(1) on the card",
                     {"ok": True, "seconds": time.perf_counter() - t0})


def phase_goldens(dev) -> dict:
    """Phase 17: scenes 0-4 at the goldens' settings (48x32, 24 spp, 5
    bounces, key 0; scene 4 at (0, 0.5, -6), seed 0) through
    ``render_sample_mean(sampler="regen")``'s kernel route (rt_wave_rays,
    K5 and rt_wave_bounce), bitwise against the plain route on the same
    inputs, and each PSNR against tests/goldens/scene{n}.npy, judged on scenes 1-4 by
    tests/test_torch_golden.py's bounds. Returns the kernels' launches,
    counted over the kernel-route renders."""
    import pathlib

    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import rng
    from raytracer_tpu_torch.ops.film import psnr
    from raytracer_tpu_torch.ops.intersect_cuda import WaveScene
    goldens = pathlib.Path(__file__).resolve().parent / "tests" / "goldens"
    w, h = GOLDEN_SIZE
    launches = dict.fromkeys(WAVE_ENTRIES, 0)
    out = {}
    for num in range(5):
        pos = (0.0, 0.5, -6.0) if num == 4 else (0.0, 0.0, 0.0)
        scene, sky = rtt.build_scene(num, device=dev,
                                     **({"seed": 0} if num == 4 else {}))
        settings = rtt.RenderSettings(rays_per_pixel=GOLDEN_SPP,
                                      reflect_limit=5,
                                      sampler="regen").with_sky(sky)
        o, d = rtt.primary_rays(rtt.build_camera(rtt.CameraConfig(
            width=w, height=h, position=pos)), w, h, device=dev)
        ws = WaveScene(scene)
        before = _counts()
        mean, segs = integ.render_sample_mean(ws, settings, o, d,
                                              rng.key(0))
        _sync(dev)
        counts = _launches(before)
        launches = {k: launches[k] + counts[k] for k in launches}
        ref, ref_segs = integ.render_sample_mean(ws, settings, o, d,
                                                 rng.key(0), backend="plain")
        img = mean.cpu().numpy().reshape(h, w, 3)
        golden = np.load(goldens / f"scene{num}.npy").astype(np.float32)
        rec = {"bitwise": bool(torch.equal(mean, ref))
               and float(segs) == float(ref_segs),
               "max_abs": float((mean - ref).abs().max()),
               "segments": float(segs),
               "psnr_vs_golden": psnr(np.clip(img, 0, 1),
                                      np.clip(golden, 0, 1)),
               "psnr_min": GOLDEN_PSNR_MIN.get(num), "launches": counts}
        out[f"scene{num}"] = rec
        check(counts["rt_hit_resolve"] > 0
              and counts["rt_wave_rays"] == counts["rt_hit_resolve"]
              and counts["rt_wave_bounce"] == counts["rt_hit_resolve"]
              and set(counts) == set(WAVE_ENTRIES),
              f"golden scene {num}: the kernel route launched {counts}")
    print(f"phase 17 goldens {w}x{h} {GOLDEN_SPP} spp, kernel route vs "
          "plain and PSNR vs tests/goldens:", json.dumps(out), flush=True)
    for name, rec in out.items():
        check(rec["bitwise"], f"golden {name}: kernel route not bitwise "
              "the plain route")
        if rec["psnr_min"] is not None:
            check(rec["psnr_vs_golden"] > rec["psnr_min"],
                  f"golden {name}: {rec['psnr_vs_golden']:.2f} dB <= "
                  f"{rec['psnr_min']} dB")
    return launches


def trace_events(path: str, kernel: str) -> dict:
    """A Chrome trace written by ``Renderer.profile_frame``, read back:
    the window (first event's start to last event's end), the device
    kernels' time, and the device ms and shares of the kernels whose names
    hold ``kernel``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = [e for e in kernels if kernel in e.get("name", "")]
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events)) / 1e3
    device_ms = sum(e["dur"] for e in kernels) / 1e3
    ms = sum(e["dur"] for e in named) / 1e3
    return {"window_ms": window, "device_ms": device_ms,
            "device_events": len(kernels),
            "names": sorted({e["name"] for e in named}),
            "kernel_ms": ms,
            "share_of_window": ms / window if window else None,
            "share_of_device": ms / device_ms if device_ms else None}


def profile_leg(width: int, height: int) -> dict:
    """Phase 18b's body: ``Renderer.profile_frame`` on the bench.py path
    (scene 4, 20 spp, the megakernel) after a warm-up frame, the
    megakernel's launches counted over the profiled frame, and the Chrome
    trace it writes read back (``rt_megakernel`` launches the
    ``megakernel`` kernel)."""
    import torch

    import raytracer_tpu_torch as rtt
    dev = torch.device("cuda", 0)
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    bench = rtt.RenderSettings(rays_per_pixel=20, reflect_limit=5,
                               antialias=True).with_sky(sky)
    r = rtt.Renderer(scene, rtt.CameraConfig(width=width, height=height),
                     bench, seed=0, device=dev)
    r.render_frame(block=True)
    with tempfile.TemporaryDirectory() as tmp:
        before = _counts()
        path = r.profile_frame(f"{tmp}/trace")
        launches = (_counts() - before)["rt_megakernel"]
        prof = trace_events(path, "megakernel")
    r.check_health()
    prof.update(launches=launches, frame=r.frame_num - 1)
    return prof


def phase_profile_frame(width: int = 1000, height: int = 800) -> dict:
    """Phase 18b: ``profile_leg`` in a fresh process. Run this late in
    this long process, a profiler session recorded no device events at
    all; in a fresh process it records them (as the card test does)."""
    import pathlib
    here = pathlib.Path(__file__).resolve().parent
    code = ("import json, chip_smoke; print(json.dumps("
            f"chip_smoke.profile_leg({width}, {height})))")
    run = subprocess.run([sys.executable, "-c", code], cwd=here,
                         capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, "profile_frame process failed: "
          + run.stderr[-2000:])
    prof = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"phase 18b Renderer.profile_frame scene 4 {width}x{height} 20 "
          "spp (the megakernel's device events in its trace):",
          json.dumps(prof), flush=True)
    check(prof["launches"] == 1 and prof["names"],
          f"profile_frame: {prof['launches']} rt_megakernel launches, "
          f"device events {prof['names']}")
    return prof


def phase_trace(dev, width: int = 1000, height: int = 800) -> dict:
    """Phase 18a: ``trace`` on scene 4 at bench.py's camera, one sample,
    5 bounces, through the kernel route (rt_wave_rays, K5 and
    rt_wave_bounce every bounce, replayed from the graph the WaveScene
    caches: the warm-up call captures it; counts taken just before and
    read just after the timed call) against ``backend="plain"`` on the
    same rays and key, bitwise, both timed."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import rng
    from raytracer_tpu_torch.ops.intersect_cuda import WaveScene
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    scene = WaveScene(scene)
    settings = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=5,
                                  antialias=True, sampler="regen"
                                  ).with_sky(sky)
    cam = rtt.CameraConfig(width=width, height=height)
    order = camera_order(width, height, dev)
    o, d = rtt.primary_rays(rtt.build_camera(cam), width, height,
                            pixel_order=order.cpu().numpy(), device=dev)
    key = rng.sample_key(rng.frame_key(rng.key(0), 0), 0)
    rtt.trace(scene, settings, o, d, key, ray_idx=order)   # warm-up
    _sync(dev)
    before = _counts()
    t0 = time.perf_counter()
    rad, segs = rtt.trace(scene, settings, o, d, key, ray_idx=order)
    _sync(dev)
    trace_ms = (time.perf_counter() - t0) * 1e3
    trace_launches = _launches(before)
    t0 = time.perf_counter()
    ref, ref_segs = rtt.trace(scene, settings, o, d, key, ray_idx=order,
                              backend="plain")
    _sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    tr = {"rays": width * height, "bitwise": bool(torch.equal(rad, ref))
          and float(segs) == float(ref_segs),
          "max_abs": float((rad - ref).abs().max()),
          "finite": bool(torch.isfinite(rad).all()),
          "segments": float(segs), "ms": trace_ms, "plain_ms": plain_ms,
          "launches": trace_launches}
    print(f"phase 18a trace scene 4 {width}x{height} 1 spp, kernel route "
          "vs plain:", json.dumps(tr), flush=True)
    check(tr["bitwise"] and tr["finite"], "trace: kernel route not bitwise "
          "the plain route")
    check(trace_launches["rt_hit_resolve"] == 5
          and trace_launches["rt_wave_rays"] == 5
          and trace_launches["rt_wave_bounce"] == 5
          and set(trace_launches) == set(WAVE_ENTRIES),
          f"trace launched {trace_launches}, expected the ray set-up, K5 "
          "and rt_wave_bounce once a bounce")
    return tr


def with_tests(rec: dict, scene, n_items: float, per_item: float,
               extra_ops: float, item: str = "ray") -> dict:
    """``rec``'s bound with the gated tests counted: ``n_items`` rays or
    segments (``item``) times the operations of ``per_item`` tests, plus
    ``extra_ops`` of work done whatever the gates."""
    out = dict(rec)
    out.update(bound(rec["bound_bytes"],
                     n_items * primitive_ops(scene, per_item) + extra_ops))
    out[f"tests_per_{item}"] = per_item
    return out


def phase_parent_turns(parent: str, pairs: int = 2,
                       which: str = "all") -> dict:
    """Phase 15: the paths of ``scripts/k1_groups.py paths --set which``
    (all: K1 and K2 in phases 3, 6, 7, 13 and 14c, K5 and K6 in phases 9,
    10 and 12) timed on the ``parent`` tree and on this checkout in
    ``pairs`` pairs of turns, alternating which tree runs first (parent,
    change, change, parent, ...), one process per turn, so that each tree
    builds and loads its own kernels. Returns {path: {"phase", "metric",
    "parent": [...], "change": [...] (one value a pair), their means,
    medians and interquartile ranges, and "change_better": the pairs in
    which the change was faster}}."""
    import pathlib
    here = pathlib.Path(__file__).resolve().parent
    script = here / "scripts" / "k1_groups.py"
    check(pathlib.Path(parent, "raytracer_tpu_torch").is_dir(),
          f"--parent {parent}: no raytracer_tpu_torch there")
    out: dict = {}
    turns = [(parent, "parent"), (here, "change")]
    for i in range(pairs):
        for tree, label in turns[::1 if i % 2 == 0 else -1]:
            run = subprocess.run(
                [sys.executable, str(script), "paths", "--tree", str(tree),
                 "--label", label, "--set", which], capture_output=True,
                text=True, timeout=900)
            check(run.returncode == 0, f"k1_groups.py paths on {label} "
                  f"failed ({run.returncode}): {run.stderr[-2000:]}")
            for line in run.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                metric = next(m for m in ("fps", "ms", "busy_share",
                                          "frame_ms") if m in rec)
                row = out.setdefault(rec["path"], {
                    "phase": rec["phase"], "metric": metric, "parent": [],
                    "change": []})
                row[label].append(rec[metric])
                check(rec.get("finite", True), f"{label} {rec['path']}: "
                      "non-finite accumulation")
    for path, row in out.items():
        check(len(row["parent"]) == pairs and len(row["change"]) == pairs,
              f"{path}: not timed in every turn")
        for label in ("parent", "change"):
            q1, med, q3 = np.percentile(row[label], [25, 50, 75])
            row.update({f"{label}_mean": float(np.mean(row[label])),
                        f"{label}_median": float(med),
                        f"{label}_iqr": float(q3 - q1)})
        sign = -1.0 if row["metric"] in ("fps", "busy_share") else 1.0
        row["change_better"] = int(sum(
            sign * (c - p) < 0 for p, c in zip(row["parent"], row["change"])))
        print(f"phase 15 parent vs change in turns, phase {row['phase']} "
              f"{path}:", json.dumps(row), flush=True)
    return out


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree of this repository "
                    "(git archive): time its K1 and K2 paths against this "
                    "checkout's in turns (phase 15)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from raytracer_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"phase 1 python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from raytracer_tpu_torch.runtime import loader
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"phase 2 build {time.perf_counter() - t0:.1f} s -> {lib}; "
          + " | ".join(ptxas_summary(build.BUILD_INFO.get("log", "")))
          + f"; native host BVH: {loader.native_available()}", flush=True)
    groups = group_table(dev)
    print("phase 2 rt_megakernel, rt_nearest_hit, rt_hit_resolve and "
          "rt_hit_resolve_blocked arms: resident warps per SM, gate depths "
          "and the rules' G:", json.dumps(groups), flush=True)

    hits_rec = phase_hits(dev, 1 << 20)
    fetch_rec = phase_fetch(dev, 1 << 20)
    for num in (4, 2, 0):
        phase_mega_small(dev, num, 256, 128)
    main_rec = phase_path(dev, 4, 1000, 800, 20)
    slice_rec = phase_path(dev, 2, 1000, 800, 20)
    phase_bench(dev)
    rays_recs = phase_wave_rays(dev)
    k5_rec = phase_k5(dev)
    k6_rec = phase_k6(dev, 1 << 16, 1 << 20)
    samplers = phase_samplers(dev, 256, 128)
    bounce_rec = phase_wave_bounce(dev)
    for cell in FINISHED_CELLS:
        phase_finished_lanes(dev, cell)
    paths = phase_wave_paths(dev)
    temporal = phase_temporal_vs_plain(dev, 256, 128)
    fly = phase_flythrough(dev)
    for num in (4, 2, 0):
        phase_mega_small(dev, num, 256, 128, coherent=True)
    coh_regen = phase_coherent_regen(dev, 256, 128)
    coh_paths = {p["path"]: p for p in phase_coherent_paths(dev)}
    counts = phase_counters(dev, 1 << 16, 1 << 20)
    phase_resilient(dev)
    t16 = time.perf_counter()
    shard_group = phase_shard_group(dev)
    shard_legs = phase_shard_ranks(dev)
    phase_shard_dryrun()
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s", flush=True)
    golden_launches = phase_goldens(dev)
    api = {"trace": phase_trace(dev), "profile": phase_profile_frame()}
    turns = phase_parent_turns(args.parent) if args.parent else {}

    def parent_ms(path):
        """The parent tree's mean on ``path`` (phase 15), or None."""
        return turns[path]["parent_mean"] if path in turns else None
    by_path = {f"scene4_256x128_{s}": r["launches"]
               for s, r in samplers.items()}
    by_path.update({p["path"]: p["launches"] for p in paths})
    by_path["scene4_256x128_regen_coherent"] = coh_regen["launches"]
    for p in ("scene4_regen", "stress100k_regen"):
        by_path[f"{p}_coherent_14c"] = coh_paths[p]["coherent"]["launches"]
    shard_launches = shard_legs[-1]
    by_path["sharded_virtual_ranks"] = {k: shard_launches[k]
                                        for k in WAVE_ENTRIES}
    by_path["goldens_48x32"] = golden_launches
    by_path["trace_scene4_1000x800"] = api["trace"]["launches"]

    def total(kernel):
        return sum(v[kernel] for v in by_path.values())

    def timing(rec, library_ms=None):
        """The contract's timing keys of a phase record, with its
        brute-force count and wrapper time where it has them."""
        out = {"ms": rec["ms"], "plain_ms": rec["plain_ms"],
               "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
               "library_ms": library_ms}
        out.update({k: rec[k] for k in ("plain_ops", "wrapper_ms",
                                        "profiled_ms") if k in rec})
        return out

    import raytracer_tpu_torch as rtt
    scene2, _ = rtt.build_scene(2)
    scene4, _ = rtt.build_scene(4, seed=0)
    # the BVH kernels' bounds with this run's counted tests (phase 14d)
    k1 = with_tests(slice_rec, scene2, slice_rec["timed_segments"],
                    counts[2]["segments_estimate"]["tests_per_segment"],
                    slice_rec["timed_segments"] * OPS_SHADE, "segment")
    k1_s4 = with_tests(main_rec, scene4, main_rec["timed_segments"],
                       counts[4]["segments_estimate"]["tests_per_segment"],
                       main_rec["timed_segments"] * OPS_SHADE, "segment")
    k2 = with_tests(hits_rec, scene4, hits_rec["rays"],
                    counts["k2_tests_per_ray"], 0.0)
    k5 = with_tests(k5_rec[4], scene4, 1 << 20, counts[4]["tests_per_ray"],
                    (1 << 20) * OPS_RESOLVE)
    big = stress_scene(100000)[0]
    k6 = with_tests(k6_rec, big, 1 << 20,
                    counts["stress100k"]["k6_tests_per_ray"],
                    (1 << 20) * OPS_RESOLVE)
    k6_resident_walk = with_tests(k6_rec, big, 1 << 20,
                                  counts["stress100k"]["tests_per_ray"],
                                  (1 << 20) * OPS_RESOLVE)
    wave_paths = {p["path"]: p for p in paths}

    def device_share(path, kernel):
        return wave_paths[path]["profiled_frame"][kernel]

    def coherent_summary(path):
        rec = coh_paths[path]
        return {k: {"frame_ms": float(np.mean(rec[k]["frame_ms"])),
                    "mrays_per_sec": float(np.mean(rec[k]["mrays_per_sec"]))}
                for k in ("per_lane", "coherent")}

    fly_launches = fly["fly"]["launches"]
    temporal_paths = {"flythrough_4k": fly_launches,
                      "temporal_256x128": temporal["launches"]}
    band = fly["gather"]["coherent_band"]
    kernels = [{
        "name": "rt_megakernel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "raytracer_tpu/ops/megakernel.py:370",
        "inlines": ["raytracer_tpu/ops/sweep.py:491",
                    "raytracer_tpu/ops/sweep.py:1170",
                    "raytracer_tpu/ops/megakernel.py:260"],
        "launches": slice_rec["launches"],
        "launches_by_path": {"scene4": main_rec["launches"],
                             "scene2": slice_rec["launches"],
                             "flythrough_4k": fly_launches["rt_megakernel"],
                             "sharded_renderer_world1":
                                 shard_group["launches"]["rt_megakernel"],
                             "sharded_virtual_ranks":
                                 shard_launches["rt_megakernel"],
                             "profile_frame_scene4":
                                 api["profile"]["launches"]},
        "max_abs_err": max(main_rec["vs_plain"]["max_abs"],
                           slice_rec["vs_plain"]["max_abs"]),
        **timing(k1), "tests_per_segment": k1["tests_per_segment"],
        "tests_counted_on": counts[2]["segments_estimate"]["counted_on"],
        "group": slice_rec["group"], "parent_ms": parent_ms("scene2_mega"),
        "parent": args.parent,
        "scene4_ms": main_rec["ms"], "scene4_group": main_rec["group"],
        "scene4_parent_ms": parent_ms("scene4_mega"),
        "scene4_plain_ms": main_rec["plain_ms"],
        "scene4_bound_ms": k1_s4["bound_ms"],
        "scene4_tests_per_segment": k1_s4["tests_per_segment"],
        "profile_frame_scene4": {k: api["profile"][k] for k in (
            "kernel_ms", "share_of_window", "share_of_device")},
        "coherent_launches": {
            p: coh_paths[p]["coherent"]["launches"]["coherent_arm"]
            for p in ("scene4_mega", "stress10k_mega")},
        "coherent_vs_per_lane": {p: coherent_summary(p) for p in (
            "scene4_mega", "stress10k_mega")},
        "resident_warps_per_sm": groups["resident_warps_per_sm"][
            "rt_megakernel"],
        "k2": {"alone_as": "rt_nearest_hit", "ms": hits_rec["ms"],
               "group": hits_rec["group"],
               "parent_ms": parent_ms("rt_nearest_hit_1M_scene4"),
               "ms_by_group": {g: r["ms"]
                               for g, r in hits_rec["by_group"].items()},
               "resident_warps_per_sm": groups["resident_warps_per_sm"][
                   "rt_nearest_hit"],
               "plain_ms": hits_rec["plain_ms"], "bound_ms": k2["bound_ms"],
               "bound_by": k2["bound_by"],
               "tests_per_ray": k2["tests_per_ray"],
               "timed": "1M rays over scene 4"}},
        {"name": "rt_fetch_image", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "raytracer_tpu/ops/megakernel.py:260",
         "launches": slice_rec["image_launches"],
         "launched_as": "inside rt_megakernel (its image branch) on the "
                        "scene-2 path; rt_fetch_image runs it alone",
         "max_abs_err": fetch_rec["max_abs_err"], **timing(fetch_rec),
         "bound_share": fetch_rec["bound_share"],
         "library_call": "none: no one PyTorch call offsets a query into "
                         "its material's rows of a shared plane with a "
                         "truncated, clamped index",
         "timed": "1M queries, a bare launch on prebuilt arguments"},
        {"name": "rt_hit_resolve", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "raytracer_tpu/ops/intersect_pallas.py:60",
         "launches": total("rt_hit_resolve"),
         "launches_by_path": {k: v["rt_hit_resolve"]
                              for k, v in by_path.items()},
         "max_abs_err": max(r["t_abs_max"] for r in k5_rec.values()),
         **timing(k5), "tests_per_ray": k5["tests_per_ray"],
         "group": k5_rec[4]["group"],
         "parent_ms": parent_ms("rt_hit_resolve_1M_scene4"),
         "ms_by_group": {g: r["ms"]
                         for g, r in k5_rec[4]["by_group"].items()},
         "resident_warps_per_sm": groups["resident_warps_per_sm"][
             "rt_hit_resolve"],
         "stress100k_resident": {
             "ms": k6_rec["k5_ms"], "group": k6_rec["k5_group"],
             "parent_ms": parent_ms("rt_hit_resolve_1M_stress100k"),
             "ms_by_group": {g: r["ms"]
                             for g, r in k6_rec["k5_by_group"].items()},
             "tests_per_ray": counts["stress100k"]["tests_per_ray"],
             "bound_ms": k6_resident_walk["bound_ms"],
             "timed": "1M field rays over stress100k's resident pools"},
         "device_share_scene4_regen": device_share(
             "scene4_regen", "hit_resolve_kernel"),
         "coherent_vs_per_lane_scene4_regen": coherent_summary(
             "scene4_regen"),
         "with_stats": {"ms": counts[4]["ms"], "k5_ms": counts[4]["k5_ms"],
                        "plain_ms": counts[4]["plain_ms"],
                        "counts_equal": counts[4]["counts_equal"]
                        and counts[2]["counts_equal"],
                        "scene2_tests_per_ray": counts[2]["tests_per_ray"]},
         "timed": "1M rays over scene 4"},
        {"name": "rt_hit_resolve_blocked", "route": "cuda",
         "source": WAVEFRONT_SOURCE,
         "replaces": "raytracer_tpu/ops/intersect_pallas.py:150",
         "launches": total("rt_hit_resolve_blocked"),
         "launches_by_path": {k: v["rt_hit_resolve_blocked"]
                              for k, v in by_path.items()},
         "max_abs_err": max(k6_rec["t_abs_max"],
                            k6_rec["check_rays"]["t_abs_max"]),
         **timing(k6), "tests_per_ray": k6["tests_per_ray"],
         "tests_counted_on": counts["stress100k"]["k6_counted_on"],
         "group": k6_rec["group"],
         "parent_ms": parent_ms("rt_hit_resolve_blocked_1M_stress100k"),
         "ms_by_group": {g: r["ms"] for g, r in k6_rec["by_group"].items()},
         "resident_warps_per_sm": groups["resident_warps_per_sm"][
             "rt_hit_resolve_blocked"],
         "k5_ms": k6_rec["k5_ms"],
         "device_share_stress100k_regen": device_share(
             "stress100k_regen", "hit_resolve_blocked_kernel"),
         "coherent_vs_per_lane": coherent_summary("stress100k_regen"),
         "timed": "1M rays over stress100k"},
        {"name": "rt_wave_rays", "route": "cuda", "source": RAYS_SOURCE,
         "replaces": "raytracer_tpu/ops/rng.py:75, ops/scatter.py:34 and "
                     "ops/intersect_pallas.py:737 (XLA's fusion before "
                     "the hit kernel, not a TPU kernel)",
         "launches": total("rt_wave_rays"),
         "launches_by_path": {k: v["rt_wave_rays"]
                              for k, v in by_path.items()},
         "max_abs_err": max(r["max_abs_err"] for r in rays_recs.values()),
         **timing(rays_recs[1000 * 800]),
         "bound_ms_int32_rate": rays_recs[1000 * 800]["bound_ms_int32_rate"],
         "ms_1m": rays_recs[1 << 20]["ms"],
         "bound_ms_1m": rays_recs[1 << 20]["bound_ms"],
         "device_share_scene4_regen": device_share(
             "scene4_regen", "wave_rays_kernel"),
         "device_share_scene4_coherent_regen": device_share(
             "scene4_coherent_regen", "wave_rays_kernel"),
         "coherent_arm": {
             **timing(rays_recs[1000 * 800]["coherent"]),
             "bound_share": rays_recs[1000 * 800]["coherent"]["bound_share"],
             "timed": "800,000 lanes, 1024-lane tiles, antialias and "
                      "russian roulette, the tile bundles drawn in the "
                      "kernel"},
         "timed": "800,000 lanes (the 1000x800 regen frames), regen arm "
                  "with antialias and russian roulette"},
        {"name": "rt_wave_bounce", "route": "cuda", "source": BOUNCE_SOURCE,
         "replaces": "raytracer_tpu/ops/integrator.py:59 (XLA's fusion of "
                     ":59-126 and :251-355, not a TPU kernel)",
         "launches": total("rt_wave_bounce"),
         "launches_by_path": {k: v["rt_wave_bounce"]
                              for k, v in by_path.items()},
         "max_abs_err": bounce_rec["max_abs_err"], **timing(bounce_rec),
         "device_share_scene4_regen": device_share(
             "scene4_regen", "wave_bounce_kernel"),
         "timed": f"{bounce_rec['lanes']} regen lanes of scene 4, their "
                  "third bounce"},
        {"name": "rt_camera_rays", "route": "cuda", "source": CAMERA_SOURCE,
         "replaces": "raytracer_tpu/models/camera.py:83 with "
                     "raytracer_tpu/ops/megakernel.py:1189-1202 (XLA's "
                     "fusion in the temporal step, renderer.py:362, not a "
                     "TPU kernel)",
         "launches": fly_launches["rt_camera_rays"],
         "launches_by_path": {k: v["rt_camera_rays"]
                              for k, v in temporal_paths.items()},
         "max_abs_err": fly["rays"]["max_abs_err"], **timing(fly["rays"]),
         "timed": f"the fly-through's {FLY_W}x{FLY_H} camera, pixpack 8, "
                  f"{fly['rays']['lanes']} padded lanes"},
        {"name": "rt_temporal_frame", "route": "cuda", "source": WARP_SOURCE,
         "replaces": "raytracer_tpu/runtime/renderer.py:365 and :369-388 "
                     "(XLA's fusion after K1 in _tstep / _tstep_warp, not a "
                     "TPU kernel; K7's load, warp.py:52, inside its warp "
                     "arm)",
         "launches": fly_launches["rt_temporal_frame"],
         "launches_by_path": {k: v["rt_temporal_frame"]
                              for k, v in temporal_paths.items()},
         "max_abs_err": max(r["max_abs_err"]
                            for r in fly["frame"].values()),
         **timing(fly["frame"]["warp"]),
         "static_arm": timing(fly["frame"]["static"]),
         "timed": f"one {FLY_W}x{FLY_H} frame of the fly-through: the warp "
                  "arm (a move's first frame; static_arm: the others)"},
        {"name": "rt_warp_gather", "route": "cuda", "source": WARP_SOURCE,
         "replaces": "raytracer_tpu/ops/warp.py:52",
         "launches": fly_launches["rt_warp_gather"],
         "fused_into": "rt_temporal_frame",
         "fused_launches": fly_launches["rt_temporal_frame"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in fly["gather"].values()),
         **timing(band, band["library_ms"]),
         "library_call": "torch.index_select(values, 0, idx), values[idx]",
         "timed": f"{FLY_W * FLY_H} queries, the fly-through move's band"}]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
