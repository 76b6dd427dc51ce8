"""Smoke run of raytracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA card (the
kernels are built for sm_90a, an H100). It builds the CUDA kernels from
``raytracer_tpu_torch/csrc``, holds each against its plain PyTorch version
on the card (``rt_nearest_hit``, ``rt_fetch_image``, and ``rt_megakernel``
on scenes 4, 2 and 0), drives two paths through ``Renderer`` at 1000x800,
20 spp, 5 bounces and times them: the bench.py path (scene 4) and the
image-texture path (scene 2, the 256x512 earth), then times one frame of
each bench scene of benchmarks/suite.py through the kernel.

Then the wavefront samplers: ``rt_lane_randoms`` (1M lanes), K5
``rt_hit_resolve`` (1M rays over scenes 4 and 2) and K6
``rt_hit_resolve_blocked`` (stress100k) against their plain versions, one
``Renderer`` frame of each sampler (regen, scan, rebin, lanesort) against
the plain route with rebin and lanesort bitwise equal to regen, and three
regen paths through ``Renderer`` at 1000x800, 5 bounces: scene 4 at 20 spp
(K5), stress100k at 4 spp (K6) and the 1024x2048 earth at 20 spp (K5 + the
atlas gather), each with its first frame against the plain route at
256x128.

Every phase prints one line; any failed check raises, so the script exits
non-zero. It also exits non-zero, before printing any result, when no CUDA
device is available. The last line is ``{"ok": true, "device": {...}}``;
the line before it lists the kernels with their launches on the paths,
their error against the plain version and their times.
"""

from __future__ import annotations

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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def ptxas_summary(log: str) -> list:
    """'kernel: registers, spills' per entry function of nvcc's -v log."""
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            mangled = m.group(1)
            name = next((k for k in (
                "hit_resolve_blocked_kernel", "hit_resolve_kernel",
                "nearest_hit_kernel", "fetch_image_kernel",
                "lane_randoms_kernel", "megakernel") if k in mangled),
                mangled)
        elif "spill" in ln or "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


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


def phase_hits(dev, n_rays: int) -> dict:
    """rt_nearest_hit against the plain nearest hit on numpy-seeded rays."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import sweep
    scene, _ = rtt.build_scene(4, seed=0, device=dev)
    ps = sweep.pack(scene)
    g = np.random.default_rng(1)
    o = np.stack([g.uniform(-6, 6, n_rays), g.uniform(-1.5, 3.0, n_rays),
                  g.uniform(-2, 11, n_rays)]).astype(np.float32)
    d = g.standard_normal((3, n_rays)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = torch.as_tensor(o, device=dev)
    d = torch.as_tensor(d, device=dev)
    got = sweep.nearest_hit(ps, o, d)
    want = sweep.nearest_hit_reference(ps, o, d)
    same = got[1] == want[1]
    mismatch = float((~same).float().mean())
    t_g, t_w = got[0][same], want[0][same]
    t_rel = float(((t_g - t_w).abs() / t_w.abs().clamp(min=1.0)).max())
    fields_equal = all(bool(torch.equal(got[i][same], want[i][same]))
                       for i in range(4, 9))
    ms = cuda_ms(lambda: sweep.nearest_hit(ps, o, d), 5) if \
        dev.type == "cuda" else float("nan")
    plain_ms = cuda_ms(lambda: sweep.nearest_hit_reference(ps, o, d)) if \
        dev.type == "cuda" else float("nan")
    rec = {"rays": n_rays, "code_mismatch": mismatch, "t_rel_max": t_rel,
           "winner_params_equal": fields_equal,
           "hit_share": float((want[0] < sweep.INF).float().mean()),
           "ms": ms, "plain_ms": plain_ms}
    print("phase 3 rt_nearest_hit vs plain:", json.dumps(rec), flush=True)
    check(mismatch <= HIT_CODE_MISMATCH_MAX,
          f"winner code mismatch {mismatch} > {HIT_CODE_MISMATCH_MAX}")
    check(t_rel <= HIT_T_REL_MAX, f"hit t rel err {t_rel} > {HIT_T_REL_MAX}")
    check(fields_equal, "winner parameters differ where the winner agrees")
    return rec


def phase_fetch(dev, n: int) -> dict:
    """rt_fetch_image (K4 alone) against the plain fetch, bitwise, on
    numpy-seeded queries over a plane holding the library's earth (256x512,
    1024 packed rows) and a 1024x2048 procedural earth (16,384 rows)."""
    import torch

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
    rec = {"queries": n, "img_rows": ms.img_rows,
           "layout": [list(x[1:]) for x in scene.img_layout],
           "bitwise": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max()),
           "ms": cuda_ms(lambda: mk.fetch_image(ms, u, v, mid), 20),
           "plain_ms": cuda_ms(plain, 5)}
    print("phase 4 rt_fetch_image vs plain:", json.dumps(rec), flush=True)
    check(rec["bitwise"], "rt_fetch_image differs from the plain fetch")
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
    """One kernel frame against one plain frame on the same inputs."""
    from raytracer_tpu_torch.ops import megakernel as mk
    mean, segs, depth = mk.render_sample_mean_mega(
        ms, settings, o, d, frame_key, want_depth=True, pixpack=pixpack)
    o_p, d_p, seed, kw = mk.mega_inputs(ms, settings, o, d, frame_key,
                                        pixpack=pixpack)
    ref = mk.mega_reference(ms.packed, ms.mat, o_p, d_p, seed, **kw)
    n = o.shape[1]
    stats = pixel_diff(mean, ref[:3, :n])
    segs_ref = float(ref[3, :n].double().sum())
    stats["segs_rel"] = abs(float(segs) - segs_ref) / segs_ref
    hit_k, hit_r = depth < mk.INF, ref[4, :n] < mk.INF
    stats["depth_hit_mismatch"] = float((hit_k != hit_r).float().mean())
    stats["frame_mean_rel"] = abs(float(mean.mean()) - float(
        ref[:3, :n].mean())) / float(ref[:3, :n].mean())
    return stats


def phase_mega_small(dev, num: int, width: int, height: int) -> None:
    """rt_megakernel against mega_reference on scene ``num`` at a small
    size, pixpack 1 and 8."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    scene, sky = rtt.build_scene(num, device=dev)
    ms = mk.MegaScene(scene)
    settings = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                                  antialias=True).with_sky(sky)
    o, d = camera_rays(width, height, dev)
    for k in (1, 8):
        stats = mega_vs_plain(ms, settings, o, d,
                              rng.fold_in(rng.key(0), 3), pixpack=k)
        print(f"phase 5 rt_megakernel vs mega_reference scene {num} "
              f"{width}x{height} spp 4 pixpack {k}:", json.dumps(stats),
              flush=True)
        check_pixels(stats, f"scene {num} pixpack {k}")
        check(stats["segs_rel"] <= SEGS_REL_MAX,
              f"scene {num} pixpack {k}: segments differ by "
              f"{stats['segs_rel']:.3g}")


def phase_path(dev, num: int, width: int, height: int, spp: int) -> dict:
    """One path: Renderer on scene ``num``, one warm-up frame + 5 frames,
    with the launch counts set to 0 just before and read just after."""
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
    mk.LAUNCHES = mk.IMAGE_LAUNCHES = mk.FETCH_LAUNCHES = 0
    r.render_frame(block=True)
    first = r.accum.clone()
    rec = r.render_frames(5)
    launches, image_launches = mk.LAUNCHES, mk.IMAGE_LAUNCHES
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
    fkey = rng.frame_key(rng.key(0), 0)
    o_p, d_p, seed, kw = mk.mega_inputs(r._mega, r.settings, r._o.T,
                                        r._d.T, fkey)
    n = cam.num_pixels
    t0 = time.perf_counter()
    ref = mk.mega_reference(r._mega.packed, r._mega.mat, o_p, d_p, seed,
                            **kw)
    _sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    stats = pixel_diff(first, ref[:3, :n].T)
    stats["frame_mean_rel"] = abs(float(first.mean()) - float(
        ref[:3, :n].mean())) / float(ref[:3, :n].mean())
    out.update(vs_plain=stats, plain_ms=plain_ms)

    # one full-size frame through the kernel, timed with CUDA events
    def one_kernel_frame():
        mk.render_sample_mean_mega(r._mega, r.settings, r._o.T, r._d.T,
                                   fkey)
    out["ms"] = cuda_ms(one_kernel_frame, 3) if dev.type == "cuda" else \
        float("nan")

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
          f"{out['ms']:.3f} ms, mega_reference {plain_ms:.3f} ms",
          flush=True)
    check_pixels(stats, f"scene {num} path frame vs mega_reference")
    check(stats["frame_mean_rel"] <= FRAME_MEAN_REL_MAX,
          f"frame-mean radiance differs by {stats['frame_mean_rel']:.3g}")
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


def phase_bench(dev) -> list:
    """One timed frame of each bench scene through the kernel, at the
    Renderer's auto pixpack (8 at spp <= 32, else 1)."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models import bench_scenes
    from raytracer_tpu_torch.models.scenes import procedural_earth_texture
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    recs = []
    for name, fn, kw, width, height, spp, pos in BENCH:
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
        res = {}

        def frame():
            res["out"] = mk.render_sample_mean_mega(
                ms, settings, o, d, rng.frame_key(rng.key(0), 0), pixpack=k)
        kernel_ms = cuda_ms(frame)
        mean, segs = res["out"]
        rec = {"scene": name, "spheres": scene.num_spheres,
               "triangles": scene.num_triangles, "img_rows": ms.img_rows,
               "pixpack": k, "build_s": build_s, "frame_ms": kernel_ms,
               "segments": float(segs),
               "mrays_per_sec": float(segs) / kernel_ms / 1e3,
               "finite": bool(torch.isfinite(mean).all()),
               "mean_radiance": float(mean.mean())}
        print("phase 7 bench frame:", json.dumps(rec), flush=True)
        check(rec["finite"], f"{name}: non-finite radiance")
        check(rec["segments"] > 0, f"{name}: no segments traced")
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


def phase_lane_randoms(dev, n: int) -> dict:
    """rt_lane_randoms against its plain version on n lanes: the per-lane
    keys of a frame, random samples and bounces, with the russian-roulette
    draw."""
    import torch

    from raytracer_tpu_torch.ops import rng
    g = np.random.default_rng(6)
    keys = rng.per_ray_keys(rng.frame_key(rng.key(0), 0),
                            torch.arange(n, device=dev))
    s = torch.as_tensor(g.integers(0, 20, n).astype(np.int32), device=dev)
    b = torch.as_tensor(g.integers(0, 5, n).astype(np.int32), device=dev)
    got = torch.cat([x.reshape(-1, n) for x in rng.lane_randoms(
        keys, s, b, with_rr=True)])
    want = rng.lane_randoms_reference(keys, s, b, with_rr=True)
    uni = [0, 1, 2, 6, 7]
    rec = {"lanes": n, "uniforms_bitwise": bool(torch.equal(got[uni],
                                                            want[uni])),
           "normals_bitwise": bool(torch.equal(got[3:6], want[3:6])),
           "normals_equal_share": float((got[3:6] == want[3:6]).float()
                                        .mean()),
           "max_abs_err": float((got - want).abs().max()),
           "ms": cuda_ms(lambda: rng.lane_randoms(keys, s, b, True), 20),
           "plain_ms": cuda_ms(lambda: rng.lane_randoms_reference(
               keys, s, b, True), 3)}
    print("phase 8 rt_lane_randoms vs plain:", json.dumps(rec), flush=True)
    check(rec["uniforms_bitwise"], "rt_lane_randoms uniforms differ")
    check(rec["normals_bitwise"],
          f"rt_lane_randoms normals differ: {rec['normals_equal_share']} "
          f"equal, max |d| {rec['max_abs_err']}")
    return rec


def phase_k5(dev, n: int) -> dict:
    """K5 (rt_hit_resolve) against the plain K5 on n rays over scenes 4
    and 2; timed on scene 4."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    recs = {}
    for num in (4, 2):
        scene, _ = rtt.build_scene(num, seed=0, device=dev) if num == 4 \
            else rtt.build_scene(num, device=dev)
        ws = ic.WaveScene(scene)
        check(not ws.blocked, f"scene {num} routed to K6")
        o, d = field_rays(dev, n, 7 + num, scene)
        got = ic.hit_resolve_unit(ws, o, d)
        rec = _hit_agreement(got, ic.hit_resolve_unit(ws, o, d, plain=True))
        rec["ms"] = cuda_ms(lambda: ic.hit_resolve_unit(ws, o, d), 5)
        rec["plain_ms"] = cuda_ms(
            lambda: ic.hit_resolve_unit(ws, o, d, plain=True))
        print(f"phase 9 rt_hit_resolve (K5) vs plain, scene {num}, {n} "
              "rays:", json.dumps(rec), flush=True)
        check_hits(rec, f"K5 scene {num}")
        recs[num] = rec
    return recs


def phase_k6(dev, n_check: int, n_time: int) -> dict:
    """K6 (rt_hit_resolve_blocked) on stress100k against the plain K6 and
    against K5, first on n_check rays inside the field, then on the n_time
    rays it is timed on (about the ~800k rays a K6 launch gets on the
    stress100k path): the timed runs' outputs are the ones checked."""
    import torch

    from raytracer_tpu_torch.models import bench_scenes
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    scene, _ = bench_scenes.stress_10k_scene(num=100000, seed=1)
    scene = scene.to(dev)
    wb = ic.WaveScene(scene)
    check(wb.blocked, "stress100k not routed to K6 by fits_smem")
    wr = ic.WaveScene(scene, blocked=False)

    def against_plain_and_k5(got, plain, k5, n):
        rec = _hit_agreement(got, plain)
        differ = got[1] != k5[1]
        rec.update(rays=n, vs_k5_code_mismatch=int(differ.sum()),
                   vs_k5_mismatch_ties_only=torch.equal(got[0][differ],
                                                        k5[0][differ]))
        return rec

    o, d = field_rays(dev, n_check, 11, scene)
    rec = against_plain_and_k5(ic.hit_resolve_unit(wb, o, d),
                               ic.hit_resolve_unit(wb, o, d, plain=True),
                               ic.hit_resolve_unit(wr, o, d), n_check)
    rec["blocks"] = wb.tables.nblocks
    o, d = field_rays(dev, n_time, 12, scene)
    out = {}

    def run(name, ws, plain=False):
        def fn():
            out[name] = ic.hit_resolve_unit(ws, o, d, plain=plain)
        return fn
    rec["ms"] = cuda_ms(run("k6", wb), 3)
    rec["k5_ms"] = cuda_ms(run("k5", wr), 3)
    rec["plain_ms"] = cuda_ms(run("plain", wb, plain=True))
    rec["timed"] = against_plain_and_k5(out["k6"], out["plain"], out["k5"],
                                        n_time)
    print("phase 10 rt_hit_resolve_blocked (K6) vs plain K6 and K5, "
          "stress100k:", json.dumps(rec), flush=True)
    for r, n in ((rec, n_check), (rec["timed"], n_time)):
        check_hits(r, f"K6 vs plain K6 on {n} rays")
        check(r["vs_k5_mismatch_ties_only"],
              f"K6 and K5 pick other winners at other distances on {n} rays")
    return rec


def phase_samplers(dev, width: int, height: int) -> dict:
    """One frame of each wavefront sampler through Renderer on the card
    (scene 4, 4 spp), counts set to 0 just before and read just after;
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
        _zero_counts()
        r.render_frame(block=True)
        launches = _wave_counts()
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
              and launches["rt_lane_randoms"] > 0,
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


def _wave_counts():
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import rng
    return {"rt_hit_resolve": ic.LAUNCHES,
            "rt_hit_resolve_blocked": ic.BLOCKED_LAUNCHES,
            "rt_lane_randoms": rng.LAUNCHES}


def _zero_counts() -> None:
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    ic.LAUNCHES = ic.BLOCKED_LAUNCHES = rng.LAUNCHES = 0
    mk.LAUNCHES = mk.IMAGE_LAUNCHES = mk.FETCH_LAUNCHES = 0


def phase_wave_path(dev, name: str, scene, sky, spp: int, pos,
                    width=1000, height=800, check_size=(256, 128)) -> dict:
    """One regen path through Renderer: a warm-up frame and 5 frames,
    counts set to 0 just before and read just after; then its first frame
    at check_size through the kernel route against the plain route."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import integrator as integ
    from raytracer_tpu_torch.ops import rng
    settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                  antialias=True,
                                  sampler="regen").with_sky(sky)
    cam = rtt.CameraConfig(width=width, height=height, position=pos)
    r = rtt.Renderer(scene, cam, settings, seed=0, device=dev)
    _zero_counts()
    r.render_frame(block=True)
    rec = r.render_frames(5)
    launches = _wave_counts()
    r.check_health()
    out = {"path": name, "spp": spp, "blocked": r.packed_scene.blocked,
           "launches": launches,
           "frame_ms": rec["frame_ms"] / rec["frames"],
           "mrays_per_sec": rec["mrays_per_sec"],
           "segments_per_frame": rec["segments"] / rec["frames"]}
    hit_kernel = "rt_hit_resolve_blocked" if out["blocked"] else \
        "rt_hit_resolve"
    check(launches[hit_kernel] > 0 and launches["rt_lane_randoms"] > 0,
          f"{name}: the path launched {launches}")

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
    return out


def camera_order(width: int, height: int, dev):
    import torch

    from raytracer_tpu_torch.models.camera import morton_order
    return torch.as_tensor(morton_order(width, height), device=dev)


def phase_wave_paths(dev) -> list:
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.models import bench_scenes
    from raytracer_tpu_torch.models.scenes import procedural_earth_texture
    paths = []
    scene, sky = rtt.build_scene(4, seed=0)
    paths.append(phase_wave_path(dev, "scene4_regen", scene, sky, 20,
                                 (0.0, 0.0, 0.0)))
    scene, sky = bench_scenes.stress_10k_scene(num=100000, seed=1)
    paths.append(phase_wave_path(dev, "stress100k_regen", scene, sky, 4,
                                 (0.0, 1.0, -4.0)))
    scene, sky = rtt.build_scene(2,
                                 earth_image=procedural_earth_texture(1024))
    paths.append(phase_wave_path(dev, "earth2048_regen", scene, sky, 20,
                                 (0.0, 0.0, 0.0)))
    return paths


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
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

    phase_hits(dev, 1 << 20)
    fetch_rec = phase_fetch(dev, 1 << 20)
    for num in (4, 2, 0):
        phase_mega_small(dev, num, 256, 128)
    main_rec = phase_path(dev, 4, 1000, 800, 20)
    slice_rec = phase_path(dev, 2, 1000, 800, 20)
    phase_bench(dev)
    lane_rec = phase_lane_randoms(dev, 1 << 20)
    k5_rec = phase_k5(dev, 1 << 20)
    k6_rec = phase_k6(dev, 1 << 16, 1 << 20)
    samplers = phase_samplers(dev, 256, 128)
    paths = phase_wave_paths(dev)
    by_path = {f"scene4_256x128_{s}": r["launches"]
               for s, r in samplers.items()}
    by_path.update({p["path"]: p["launches"] for p in paths})

    def total(kernel):
        return sum(v[kernel] for v in by_path.values())

    kernels = [{
        "name": "rt_megakernel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "raytracer_tpu/ops/megakernel.py:370",
        "inlines": ["raytracer_tpu/ops/sweep.py:491",
                    "raytracer_tpu/ops/sweep.py:1170",
                    "raytracer_tpu/ops/megakernel.py:260"],
        "launches": slice_rec["launches"],
        "launches_by_path": {"scene4": main_rec["launches"],
                             "scene2": slice_rec["launches"]},
        "max_abs_err": max(main_rec["vs_plain"]["max_abs"],
                           slice_rec["vs_plain"]["max_abs"]),
        "ms": slice_rec["ms"], "plain_ms": slice_rec["plain_ms"],
        "scene4_ms": main_rec["ms"], "scene4_plain_ms": main_rec["plain_ms"]},
        {"name": "rt_fetch_image", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "raytracer_tpu/ops/megakernel.py:260",
         "launches": slice_rec["image_launches"],
         "launched_as": "inside rt_megakernel (its image branch) on the "
                        "scene-2 path; rt_fetch_image runs it alone",
         "max_abs_err": fetch_rec["max_abs_err"], "ms": fetch_rec["ms"],
         "plain_ms": fetch_rec["plain_ms"]},
        {"name": "rt_hit_resolve", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "raytracer_tpu/ops/intersect_pallas.py:60",
         "launches": total("rt_hit_resolve"),
         "launches_by_path": {k: v["rt_hit_resolve"]
                              for k, v in by_path.items()},
         "max_abs_err": max(r["t_abs_max"] for r in k5_rec.values()),
         "ms": k5_rec[4]["ms"], "plain_ms": k5_rec[4]["plain_ms"],
         "timed": "1M rays over scene 4"},
        {"name": "rt_hit_resolve_blocked", "route": "cuda",
         "source": WAVEFRONT_SOURCE,
         "replaces": "raytracer_tpu/ops/intersect_pallas.py:150",
         "launches": total("rt_hit_resolve_blocked"),
         "launches_by_path": {k: v["rt_hit_resolve_blocked"]
                              for k, v in by_path.items()},
         "max_abs_err": max(k6_rec["t_abs_max"],
                            k6_rec["timed"]["t_abs_max"]),
         "ms": k6_rec["ms"],
         "plain_ms": k6_rec["plain_ms"], "k5_ms": k6_rec["k5_ms"],
         "timed": "1M rays over stress100k"},
        {"name": "rt_lane_randoms", "route": "cuda",
         "source": WAVEFRONT_SOURCE,
         "replaces": "raytracer_tpu/ops/rng.py:75 (XLA, not a TPU kernel)",
         "launches": total("rt_lane_randoms"),
         "launches_by_path": {k: v["rt_lane_randoms"]
                              for k, v in by_path.items()},
         "max_abs_err": lane_rec["max_abs_err"], "ms": lane_rec["ms"],
         "plain_ms": lane_rec["plain_ms"], "timed": "1M lanes"}]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
