"""Smoke run of raytracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA card (the
kernels are built for sm_90a, an H100). It builds the CUDA kernels from
``raytracer_tpu_torch/csrc``, holds each against its plain PyTorch version
on the card, drives the main path (scene 4 at 1000x800, 20 spp, 5 bounces,
through ``Renderer``), and times it. Every phase prints one line; any failed
check raises, so the script exits non-zero. It also exits non-zero, before
printing any result, when no CUDA device is available. The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with
their launches on the main path, their error against the plain version and
their times.
"""

from __future__ import annotations

import json
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


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


def camera_rays(width: int, height: int, dev):
    from raytracer_tpu_torch import CameraConfig
    from raytracer_tpu_torch.models.camera import (build_camera,
                                                   morton_order,
                                                   primary_rays)
    cfg = CameraConfig(width=width, height=height)
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


def phase_mega_small(dev, width: int, height: int) -> None:
    """rt_megakernel against mega_reference at a small size, pixpack 1, 8."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    ms = mk.MegaScene(scene)
    settings = rtt.RenderSettings(rays_per_pixel=4, reflect_limit=5,
                                  antialias=True).with_sky(sky)
    o, d = camera_rays(width, height, dev)
    for k in (1, 8):
        stats = mega_vs_plain(ms, settings, o, d,
                              rng.fold_in(rng.key(0), 3), pixpack=k)
        print(f"phase 4 rt_megakernel vs mega_reference {width}x{height} "
              f"spp 4 pixpack {k}:", json.dumps(stats), flush=True)
        check_pixels(stats, f"pixpack {k}")
        check(stats["segs_rel"] <= SEGS_REL_MAX,
              f"pixpack {k}: segments differ by {stats['segs_rel']:.3g}")


def phase_main(dev, width: int, height: int, spp: int) -> dict:
    """The main path: Renderer on scene 4, one warm-up frame + 5 frames."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng
    scene, sky = rtt.build_scene(4, seed=0)
    settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                  antialias=True).with_sky(sky)
    cam = rtt.CameraConfig(width=width, height=height)

    mk.LAUNCHES = 0
    r = rtt.Renderer(scene, cam, settings, seed=0, device=dev)
    r.render_frame(block=True)
    first = r.accum.clone()
    rec = r.render_frames(5)
    launches = mk.LAUNCHES
    r.check_health()
    out = {"pixpack": r.settings.pixpack, "launches": launches,
           "mrays_per_sec": rec["mrays_per_sec"],
           "frame_ms": rec["frame_ms"] / rec["frames"],
           "segments_per_frame": rec["segments"] / rec["frames"]}
    check(launches == 6, f"main path launched rt_megakernel {launches} "
          "times, expected 6 (1 warm-up + 5 frames)")

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
    print(f"phase 5 main path {width}x{height} spp {spp}:", json.dumps(out),
          flush=True)
    print(f"phase 6 one {width}x{height} frame: kernel {out['ms']:.3f} ms, "
          f"mega_reference {plain_ms:.3f} ms", flush=True)
    check_pixels(stats, "main path frame vs mega_reference")
    check(stats["frame_mean_rel"] <= FRAME_MEAN_REL_MAX,
          f"frame-mean radiance differs by {stats['frame_mean_rel']:.3g}")
    check(out["checkpoint_bitwise"], "checkpoint round trip not bitwise")
    check(np.isfinite(out["mrays_per_sec"]) and out["mrays_per_sec"] > 0,
          "no ray rate")
    return out


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

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    regs = [ln.strip() for ln in build.BUILD_INFO.get("log", "").splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"phase 2 build {time.perf_counter() - t0:.1f} s -> {lib}; "
          + " | ".join(regs), flush=True)

    phase_hits(dev, 1 << 20)
    phase_mega_small(dev, 256, 128)
    main_rec = phase_main(dev, 1000, 800, 20)

    kernels = [{
        "name": "rt_megakernel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "raytracer_tpu/ops/megakernel.py:370",
        "inlines": ["raytracer_tpu/ops/sweep.py:491",
                    "raytracer_tpu/ops/sweep.py:1170"],
        "launches": main_rec["launches"],
        "max_abs_err": main_rec["vs_plain"]["max_abs"],
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"]}]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
