"""The group sweeps of the walking kernels (K1 megakernel, K2 nearest hit,
K5 and K6 wavefront hits), and their paths on two trees, timed on one
CUDA card.

    python scripts/k1_groups.py sweep [--out FILE]
    python scripts/k1_groups.py paths [--tree DIR] [--label NAME]
                                      [--set all|k1k2|wavefront|temporal]
                                      [--out FILE]
    python scripts/k1_groups.py pairs --parent DIR [--pairs 10]
                                      [--set wavefront] [--out FILE]

Run from the root of a checkout on a machine with one NVIDIA card. The
scenes, rays, cameras and timers are chip_smoke.py's.

``sweep`` times ``rt_megakernel`` with CUDA events at every group size G
(1, 2, 4, 8), in turns (forward, then backward), each G's output held
bitwise against G = 1's: on the 1000x800, 20 spp, 5-bounce frames of
scene 4, scene 2 and stress10k (pixpack 8, the Renderer's auto choice;
stress10k at pixpack 1 too) and of stress100k at 4 spp (pixpack 8 and 1),
on one 3840x2160 1 spp frame of scene 4 (the fly-through's shape), on the
cube (1280x720, 200 spp) and monkey (1920x1080, 100 spp) bench frames at
pixpack 1, and on small 256x128 frames of scene 4, scene 2 and stress10k
(pixpack 8: one tile, 4096 lane slots; pixpack 1: 32,768). It times
``rt_nearest_hit`` the same way on 65,536 and 1M rays over scene 4
(chip_smoke.py's phase-3 rays), scene 2 and stress10k (rays inside each
field); ``rt_hit_resolve`` (K5) on 65,536 and 1M field rays over scenes 4
and 2 and stress100k's resident pools, and ``rt_hit_resolve_blocked``
(K6) on 65,536, 262,144 and 1M field rays over stress100k (phases 9 and
10's rays), each G bitwise with G = 1; and prints each kernel instance's
registers, its resident warps per SM and the G each rule picks.
``--set`` limits it to K1 and K2 (k1k2) or K5 and K6 (wavefront).

``paths`` imports ``raytracer_tpu_torch`` from DIR (default: this
checkout) and times, through the entry points a user calls, what
chip_smoke.py's phases 3, 6, 7, 13 and 14c time of K1 and K2 (k1k2):
``rt_nearest_hit`` on 1M rays over scene 4; the scene-4 and scene-2
1000x800, 20 spp paths through ``Renderer`` (5 frames after a warm-up,
and one kernel frame); one frame of each bench scene; the 4K fly-through
(16 moves, each followed by a frame, one final sync: fps; a static and a
warp frame in CUDA events; the busy share of a static frame, a warp frame
and the fly window under torch.profiler; ``--set temporal`` times only
these); the coherent
scene-4 and stress10k paths; and what phases 9, 10 and 12 time of K5 and
K6 (wavefront): K5 on phase 9's 1M rays over scene 4, K6 and K5 on phase
10's 1M stress100k field rays, the scene-4 (20 spp), stress100k (4 spp)
and earth2048 (20 spp) regen paths through ``Renderer`` at 1000x800, the
first two per lane and with coherent sampling (5 frames after a warm-up;
then one frame under torch.profiler: the device ms of K5 or K6 in it,
the frame's device ms and device ops, and the device's busy share), and
phase 18a's
``trace`` (scene 4, 1000x800, one sample; 5 calls after a warm-up, one
more under torch.profiler). Run it once per tree in separate processes, in turns, to
compare two trees on one card: ``pairs`` does that (``chip_smoke.py
--parent DIR`` runs two pairs of every path), printing each path's values,
medians and interquartile ranges and the pairs the change won.

Each measurement is one JSON line on stdout, also appended to FILE when
``--out`` names one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (this checkout's, before --tree)

OUT: pathlib.Path | None = None   # --out


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT is not None:
        OUT.parent.mkdir(parents=True, exist_ok=True)
        with OUT.open("a") as f:
            f.write(line + "\n")


def sweep_frames(rtt):
    """(name, (scene, sky), width, height, spp, camera position, repeats,
    pixpack) of every K1 frame of the sweep."""
    scene4 = rtt.build_scene(4, seed=0)
    scene2 = rtt.build_scene(2)
    stress, big = cs.stress_scene(10000), cs.stress_scene(100000)
    origin, field = (0.0, 0.0, 0.0), (0.0, 1.0, -4.0)
    from raytracer_tpu_torch.models import bench_scenes
    return (("scene4", scene4, 1000, 800, 20, origin, 3, 8),
            ("scene2", scene2, 1000, 800, 20, origin, 3, 8),
            ("stress10k", stress, 1000, 800, 20, field, 1, 8),
            ("stress10k", stress, 1000, 800, 20, field, 1, 1),
            ("stress100k", big, 1000, 800, 4, field, 1, 8),
            ("stress100k", big, 1000, 800, 4, field, 1, 1),
            ("scene4_4k", scene4, 3840, 2160, 1, (0.0, 0.5, -6.0), 3, 8),
            ("cube", bench_scenes.cube_scene(), 1280, 720, 200, origin, 1,
             1),
            ("monkey", bench_scenes.monkey_light_scene(), 1920, 1080, 100,
             origin, 1, 1),
            ("scene4_small", scene4, 256, 128, 20, origin, 10, 8),
            ("scene4_small", scene4, 256, 128, 20, origin, 10, 1),
            ("scene2_small", scene2, 256, 128, 20, origin, 10, 8),
            ("scene2_small", scene2, 256, 128, 20, origin, 10, 1),
            ("stress10k_small", stress, 256, 128, 20, field, 3, 8))


def in_turns(variants, run, repeats: int) -> dict:
    """CUDA-event ms of run(v) for each variant, forward then backward."""
    times = {v: [] for v in variants}
    for order in (variants, variants[::-1]):
        for v in order:
            times[v].append(cs.cuda_ms(lambda: run(v), repeats))
    return times


def sweep(dev, which: str) -> None:
    import torch

    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.ops import sweep as sw
    t0 = time.perf_counter()
    build.build()
    build.load()
    emit({"what": "build", "seconds": time.perf_counter() - t0,
          "ptxas": cs.ptxas_summary(build.BUILD_INFO.get("log", ""))})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit({"what": "resident_warps_per_sm", "sms": sms, **{
        name: {g: build.resident_threads(kind, g) // 32 // sms
               for g in sw.GROUPS} for name, kind in cs.ARM_KINDS}})
    if which != "wavefront":
        sweep_k1k2(dev)
    if which != "k1k2":
        sweep_wavefront(dev)


def sweep_k1k2(dev) -> None:
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng, sweep as sw
    for name, (scene, sky), width, height, spp, pos, reps, pixpack in \
            sweep_frames(rtt):
        ms = mk.MegaScene(scene.to(dev))
        settings = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                                      antialias=True).with_sky(sky)
        o, d = cs.camera_rays(width, height, dev, position=pos)
        o_p, d_p, seed, kw = mk.mega_inputs(
            ms, settings, o, d, rng.frame_key(rng.key(0), 0), pixpack=pixpack)
        slots = o_p.shape[1] // pixpack

        def run(group):
            return mk._mega_cuda(ms.packed, ms.mat, o_p, d_p, seed, **kw,
                                 _group=group)
        outs = {g: run(g) for g in sw.GROUPS}    # warm-up and the outputs
        equal = {g: bool(torch.equal(x, outs[1])) for g, x in outs.items()}
        segs = float(outs[1][3].double().sum())
        del outs                      # the timed launches reuse their memory
        times = in_turns(sw.GROUPS, run, reps)
        emit({"what": "k1_sweep", "scene": name, "width": width,
              "height": height, "spp": spp, "pixpack": pixpack,
              "lane_slots": slots, "gate_depth": sw.gate_depth(ms.packed),
              "rule_group": mk.mega_group(slots, ms.packed),
              "segments": segs, "ms": times,
              "ms_mean": {g: float(np.mean(t)) for g, t in times.items()},
              "bitwise_vs_g1": equal, "card": cs.card_line()})

    for name, (scene, _) in (("scene4", rtt.build_scene(4, seed=0)),
                             ("scene2", rtt.build_scene(2)),
                             ("stress10k", cs.stress_scene(10000))):
        scene = scene.to(dev)
        ps = sw.pack(scene)
        for n in (1 << 16, 1 << 20):
            o, d = cs.hit_rays(dev, n) if name == "scene4" else \
                cs.field_rays(dev, n, 3, scene)
            outs = {g: sw.nearest_hit(ps, o, d, _group=g) for g in sw.GROUPS}
            times = in_turns(sw.GROUPS, lambda g: sw.nearest_hit(
                ps, o, d, _group=g), 10)
            emit({"what": "k2_sweep", "scene": name, "rays": n,
                  "gate_depth": sw.gate_depth(ps),
                  "rule_group": sw.nearest_group(n, ps), "ms": times,
                  "ms_mean": {g: float(np.mean(t)) for g, t in times.items()},
                  "bitwise_vs_g1": {g: all(bool(torch.equal(a, b)) for a, b
                                           in zip(x, outs[1]))
                                    for g, x in outs.items()},
                  "card": cs.card_line()})


def sweep_wavefront(dev) -> None:
    """K5 and K6 at every G on phases 9 and 10's rays, in turns."""
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import sweep as sw
    big = cs.stress_scene(100000)[0].to(dev)
    cases = [("k5", name, ic.WaveScene(scene.to(dev), blocked=False), seed)
             for name, scene, seed in (
                 ("scene4", rtt.build_scene(4, seed=0)[0], 11),
                 ("scene2", rtt.build_scene(2)[0], 9),
                 ("stress100k", big, 12))]
    cases.append(("k6", "stress100k", ic.WaveScene(big), 12))
    for kernel, name, ws, seed in cases:
        sizes = (1 << 16, 1 << 18, 1 << 20) if kernel == "k6" else \
            (1 << 16, 1 << 20)
        for n in sizes:
            o, d = cs.field_rays(dev, n, seed, ws.scene)
            outs = {g: ic.hit_resolve_unit(ws, o, d, _group=g)
                    for g in sw.GROUPS}
            times = in_turns(sw.GROUPS, lambda g: ic.hit_resolve_unit(
                ws, o, d, _group=g), 3 if name == "stress100k" else 10)
            rule = ic.blocked_group(n) if ws.blocked else \
                ic.resolve_group(n, ws.packed)
            emit({"what": f"{kernel}_sweep", "scene": name, "rays": n,
                  "gate_depth": 3 if ws.blocked else sw.gate_depth(
                      ws.packed),
                  "rule_group": rule, "ms": times,
                  "ms_mean": {g: float(np.mean(t)) for g, t in times.items()},
                  "bitwise_vs_g1": {g: all(bool(torch.equal(a, b)) for a, b
                                           in zip(x, outs[1]))
                                    for g, x in outs.items()},
                  "card": cs.card_line()})


def paths(dev, label: str, which: str) -> None:
    card = cs.card_line()

    def emit_path(phase, path, **rec):
        emit({"what": "k1_path", "tree": label, "phase": phase,
              "path": path, **rec, "card": card})
    if which == "temporal":
        paths_temporal(dev, emit_path)
        return
    if which != "wavefront":
        paths_k1k2(dev, emit_path)
    if which != "k1k2":
        paths_wavefront(dev, emit_path)


def paths_wavefront(dev, emit_path) -> None:
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import intersect_cuda as ic
    from raytracer_tpu_torch.ops import rng
    scene, _ = rtt.build_scene(4, seed=0, device=dev)
    ws = ic.WaveScene(scene)
    o, d = cs.field_rays(dev, 1 << 20, 11, scene)
    ic.hit_resolve_unit(ws, o, d)
    emit_path("9", "rt_hit_resolve_1M_scene4",
              ms=cs.cuda_ms(lambda: ic.hit_resolve_unit(ws, o, d), 10))
    big = cs.stress_scene(100000)[0].to(dev)
    o, d = cs.field_rays(dev, 1 << 20, 12, big)
    for path, ws in (("rt_hit_resolve_blocked_1M_stress100k",
                      ic.WaveScene(big)),
                     ("rt_hit_resolve_1M_stress100k",
                      ic.WaveScene(big, blocked=False))):
        ic.hit_resolve_unit(ws, o, d)
        emit_path("10", path,
                  ms=cs.cuda_ms(lambda: ic.hit_resolve_unit(ws, o, d), 3))
    from raytracer_tpu_torch.models.scenes import procedural_earth_texture
    scene4, stress = rtt.build_scene(4, seed=0), cs.stress_scene(100000)
    for path, (scene, sky), spp, pos, coherent in (
            ("scene4_regen", scene4, 20, (0.0, 0.0, 0.0), False),
            ("scene4_coherent_regen", scene4, 20, (0.0, 0.0, 0.0), True),
            ("stress100k_regen", stress, 4, (0.0, 1.0, -4.0), False),
            ("stress100k_coherent_regen", stress, 4, (0.0, 1.0, -4.0),
             True),
            ("earth2048_regen", rtt.build_scene(
                2, earth_image=procedural_earth_texture(1024)), 20,
             (0.0, 0.0, 0.0), False)):
        s = rtt.RenderSettings(rays_per_pixel=spp, reflect_limit=5,
                               antialias=True, sampler="regen",
                               coherent=coherent).with_sky(sky)
        r = rtt.Renderer(scene, rtt.CameraConfig(width=1000, height=800,
                                                 position=pos),
                         s, seed=0, device=dev)
        r.render_frame(block=True)
        stat = r.render_frames(5)
        emit_path("12", path, frame_ms=stat["frame_ms"] / stat["frames"],
                  mrays_per_sec=stat["mrays_per_sec"],
                  finite=bool(torch.isfinite(r.accum).all()))
        kernel = "hit_resolve_blocked_kernel" if r.packed_scene.blocked \
            else "hit_resolve_kernel"
        prof = cs.device_shares(lambda: r.render_frame(block=True),
                                (kernel, "tile_randoms_kernel",
                                 "wave_rays_kernel"))
        emit_path("12", f"{path}_{kernel}_device",
                  ms=prof[kernel]["device_ms"],
                  device_ms=prof["device_ms"], window_ms=prof["window_ms"])
        emit_path("12", f"{path}_device", ms=prof["device_ms"],
                  device_ops=prof["device_ops"],
                  kernel_ms={k: prof[k]["device_ms"] for k in (
                      kernel, "tile_randoms_kernel", "wave_rays_kernel")})
        emit_path("12", f"{path}_busy", busy_share=prof["busy_share"],
                  device_ms=prof["device_ms"], window_ms=prof["window_ms"],
                  host_kernel_launches=prof["host_kernel_launches"],
                  host_graph_launches=prof["host_graph_launches"])
    # phase 18a's trace: scene 4, bench.py's camera, one sample, its
    # WaveScene built once (a tree that caches graphs replays after the
    # warm-up call)
    scene, sky = rtt.build_scene(4, seed=0, device=dev)
    ws = ic.WaveScene(scene)
    s = rtt.RenderSettings(rays_per_pixel=1, reflect_limit=5,
                           antialias=True, sampler="regen").with_sky(sky)
    order = cs.camera_order(1000, 800, dev)
    o, d = rtt.primary_rays(rtt.build_camera(rtt.CameraConfig(
        width=1000, height=800)), 1000, 800,
        pixel_order=order.cpu().numpy(), device=dev)
    key = rng.sample_key(rng.frame_key(rng.key(0), 0), 0)

    def one_trace():
        rad, _ = rtt.trace(ws, s, o, d, key, ray_idx=order)
        torch.cuda.synchronize()
        return rad
    one_trace()
    t0 = time.perf_counter()
    for _ in range(5):
        rad = one_trace()
    emit_path("18a", "trace_scene4_1000x800",
              ms=(time.perf_counter() - t0) * 1e3 / 5,
              finite=bool(torch.isfinite(rad).all()))
    prof = cs.device_shares(one_trace, ())
    emit_path("18a", "trace_scene4_1000x800_busy",
              busy_share=prof["busy_share"], device_ms=prof["device_ms"],
              window_ms=prof["window_ms"])


def paths_k1k2(dev, emit_path) -> None:
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng, sweep as sw

    scene, _ = rtt.build_scene(4, seed=0, device=dev)
    ps = sw.pack(scene)
    o, d = cs.hit_rays(dev, 1 << 20)
    sw.nearest_hit(ps, o, d)
    emit_path("3", "rt_nearest_hit_1M_scene4",
              ms=cs.cuda_ms(lambda: sw.nearest_hit(ps, o, d), 10))

    for num in (4, 2):
        scene, sky = rtt.build_scene(num, seed=0) if num == 4 else \
            rtt.build_scene(num)
        s = rtt.RenderSettings(rays_per_pixel=20, reflect_limit=5,
                               antialias=True).with_sky(sky)
        r = rtt.Renderer(scene, rtt.CameraConfig(width=1000, height=800), s,
                         seed=0, device=dev)
        r.render_frame(block=True)
        stat = r.render_frames(5)
        fkey = rng.frame_key(r.base_key, 0)
        emit_path("6", f"scene{num}_mega", frame_ms=stat["frame_ms"]
                  / stat["frames"], mrays_per_sec=stat["mrays_per_sec"],
                  ms=cs.cuda_ms(lambda: mk.render_sample_mean_mega(
                      r._mega, r.settings, r._o.T, r._d.T, fkey), 3),
                  finite=bool(torch.isfinite(r.accum).all()))

    for entry in cs.BENCH:
        _, _, frame, _, _, _ = cs.bench_frame(dev, entry)
        frame()
        emit_path("7", entry[0], ms=cs.cuda_ms(frame, 2))

    paths_temporal(dev, emit_path)

    for name, (scene, sky), pos, frames in (
            ("scene4_mega_coherent", rtt.build_scene(4, seed=0),
             (0.0, 0.0, 0.0), 5),
            ("stress10k_mega_coherent", cs.stress_scene(10000),
             (0.0, 1.0, -4.0), 2)):
        s = rtt.RenderSettings(rays_per_pixel=20, reflect_limit=5,
                               antialias=True, coherent=True).with_sky(sky)
        r = rtt.Renderer(scene, rtt.CameraConfig(width=1000, height=800,
                                                 position=pos),
                         s, seed=0, device=dev)
        r.render_frame(block=True)
        stat = r.render_frames(frames)
        emit_path("14c", name, frame_ms=stat["frame_ms"] / stat["frames"],
                  mrays_per_sec=stat["mrays_per_sec"],
                  finite=bool(torch.isfinite(r.accum).all()))


def paths_temporal(dev, emit_path) -> None:
    """Phase 13's fly-through: fps over FLY_MOVES moves each followed by a
    frame (one final sync), a static and a warp frame in CUDA events
    (three of each, alternating; their mean), and the fly window's busy
    share, device ops a frame and device ms by kernel under
    torch.profiler (``chip_smoke.fly_profile_leg``, its own Renderer)."""
    import torch

    import raytracer_tpu_torch as rtt
    scene, settings = cs.fly_settings()
    r = rtt.Renderer(scene, cs.fly_camera(0, cs.FLY_W, cs.FLY_H), settings,
                     seed=0, device=dev, temporal=True)
    r.render_frame(block=True)
    r.move_camera(cs.fly_camera(0, cs.FLY_W, cs.FLY_H))
    r.render_frame(block=True)
    t0 = time.perf_counter()
    for i in range(cs.FLY_MOVES):
        r.move_camera(cs.fly_camera(i, cs.FLY_W, cs.FLY_H))
        r.render_frame(block=(i == cs.FLY_MOVES - 1))
    dt = time.perf_counter() - t0
    emit_path("13", "flythrough_4k", fps=cs.FLY_MOVES / dt,
              frame_ms=dt / cs.FLY_MOVES * 1e3,
              finite=bool(torch.isfinite(r.accum).all()))
    static, moving = [], []
    for k in range(3):
        static.append(cs.cuda_ms(lambda: r.render_frame()))
        cam = cs.fly_camera(cs.FLY_MOVES + k, cs.FLY_W, cs.FLY_H)
        moving.append(cs.cuda_ms(lambda: (r.move_camera(cam),
                                          r.render_frame())))
    emit_path("13", "flythrough_4k_static_frame", ms=float(np.mean(static)),
              all_ms=static)
    emit_path("13", "flythrough_4k_warp_frame", ms=float(np.mean(moving)),
              all_ms=moving)
    del r
    prof = cs.fly_profile_leg()
    for leg in ("static", "warp", "fly"):
        p = prof[leg]
        emit_path("13", f"flythrough_4k_{leg}_busy",
                  busy_share=p["busy_share"], device_ms=p["device_ms"],
                  window_ms=p["window_ms"], device_ops=p["device_ops"],
                  host_kernel_launches=p["host_kernel_launches"],
                  kernel_ms={k: p[k]["device_ms"] for k in cs.TEMPORAL_NAMES},
                  device_kernels=p["device_kernels"])


def pairs(parent: str, n: int, which: str) -> None:
    turns = cs.phase_parent_turns(parent, pairs=n, which=which)
    for path, row in turns.items():
        emit({"what": "pairs", "path": path, **row,
              "card": cs.card_line()})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("sweep", "paths", "pairs"))
    p.add_argument("--tree", default=str(ROOT),
                   help="checkout to import raytracer_tpu_torch from")
    p.add_argument("--label", default="change")
    p.add_argument("--set", dest="which", default="all",
                   choices=("all", "k1k2", "wavefront", "temporal"),
                   help="which kernels' sweeps or paths (temporal: the "
                        "fly-through's paths only)")
    p.add_argument("--parent", help="pairs: the earlier tree (git archive)")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--out", type=pathlib.Path,
                   help="also append the JSON lines to this file")
    a = p.parse_args()
    global OUT
    OUT = a.out
    if a.mode == "sweep" and a.which == "temporal":
        p.error("the temporal set has paths, no sweep")
    if a.mode == "pairs":
        if a.parent is None:
            p.error("pairs needs --parent")
        pairs(a.parent, a.pairs, a.which)
        return 0
    sys.path.insert(0, str(pathlib.Path(a.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("k1_groups: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if a.mode == "sweep":
        sweep(dev, a.which)
    else:
        paths(dev, a.label, a.which)
    return 0


if __name__ == "__main__":
    sys.exit(main())
