"""The megakernel's (K1's) and the nearest hit's (K2's) group sweep, and
their paths on two trees, timed on one CUDA card.

    python scripts/k1_groups.py sweep [--out FILE]
    python scripts/k1_groups.py paths [--tree DIR] [--label NAME] [--out FILE]

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
field), and prints each kernel instance's registers, its resident warps
per SM and the G each rule picks.

``paths`` imports ``raytracer_tpu_torch`` from DIR (default: this
checkout) and times what chip_smoke.py's phases 3, 6, 7, 13 and 14c time
of K1 and K2, through the entry points a user calls: ``rt_nearest_hit`` on
1M rays over scene 4; the scene-4 and scene-2 1000x800, 20 spp paths
through ``Renderer`` (5 frames after a warm-up, and one kernel frame);
one frame of each bench scene; the 4K fly-through (16 moves, each followed
by a frame, one final sync); the coherent scene-4 and stress10k paths.
Run it once per tree in separate processes, in turns (parent, change,
change, parent), to compare two trees on one card: ``chip_smoke.py
--parent DIR`` does that.

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


def sweep(dev) -> None:
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng, sweep as sw
    t0 = time.perf_counter()
    build.build()
    build.load()
    emit({"what": "build", "seconds": time.perf_counter() - t0,
          "ptxas": cs.ptxas_summary(build.BUILD_INFO.get("log", ""))})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit({"what": "resident_warps_per_sm", "sms": sms, **{
        name: {g: build.resident_threads(kind, g) // 32 // sms
               for g in sw.GROUPS}
        for kind, name in ((build.KIND_MEGAKERNEL, "rt_megakernel"),
                           (build.KIND_NEAREST, "rt_nearest_hit"))}})

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


def paths(dev, label: str) -> None:
    import torch

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.ops import megakernel as mk
    from raytracer_tpu_torch.ops import rng, sweep as sw
    card = cs.card_line()

    def emit_path(phase, path, **rec):
        emit({"what": "k1_path", "tree": label, "phase": phase,
              "path": path, **rec, "card": card})

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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("sweep", "paths"))
    p.add_argument("--tree", default=str(ROOT),
                   help="checkout to import raytracer_tpu_torch from")
    p.add_argument("--label", default="change")
    p.add_argument("--out", type=pathlib.Path,
                   help="also append the JSON lines to this file")
    a = p.parse_args()
    global OUT
    OUT = a.out
    sys.path.insert(0, str(pathlib.Path(a.tree).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("k1_groups: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if a.mode == "sweep":
        sweep(dev)
    else:
        paths(dev, a.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
