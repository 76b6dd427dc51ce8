"""CLI entry point: ``python -m raytracer_tpu_torch [command] [options]``.

Port of ``raytracer_tpu/__main__.py``: ``render``, ``convert-textures``
and ``compare`` with the JAX CLI's flags and defaults, except that
``--device`` (default ``cuda``) replaces ``--backend``: the port's
Renderer always takes the kernel route, on the card unless ``--device
cpu`` asks for the plain versions. ``--coherent`` renders with
tile-shared scatter sampling; ``--retries N`` with ``--checkpoint``
supervises the frame loop (runtime/elastic.py). ``--shard pixel|spp|
hybrid`` renders over every rank of a process group started from the
environment, one process per rank (``torchrun``: NCCL on the cards,
gloo with ``--device cpu``); rank 0 writes the outputs.

    python -m raytracer_tpu_torch render --scene 4 --temporal --orbit 0.02
    python -m raytracer_tpu_torch render --scene 1 --temporal --interactive
    python -m raytracer_tpu_torch render --scene 4 --coherent --frames 4 \
        --retries 3 --checkpoint run.npz
    torchrun --nproc-per-node 4 -m raytracer_tpu_torch render --scene 4 \
        --shard pixel --frames 8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_tpu_torch",
        description="progressive Monte-Carlo path tracer on PyTorch + CUDA",
    )
    sub = p.add_subparsers(dest="cmd")

    r = sub.add_parser("render", help="render a scene progressively")
    r.add_argument("--scene", type=int, default=0,
                   help="test scene number 0-4 (src/main.cu:100-122)")
    r.add_argument("--width", type=int, default=1000)
    r.add_argument("--height", type=int, default=800)
    r.add_argument("--spp", type=int, default=100,
                   help="rays per pixel per frame")
    r.add_argument("--bounces", type=int, default=5, help="reflect limit")
    r.add_argument("--frames", type=int, default=None,
                   help="progressive frames (0 = until Ctrl-C/quit; "
                        "default 1, or run-until-quit with --interactive)")
    r.add_argument("--no-antialias", action="store_true")
    r.add_argument("--sampler",
                   choices=("auto", "mega", "regen", "rebin", "lanesort",
                            "scan"),
                   default="auto")
    r.add_argument("--coherent", action="store_true",
                   help="tile-shared scatter sampling: unchanged per-pixel "
                        "marginals, pixels of a tile scatter alike "
                        "(structured intra-tile noise at low spp)")
    r.add_argument("--device", default="cuda",
                   help="torch device to render on: cuda (the CUDA "
                        "kernels) or cpu (their plain PyTorch versions)")
    r.add_argument("--gamma", type=float, default=None)
    r.add_argument("--fix-exit-ior", action="store_true")
    r.add_argument("--emissive-terminates", action="store_true")
    r.add_argument("--russian-roulette", type=int, default=0, metavar="N",
                   help="unbiased path termination after N bounces "
                        "(0 = off, reference-faithful)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--cam-pos", type=float, nargs=3, default=None)
    r.add_argument("--cam-rot", type=float, nargs=3, default=None,
                   help="Euler XYZ rotation, radians")
    r.add_argument("--fov", type=float, default=60.0)
    r.add_argument("--out", type=str, default="render.png")
    r.add_argument("--view", action="store_true",
                   help="live display (matplotlib window if available)")
    r.add_argument("--interactive", action="store_true",
                   help="SDL window with keyboard fly-through (WASD/RF "
                        "move, arrows look, Q quits; best with --temporal "
                        "so moves warp history instead of restarting)")
    r.add_argument("--move-speed", type=float, default=0.25,
                   help="--interactive: units per frame per held move key")
    r.add_argument("--checkpoint", type=str, default=None)
    r.add_argument("--resume", type=str, default=None)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--retries", type=int, default=0,
                   help="with --checkpoint: survive this many transient "
                        "device failures by rebuilding the renderer and "
                        "restoring the last checkpoint (runtime/elastic.py; "
                        "bitwise identical to an uninterrupted run)")
    r.add_argument("--stats", type=str, default=None,
                   help="JSONL stats sink path")
    r.add_argument("--spans", type=str, default=None,
                   help="JSONL path for the frame loop's host spans "
                        "(utils/trace.py), written when the render ends")
    r.add_argument("--temporal", action="store_true",
                   help="temporal accumulation: camera moves re-project "
                        "history instead of restarting")
    r.add_argument("--orbit", type=float, default=0.0,
                   help="with --temporal: rotate the camera this many "
                        "radians per frame around Y (fly-through demo)")
    r.add_argument("--shard", choices=("none", "pixel", "spp", "hybrid"),
                   default="none",
                   help="multi-device strategy over every rank of the "
                        "process group (torchrun): 'pixel' shards pixel "
                        "slices (no steady-state collectives), 'spp' the "
                        "sample budget (one all-reduce of the means a "
                        "frame), 'hybrid' both over a (world/2, 2) mesh")

    c = sub.add_parser("convert-textures",
                       help="pack a directory of images into a texture "
                            "library (.npz)")
    c.add_argument("src_dir")
    c.add_argument("out", nargs="?", default="textures.npz")

    q = sub.add_parser("compare",
                       help="PSNR between two renders (the BASELINE.json "
                            "fidelity metric)")
    q.add_argument("image_a")
    q.add_argument("image_b")
    return p


def cmd_render(args) -> int:
    if args.shard == "none":
        return _render(args, None)
    if args.interactive or args.view:
        raise SystemExit("--interactive and --view show the frames of one "
                         "process; drop --shard")
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel import distributed, mesh
    distributed.initialize(device=args.device)
    try:
        world = dist.get_world_size()
        if args.shard == "hybrid":
            if world % 2:
                raise SystemExit("--shard hybrid needs an even device count "
                                 f"(got {world})")
            grid = mesh.make_mesh_2d(world // 2, 2)
        else:
            grid = mesh.make_mesh()
        return _render(args, mesh.pixel_sharding(grid))
    finally:
        dist.destroy_process_group()


def _write_logs(args, renderer) -> None:
    """The ``--stats`` and ``--spans`` files, when asked for."""
    from raytracer_tpu_torch.utils import trace
    if args.stats:
        renderer.write_stats(args.stats)
    if args.spans:
        trace.enable(False)
        trace.write_jsonl(args.spans, trace.take())


def _render(args, sharding) -> int:
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.runtime.viewer import run_render_loop
    from raytracer_tpu_torch.utils import trace

    # under sharding rank 0 speaks for the group
    speaks = sharding is None or sharding.mesh.rank == 0
    if args.spans and speaks:
        trace.enable()
    scene, use_sky = rtt.build_scene(args.scene, device=args.device)
    settings = rtt.RenderSettings(
        reflect_limit=args.bounces,
        rays_per_pixel=args.spp,
        antialias=not args.no_antialias,
        sampler=args.sampler,
        coherent=True if args.coherent else None,
        gamma=args.gamma,
        fix_exit_ior=args.fix_exit_ior,
        emissive_terminates=args.emissive_terminates,
        russian_roulette=args.russian_roulette,
    ).with_sky(use_sky)

    cam_kwargs = dict(width=args.width, height=args.height,
                      fov_deg=args.fov)
    if args.cam_pos is not None:
        cam_kwargs["position"] = tuple(args.cam_pos)
    elif args.scene == 4:
        cam_kwargs["position"] = (0.0, 0.5, -6.0)  # scene 4 needs distance
    if args.cam_rot is not None:
        cam_kwargs["x_rot"], cam_kwargs["y_rot"], cam_kwargs["z_rot"] = \
            args.cam_rot
    camera = rtt.CameraConfig(**cam_kwargs)

    def make_renderer():
        # a fresh renderer per call: render_resilient rebuilds through this
        # after a transient device failure
        return rtt.Renderer(scene, camera, settings, seed=args.seed,
                            device=args.device, sharding=sharding,
                            shard_mode=args.shard if sharding else "pixel",
                            temporal=args.temporal)

    # the supervised (--retries) loop builds its renderers through its
    # factory; every other path builds one up front
    resilient = bool(args.retries and args.checkpoint
                     and not args.interactive
                     and not (args.temporal and args.orbit))
    if args.retries and not resilient and speaks:
        reason = ("--retries needs --checkpoint" if not args.checkpoint else
                  "--retries does not supervise the interactive/orbit loops")
        print(f"warning: retries inactive ({reason})", file=sys.stderr)
    if resilient and args.view:
        print("warning: --view has no effect with --retries "
              "(the supervised loop is headless)", file=sys.stderr)

    renderer = None
    if not resilient:
        renderer = make_renderer()
        if args.resume:
            renderer.load_checkpoint(args.resume)

    if args.interactive:
        from raytracer_tpu_torch.runtime.interactive import run_interactive
        # an unset --frames means run until quit; move_camera resets
        # frame_num, so the loop's own count is the only true total
        n_frames = run_interactive(
            renderer, max_frames=0 if args.frames is None else args.frames,
            move_speed=args.move_speed, out_path=args.out)
        _write_logs(args, renderer)
        print(f"wrote {args.out} ({n_frames} frames)")
        return 0

    move = None
    if args.temporal and args.orbit:
        def move(frame_i):
            renderer.move_camera(dataclasses.replace(
                camera, y_rot=camera.y_rot + args.orbit * frame_i))

    frames = 1 if args.frames is None else args.frames
    if resilient:
        import numpy as np

        from raytracer_tpu_torch.runtime.elastic import render_resilient

        def factory():
            r = make_renderer()
            if args.resume and not os.path.exists(args.checkpoint):
                r.load_checkpoint(args.resume)
            return r

        # --frames counts ADDITIONAL frames (run_render_loop's meaning);
        # render_resilient takes a TOTAL, so offset by what the resume
        # source holds. 0 stays "until interrupted".
        start = 0
        for src in (args.checkpoint, args.resume):
            if src and os.path.exists(src):
                with np.load(src) as data:
                    start = int(data["frame_num"])
                break
        renderer = render_resilient(
            factory, start + frames if frames else 0, args.checkpoint,
            checkpoint_every=args.checkpoint_every or 1,
            max_retries=args.retries, quiet=not speaks)
        renderer.save_png(args.out)
    else:
        run_render_loop(renderer, frames=frames, out_path=args.out,
                        display=args.view, checkpoint=args.checkpoint,
                        checkpoint_every=args.checkpoint_every,
                        quiet=not speaks, per_frame=move)
    if speaks:
        _write_logs(args, renderer)
        print(f"wrote {args.out} ({renderer.frame_num} frames, "
              f"{renderer.frame_num * settings.rays_per_pixel} spp)")
    return 0


def cmd_convert(args) -> int:
    from raytracer_tpu_torch.utils.image import convert_textures
    n = convert_textures(args.src_dir, args.out)
    print(f"packed {n} textures into {args.out}")
    return 0


def cmd_compare(args) -> int:
    from raytracer_tpu_torch.ops.film import psnr
    from raytracer_tpu_torch.utils.image import load_image
    a = load_image(args.image_a)
    b = load_image(args.image_b)
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}")
        return 1
    print(json.dumps({"psnr_db": round(psnr(a, b), 2)}))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "convert-textures":
        return cmd_convert(args)
    if args.cmd == "compare":
        return cmd_compare(args)
    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
