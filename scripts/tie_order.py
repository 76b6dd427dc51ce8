"""How much a benchmark cell's check hangs on the reference's primitive
order: the check's reference film against the same film with the
reference scene's primitives in the order the port itself built them.

    python3 scripts/tie_order.py --workload spd_tetra6.progressive \\
        --seed <n> --frames <f> [--lanes <l>] [--out PATH]

Run from the root of a checkout, on the card. An exact tie in t goes to
the lower index, in the port's walk and in ``perfbench/pbref`` alike, so
the two agree bitwise only where they order primitives alike. The
configurations' reference files follow the port's numpy BVH arm; where
g++ builds the native host library (``runtime/loader.py``), the port
orders each pool by ``std::nth_element`` instead. This script builds the
configuration's reference scene, then a copy of it permuted into the
order of the port's own scene on this machine (matched primitive by
primitive on their exact rows). It renders the cell's ``Renderer``
(perfbench/pbench/modes.py's) for ``--frames`` frames, untimed: the
frames a run of that seed drove, warm-up included, as its output's
``frames`` + ``warmup_frames``. Then it replays the check over both
references at the check's lanes (``--lanes``: another count of them).

One JSON line: the arm that built the port's scene, the primitives each
order moved, the checked pixels, how many of them differ between the two
references, ``ref_gap`` (the widest difference), and the program's
``film_gap`` against each. Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(x):
    """Each row of a 2-d float tensor as bytes, for an exact match."""
    return [bytes(r) for r in x.contiguous().cpu().numpy()]


def _permutation(ref_rows, port_rows) -> list:
    """Indices into ``ref_rows`` in the order ``port_rows`` lists them;
    port rows the reference lacks (padding) are skipped."""
    where = {r: i for i, r in enumerate(ref_rows)}
    if len(where) != len(ref_rows):
        raise ValueError("the reference holds two equal primitives")
    perm = [where[r] for r in port_rows if r in where]
    if sorted(perm) != list(range(len(ref_rows))):
        raise ValueError("the port's primitives are not the reference's")
    return perm


def port_order(ref, scene):
    """``ref`` (a ``pbref.scene.Scene``) with its spheres and triangles in
    the order of the port's ``scene``, and how many of each moved."""
    import torch
    ps = _permutation(_rows(ref.sph), _rows(torch.cat(
        [scene.sph_center, scene.sph_radius[:, None]], dim=1)))
    pt = _permutation(_rows(ref.tri_w), _rows(torch.cat(
        [scene.tri_wu, scene.tri_wv, scene.tri_ww], dim=1)))
    ps_t = torch.as_tensor(ps, dtype=torch.long, device=ref.sph.device)
    pt_t = torch.as_tensor(pt, dtype=torch.long, device=ref.sph.device)
    prim = torch.cat([ref.prim[:ref.n_sph][ps_t],
                      ref.prim[ref.n_sph:][pt_t]])
    out = dataclasses.replace(
        ref, sph=ref.sph[ps_t], tri_w=ref.tri_w[pt_t],
        tri_n=ref.tri_n[pt_t], tri_cull=ref.tri_cull[pt_t],
        tri_uv=ref.tri_uv[pt_t], prim=prim)
    moved = (sum(i != j for i, j in enumerate(ps)),
             sum(i != j for i, j in enumerate(pt)))
    return out, moved


def reference_film(cell, sc, seed: int, frames: int, lanes, dev):
    """The check's reference film (pbench/check.py ``progressive``) over
    scene ``sc`` at the check's lanes, float32."""
    import torch
    from pbench import check, spec
    from pbref import render, wave
    rs = spec.render_settings(cell)
    sky = rs["sky_colour"] if cell.config["settings"]["use_sky"] \
        else (0.0, 0.0, 0.0)
    kw = dict(spp=rs["rays_per_pixel"], limit=rs["reflect_limit"],
              antialias=rs["antialias"], sky=sky)
    t = cell.traffic
    tiles, slots, k = lanes
    args = (sc.to(dev, torch.float32), cell.config["camera"], t["width"],
            t["height"])
    if check.SAMPLERS[t["sampler"]] == "wave":
        pos = render.lane_positions(tiles, slots, k)
        return wave.progressive(
            *args, seed=seed & 0xFFFFFFFF, frames=frames,
            positions=pos[pos < t["width"] * t["height"]], **kw)
    ref, pix = render.progressive(*args, seed=seed & 0xFFFFFFFF,
                                  frames=frames, tiles=tiles, slots=slots,
                                  k=k, **kw)
    return ref[pix >= 0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True,
                    help="frames the run drove, warm-up included")
    ap.add_argument("--lanes", type=int,
                    help="lane slots checked (default: the cell's)")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "perfbench")]
    import torch
    from pbench import check, modes, spec
    from pbref import render
    from raytracer_tpu_torch.runtime import loader
    from raytracer_tpu_torch.runtime.renderer import Renderer

    dev = torch.device("cuda", 0)
    cell = spec.load(ROOT, args.workload)
    if args.lanes:
        cell = dataclasses.replace(cell, check={**cell.check,
                                                "lanes": args.lanes})
    line = {"workload": args.workload, "seed": args.seed,
            "frames": args.frames, "lanes": cell.check["lanes"],
            "arm": "native" if loader.native_available() else "numpy"}
    scene, use_sky = modes.program_scene(cell, dev)
    r = Renderer(scene, modes.camera_of(cell, cell.config["camera"]),
                 modes.settings_of(cell, use_sky),
                 seed=args.seed & 0xFFFFFFFF, device=dev)
    for _ in range(args.frames):
        r.render_frame(block=True)
    lanes = modes.check_lanes(cell, args.seed, dev)
    pos = render.lane_positions(*lanes)
    film = r.accum[pos[pos < cell.traffic["width"]
                       * cell.traffic["height"]]].cpu()
    ref = spec.reference_scene(cell, "cpu")
    native, moved = port_order(ref, scene)
    del r, scene
    torch.cuda.empty_cache()
    films = {name: reference_film(cell, sc, args.seed, args.frames, lanes,
                                  dev).cpu()
             for name, sc in (("reference", ref), ("port_order", native))}
    differ = (films["reference"] != films["port_order"]).any(dim=1)
    line.update(moved_spheres=moved[0], moved_triangles=moved[1],
                pixels=int(differ.numel()), pixels_differ=int(differ.sum()),
                ref_gap=check._gap(films["reference"], films["port_order"]))
    line.update({f"film_gap_{k}": check._gap(film, v)
                 for k, v in films.items()})
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
