"""Which order of the squares ``torch.linalg.vector_norm`` sums on the card.

    python scripts/norm_order.py

Run from the root of a checkout on a machine with one NVIDIA card. For
the primary rays of 18 poses of the 4K fly-through (chip_smoke.py's
``fly_camera``), bench.py's 1000x800 camera, one 1000x800 camera moved
back and a 130x70 film, it takes the unnormalised directions
``tl + du * x + dv * y - pos`` as ``models/camera.py::primary_rays``
builds them and counts the pixels where ``vector_norm`` differs from each
way of adding the three squares: in the plain orders (each product and
sum rounded) and with fused multiply-adds (emulated in float64, whose
one rounding to float32 can differ from a true FMA in rare ties). The
order that differs nowhere is the one csrc/camera.cuh computes. Prints
one JSON line: the counts by formula, summed over the cameras.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def mismatches(cfg, dev) -> dict:
    import torch

    from raytracer_tpu_torch.models import camera
    cam = camera.build_camera(cfg)
    w, h = cfg.width, cfg.height
    idx = torch.arange(w * h, dtype=torch.int32, device=dev)
    v = (camera.pixel_to_world(cam, idx % w, idx // w)
         - torch.as_tensor(cam.position, device=dev))
    norm = torch.linalg.vector_norm(v, dim=-1)
    x, y, z = v.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()
    orders = {
        "(x*x + y*y) + z*z": (xx + yy) + zz,
        "(x*x + z*z) + y*y": (xx + zz) + yy,
        "x*x + (y*y + z*z)": xx + (yy + zz),
        "fma(z, z, fma(y, y, x*x))": fma(z, z, fma(y, y, xx)),
        "fma(y, y, x*x) + z*z": fma(y, y, xx) + zz,
        "fma(z, z, x*x) + y*y": fma(z, z, xx) + yy,
        "fma(y, y, fma(z, z, x*x))": fma(y, y, fma(z, z, xx)),
    }
    out = {k: int((torch.sqrt(s) != norm).sum()) for k, s in orders.items()}
    out["pixels"] = w * h
    return out


def main() -> int:
    import torch

    import raytracer_tpu_torch as rtt
    if not torch.cuda.is_available():
        print("norm_order: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cams = [cs.fly_camera(i, cs.FLY_W, cs.FLY_H) for i in range(18)]
    cams += [rtt.CameraConfig(width=1000, height=800),
             rtt.CameraConfig(width=1000, height=800,
                              position=(0.0, 0.5, -6.0)),
             cs.fly_camera(3, 130, 70)]
    total: dict = {}
    for cfg in cams:
        for k, n in mismatches(cfg, dev).items():
            total[k] = total.get(k, 0) + n
    print(json.dumps({"what": "vector_norm order", "cameras": len(cams),
                      "mismatches": total, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
