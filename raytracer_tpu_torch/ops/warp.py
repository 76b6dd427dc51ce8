"""Temporal history: the packed history plane and its inverse warp.

Port of the temporal half of ``raytracer_tpu/runtime/renderer.py``
(``_pack_history_body``:53, ``_gather_history``:71) and of
``raytracer_tpu/ops/warp.py`` (``banded_gather``:104, TPU kernel K7).

A camera move in temporal mode keeps the old accumulation: the next frame
projects each current pixel's primary hit through the old pinhole and
reads the old pixel there. The history it reads is the old accumulation
quantized as JAX packs it into one int32 per pixel (``pack_history``):
9-bit sqrt-encoded RGB over [0, HIST_MAX) and the capped frame weight in
the low 5 bits.

Two kernels, both in csrc/warp.cu, load at a clamped index:
- ``warp_gather``: K7's contract ``where(valid, values[idx], 0)`` on int32;
- ``temporal_frame``: the temporal frame's epilogue after the megakernel,
  as JAX's temporal step fuses it (renderer.py:355-391): the per-pixel
  weight blend and, on the first frame after a move, the history gather
  before it (the pack and the whole reprojection of ``_gather_history``
  fused per pixel: project, floor, validity, the load of the old pixel,
  its pack and decode, the velocity-limited weight), from rays made from
  the camera basis in the kernel. This is what the temporal ``Renderer``
  runs.
CPU tensors take the plain versions (``warp_gather_reference``,
``temporal_frame_reference``); CUDA tensors launch the kernel or raise.
``gather_history``, the history gather alone, has no kernel: it is its
plain version, ``gather_history_reference``, on any device.

Only the scanline (identity) pixel order is served: current pixel i is
screen pixel (i % width, i // width), and the packed plane is in pixel
order. On an invalid pixel both functions read nothing and give 0 (the
JAX XLA arm reads a clamped garbage word there); history enters the blend
only as ``hist * w`` with ``w = 0`` there, so the blend is the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import build
from ..models.camera import CameraArrays, f3, primary_rays
from . import film

HIST_MAX = 8.0
# 8 / 511^2: radiance per squared 9-bit code (renderer.py:117)
_SCALE = float(np.float32(HIST_MAX / (511.0 * 511.0)))
_INT_MAX = 2147483647
_INT_MIN = -2147483648


def pack_history(accum: torch.Tensor, wpix: torch.Tensor,
                 history: float) -> torch.Tensor:
    """(N, 3) accumulation and (N,) weights -> (N,) packed int32 history
    (renderer.py:53-65, the identity-order arm). Rounding is half to even,
    as ``jnp.round``; q >= 256 in the red field sets bit 31, so the word
    is negative and is unpacked with an arithmetic shift and a mask."""
    w = torch.clamp(torch.clamp(wpix, max=history), 0.0, 31.0).to(
        torch.int32)
    q = torch.round(_sqrt_rn(torch.clamp(accum / HIST_MAX, 0.0, 1.0))
                    * 511.0).to(torch.int32)
    return (q[:, 0] << 23) | (q[:, 1] << 14) | (q[:, 2] << 5) | w


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's and CUDA's ``sqrtf``:
    torch's vectorised CPU sqrt is off by one ulp on ~0.6% of values. The
    float64 root rounded to float32 is the correctly rounded float32 root
    (53 >= 2 * 24 + 2 bits, so the double rounding is harmless)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int32, saturating, NaN -> 0: XLA's f32 -> s32 convert
    after ``floor`` and CUDA's ``__float2int_rd``."""
    f = torch.floor(x)
    hi = f >= 2147483648.0
    lo = f < -2147483648.0
    i = torch.where(hi | lo | torch.isnan(f), 0.0, f).to(torch.int32)
    i = torch.where(hi, _INT_MAX, i)
    return torch.where(lo, _INT_MIN, i)


def _dot3(a, b):
    """a . b over the last axis of length 3, unfused, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def projection_basis(pos, tl, du, dv):
    """The old pinhole's plane normal n = cross(dv, du) / |n|, the focal
    distance (tl - pos) . n and du . du, dv . dv, in float32 on the host
    (renderer.py:86-93). Both the kernel's wrapper and the plain version
    take these values, so the two project with the same scalars."""
    pos, tl, du, dv = (torch.as_tensor(np.asarray(v, np.float32))
                       for v in (pos, tl, du, dv))
    n = torch.stack([dv[1] * du[2] - dv[2] * du[1],
                     dv[2] * du[0] - dv[0] * du[2],
                     dv[0] * du[1] - dv[1] * du[0]])
    n = n / _sqrt_rn(_dot3(n, n))
    return n, _dot3(tl - pos, n), _dot3(du, du), _dot3(dv, dv)


def warp_gather_reference(values: torch.Tensor, idx: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Plain K7: ``where(valid, values[clamp(idx)], 0)``."""
    k = torch.clamp(idx, 0, values.shape[0] - 1).long()
    return torch.where(valid, values[k], 0)


def _check_gather(values, idx, valid) -> None:
    n = idx.shape[0]
    if (values.dtype != torch.int32 or idx.dtype != torch.int32
            or valid.dtype != torch.bool or values.dim() != 1
            or idx.shape != (n,) or valid.shape != (n,)):
        raise ValueError("values (M,) int32, idx (N,) int32 and valid (N,) "
                         "bool expected")
    if values.shape[0] == 0:
        raise ValueError("values is empty")
    if not values.device == idx.device == valid.device:
        raise ValueError("values, idx and valid must share one device")


def _gather_args(values, idx, valid, out):
    """rt_warp_gather's arguments over contiguous CUDA tensors (the caller
    keeps them alive across the launch)."""
    return build.WarpGatherArgs(
        values=values.data_ptr(), idx=idx.data_ptr(), valid=valid.data_ptr(),
        out=out.data_ptr(), m=values.shape[0], n=idx.shape[0])


def warp_gather(values: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """K7 (raytracer_tpu/ops/warp.py:104): ``where(valid, values[idx], 0)``
    for (M,) int32 ``values`` and (N,) int32 ``idx``; ``idx`` is clamped
    to [0, M) before the load. CPU tensors take the plain version; CUDA
    tensors launch ``rt_warp_gather`` (or raise)."""
    _check_gather(values, idx, valid)
    if values.device.type == "cpu":
        return warp_gather_reference(values, idx, valid)
    if values.device.type != "cuda":
        raise ValueError(f"no warp gather for device {values.device}")
    values, idx, valid = (x.contiguous() for x in (values, idx, valid))
    out = torch.empty(idx.shape, dtype=torch.int32, device=idx.device)
    build.launch("rt_warp_gather", _gather_args(values, idx, valid, out),
                 idx.device)
    return out


def gather_history_reference(width: int, height: int, o: torch.Tensor,
                             d: torch.Tensor, depth: torch.Tensor,
                             accum: torch.Tensor, wpix: torch.Tensor,
                             history: float, pos, tl, du, dv):
    """Plain version of the history gather in ``rt_temporal_frame``'s
    warp arm: ``pack_history`` over the whole old plane, then
    ``_gather_history`` (renderer.py:71-122) in the identity order, with
    every dot product written out unfused and every
    division a true division of two device tensors (torch divides by a
    host scalar as a multiply by its reciprocal on the card). Returns
    (hist (N, 3), w (N,))."""
    dev = o.device
    packed = pack_history(accum, wpix, history)
    n3, focal, dudu, dvdv = (x.to(dev) for x in projection_basis(
        pos, tl, du, dv))
    posd = torch.as_tensor(np.asarray(pos, np.float32), device=dev)
    tld = torch.as_tensor(np.asarray(tl, np.float32), device=dev)
    dud = torch.as_tensor(np.asarray(du, np.float32), device=dev)
    dvd = torch.as_tensor(np.asarray(dv, np.float32), device=dev)
    hit = depth < 1e29
    p_world = o + d * torch.minimum(depth, torch.tensor(
        1e29, device=dev))[:, None]
    v = p_world - posd
    vn = _dot3(v, n3)
    front = vn > 1e-9
    s = focal / torch.where(front, vn, 1.0)
    r = (posd + v * s[:, None]) - tld
    x = _dot3(r, dud) / dudu
    y = _dot3(r, dvd) / dvdv
    xi, yi = _floor_int(x), _floor_int(y)
    valid = (hit & front & (xi >= 0) & (xi < width) & (yi >= 0)
             & (yi < height))
    # yi * width + xi wraps in int32, as in XLA
    flat = torch.clamp(yi * width + xi, 0, width * height - 1)
    word = warp_gather_reference(packed, flat, valid)
    i = torch.arange(o.shape[0], dtype=torch.int32, device=dev)
    ex = x - (i % width).to(torch.float32)
    ey = y - (i // width).to(torch.float32)
    motion = _sqrt_rn(ex * ex + ey * ey)
    w = torch.where(valid, (word & 31).to(torch.float32), 0.0)
    w = torch.minimum(w, torch.tensor(31.0, device=dev)
                      / (1.0 + 0.5 * motion))
    hist = torch.stack([((word >> sh) & 511).to(torch.float32)
                        for sh in (23, 14, 5)], dim=-1)
    return (hist * hist) * _SCALE, w


def gather_history(width: int, height: int, o: torch.Tensor,
                   d: torch.Tensor, depth: torch.Tensor,
                   accum: torch.Tensor, wpix: torch.Tensor, history: float,
                   pos, tl, du, dv):
    """Inverse-warp the old accumulation into the current view
    (renderer.py:53-122, pack and gather): for each current pixel, its
    primary hit ``o + d * depth`` projected through the old pinhole
    (``pos``, ``tl``, ``du``, ``dv``, host float32 vectors) picks one old
    pixel, whose accumulation and weight (capped at ``history``) are
    quantized as ``pack_history`` packs them; out-of-view, behind-camera
    and missed pixels get weight 0 and history 0.

    ``o``, ``d``: (N, 3) float32 primary rays of the current view in
    scanline order, N = width * height; ``depth``: (N,) primary-hit t
    (>= 1e29 on a miss); ``accum`` (N, 3) and ``wpix`` (N,) float32: the
    old view's accumulation and per-pixel weights, finite. Returns
    (hist (N, 3) float32, w (N,) float32). No kernel stands behind it
    (``rt_temporal_frame`` runs the same gather per pixel inside the
    temporal frame): it is ``gather_history_reference``, on the tensors'
    device."""
    n = width * height
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("depth", depth, (n,)), ("accum", accum, (n, 3)),
                           ("wpix", wpix, (n,))):
        if x.shape != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != o.device:
            raise ValueError("o, d, depth, accum and wpix must share one "
                             "device")
    return gather_history_reference(width, height, o, d, depth, accum, wpix,
                                    history, pos, tl, du, dv)


# -- the temporal frame's epilogue --------------------------------------------

@dataclasses.dataclass(frozen=True)
class HistorySource:
    """What a camera move keeps for the next frame's warp (renderer.py:
    430-449): the old view's accumulation (N, 3) and weights (N,), the
    history cap, the old camera and its ``projection_basis`` scalars,
    computed once on the host when the move is made."""

    accum: torch.Tensor
    wpix: torch.Tensor
    history: float
    cam: CameraArrays
    nrm: np.ndarray
    focal: float
    dudu: float
    dvdv: float


def history_source(accum: torch.Tensor, wpix: torch.Tensor, history: float,
                   cam: CameraArrays) -> HistorySource:
    """The move's stash: the old view's accumulation and weights, the cap
    and the old camera ``cam``, with its projection scalars."""
    nrm, focal, dudu, dvdv = projection_basis(
        cam.position, cam.tl_pixel, cam.delta_u, cam.delta_v)
    return HistorySource(accum, wpix, float(history), cam, nrm.numpy(),
                         float(focal), float(dudu), float(dvdv))


def temporal_frame_reference(out, n, accum, wpix, src=None, cam=None,
                             width=0, height=0):
    """Plain version of ``rt_temporal_frame``: ``film.temporal_update``
    over this view's accumulation (``src`` None), or, after a move, over
    ``gather_history_reference``'s history of ``src`` gathered into the
    scanline primary rays of ``cam``, in JAX's operation order
    (renderer.py:365-367, :386-388); and the frame's segments,
    ``out[3, :n].sum(dtype=float64)``."""
    mean, depth = out[:3, :n], out[4, :n]
    segs = out[3, :n].sum(dtype=torch.float64)
    if src is None:
        return (*film.temporal_update(accum, mean.T, wpix), segs)
    o, d = primary_rays(cam, width, height, device=out.device)
    old = src.cam
    hist, w = gather_history_reference(
        width, height, o, d, depth, src.accum, src.wpix, src.history,
        old.position, old.tl_pixel, old.delta_u, old.delta_v)
    return (*film.temporal_update(hist, mean.T, w), segs)


# rt_temporal_frame's segment accumulators, one a (device, stream): two
# int64 words that every launch leaves zero, so launches on one stream take
# turns with them
_SEG_ACC: dict = {}


def _seg_acc(device: torch.device) -> torch.Tensor:
    key = (device.index, build.stream(device))
    if key not in _SEG_ACC:
        _SEG_ACC[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _SEG_ACC[key]


def _frame_args(out, n, accum, wpix, accum_out, w_out, segs, src, cam,
                width, height):
    """rt_temporal_frame's arguments (the caller keeps the tensors alive
    across the launch). The static arm (``src`` None) reads ``accum`` and
    ``wpix`` and writes ``accum_out`` and ``w_out``; the warp arm reads
    ``src``'s planes and basis and ``cam``'s. Both write the segments to
    the float64 scalar ``segs``."""
    zero = np.zeros(3, np.float32)
    cur = (zero,) * 4 if cam is None else (
        cam.position, cam.tl_pixel, cam.delta_u, cam.delta_v)
    if src is None:     # the static arm reads pixels [0, n) only
        accum_in, wpix_in, width, height = accum, wpix, n, 1
        old, (focal, dudu, dvdv, history) = (zero,) * 5, (0.0,) * 4
    else:
        c = src.cam
        accum_in, wpix_in = src.accum, src.wpix
        old = (c.position, c.tl_pixel, c.delta_u, c.delta_v, src.nrm)
        focal, dudu, dvdv, history = (src.focal, src.dudu, src.dvdv,
                                      src.history)
    cpos, ctl, cdu, cdv = map(f3, cur)
    pos, tl, du, dv, nrm = map(f3, old)
    return build.TemporalArgs(
        out=out.data_ptr(), accum=accum_in.data_ptr(),
        wpix=wpix_in.data_ptr(), accum_out=accum_out.data_ptr(),
        w_out=w_out.data_ptr(), seg_acc=_seg_acc(out.device).data_ptr(),
        segs=segs.data_ptr(), cpos=cpos, ctl=ctl, cdu=cdu, cdv=cdv, pos=pos,
        tl=tl, du=du, dv=dv, nrm=nrm, focal=focal, dudu=dudu, dvdv=dvdv,
        history=history, scale=_SCALE, stride=out.shape[1], width=width,
        height=height, warp=int(src is not None))


def _check_frame(out, n, accum, wpix, src, cam, width, height) -> None:
    planes = [("accum", accum, (n, 3)), ("wpix", wpix, (n,))]
    if src is not None:
        if cam is None or width * height != n:
            raise ValueError(f"the warp arm needs the camera of a "
                             f"{width}x{height} film of {n} pixels")
        planes += [("src.accum", src.accum, (n, 3)),
                   ("src.wpix", src.wpix, (n,))]
    for name, x, shape in planes:
        if (x.shape != shape or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {shape} float32, "
                             f"got {tuple(x.shape)} {x.dtype}")
    if (out.dim() != 2 or out.shape[0] != 5 or out.shape[1] < n
            or out.dtype != torch.float32 or not out.is_contiguous()):
        raise ValueError(f"out must be the megakernel's contiguous (5, "
                         f">= {n}) float32 output, got {tuple(out.shape)} "
                         f"{out.dtype}")
    if len({x.device for _, x, _ in planes} | {out.device}) != 1:
        raise ValueError("out and the planes must share one device")


def temporal_frame(out: torch.Tensor, n: int, accum: torch.Tensor,
                   wpix: torch.Tensor, src: HistorySource = None,
                   cam: CameraArrays = None, width: int = 0,
                   height: int = 0):
    """One temporal frame after the megakernel (renderer.py:355-391), over
    its (5, n_pad) output ``out`` (``megakernel.mega_frame``) for N = ``n``
    pixels: mean rows 0-2, the lanes' segment counts row 3, depth row 4.
    With ``src`` None the per-pixel weight blend
    ``(mean + accum * w) / (w + 1)`` and ``w + 1`` over ``accum`` (N, 3)
    and ``wpix`` (N,), both updated in place on the card (``accum`` on the
    CPU too). After a move, ``src`` (``history_source``) is gathered into
    the scanline view of ``cam`` (a ``width`` x ``height`` film) as
    ``gather_history`` gathers it, and blended; ``accum`` and ``wpix`` are
    not read and new planes are returned. Returns (accumulation, weights,
    the frame's segments as a float64 0-dim tensor, as
    ``render_sample_mean_mega`` counts them). CPU tensors take
    ``temporal_frame_reference``; CUDA tensors launch
    ``rt_temporal_frame`` (or raise)."""
    _check_frame(out, n, accum, wpix, src, cam, width, height)
    if out.device.type == "cpu":
        return temporal_frame_reference(out, n, accum, wpix, src, cam,
                                        width, height)
    if out.device.type != "cuda":
        raise ValueError(f"no temporal frame for device {out.device}")
    if src is None:
        accum_out, w_out = accum, wpix
    else:
        accum_out, w_out = torch.empty_like(accum), torch.empty_like(wpix)
    segs = torch.empty((), dtype=torch.float64, device=out.device)
    args = _frame_args(out, n, accum, wpix, accum_out, w_out, segs, src,
                       cam, width, height)
    build.launch("rt_temporal_frame", args, out.device)
    return accum_out, w_out, segs
