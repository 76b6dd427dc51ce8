"""Build and bind the port's CUDA kernels.

``load()`` compiles the CUDA sources of ``csrc/`` with nvcc for sm_90a, one
nvcc per source, all started together, links them into one shared library
with a plain C interface, at first use, under ``build/`` at the root of the
checkout (listed in .gitignore), and loads it with ctypes. The library file
is named by a hash of every CUDA source and header under ``csrc/`` and of
the flags, so a changed file is rebuilt and an unchanged one is reused. Nothing
here runs when the module is imported: the CPU tests import it without
nvcc.

The C interface: each entry point takes a pointer to an argument struct
(mirrored below as ctypes Structures) and a CUDA stream, launches on that
stream, and returns the launch's ``cudaError_t`` (0 = launched).
``launch(name, args, device)`` is the one way the port calls an entry
point: on the device's current stream, raising on an error, and counting
the launch under ``name`` in the program counts (utils/trace.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from ..utils import trace

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("megakernel.cu", "wavefront.cu", "warp.cu", "bounce.cu",
           "rays.cu", "camera.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

_lib = None
# What the last build reported: seconds, library path, nvcc's output
# (ptxas registers and spills per kernel). Empty when the library was
# reused or not built yet.
BUILD_INFO: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from csrc/ at first use")
    return found


def library_path() -> pathlib.Path:
    """The library's path, named by a hash of the flags and of every CUDA
    source and header under csrc/ (the build reads no other file)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libraytracer_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with nvcc's output on a
    failure. Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build() -> pathlib.Path:
    """Compile the kernels unless this source's library already exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = path.with_suffix(f".{os.getpid()}")
    objs = [f"{stem}.{pathlib.Path(src).stem}.o" for src in SOURCES]
    t0 = time.perf_counter()
    log = _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
                    for src, obj in zip(SOURCES, objs)])
    tmp = f"{stem}.tmp"
    log += _run_all([[nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                      "-shared", "-o", tmp, *objs]])
    os.replace(tmp, path)
    for obj in objs:
        os.remove(obj)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(path),
                      log=log)
    return path


class SceneArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "sph_f", "sph_i", "tri_f", "tri_i", "sph_cl", "tri_cl", "sph_sup",
        "tri_sup", "sphp_f", "sphp_i", "trip_f", "trip_i")]
        + [(n, ctypes.c_int) for n in (
            "n_sph", "n_tri", "n_sph_cl", "n_tri_cl", "n_sph_sup",
            "n_tri_sup", "sph_leaf", "tri_leaf", "rows_s", "rows_t",
            "has_one_way", "needs_tri_uv")])


class HitArgs(ctypes.Structure):
    _fields_ = [("scene", SceneArgs),
                ("o", ctypes.c_void_p * 3), ("d", ctypes.c_void_p * 3),
                ("out", ctypes.c_void_p * 9), ("n", ctypes.c_int),
                ("group", ctypes.c_int)]


class ResolveArgs(ctypes.Structure):
    _fields_ = [("scene", SceneArgs),
                ("o", ctypes.c_void_p * 3), ("d", ctypes.c_void_p * 3),
                ("out", ctypes.c_void_p * 12), ("stats", ctypes.c_void_p),
                ("sample", ctypes.c_void_p), ("spp", ctypes.c_int),
                ("n", ctypes.c_int), ("group", ctypes.c_int)]


class BlockedArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "sphf", "sphi", "trif", "trii", "sph_cl", "tri_cl", "sph_sup",
        "tri_sup", "bbox")]
        + [(n, ctypes.c_int) for n in (
            "nblocks", "sph_blocks", "tri_blocks", "sph_leaf", "tri_leaf",
            "sc_rows", "tc_rows", "ss_rows", "ts_rows", "has_one_way",
            "needs_tri_uv")]
        + [("o", ctypes.c_void_p * 3), ("d", ctypes.c_void_p * 3),
           ("out", ctypes.c_void_p * 9), ("sample", ctypes.c_void_p),
           ("spp", ctypes.c_int), ("n", ctypes.c_int),
           ("group", ctypes.c_int)])


_P3 = ctypes.c_void_p * 3


class RaysArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in ("keys", "sample", "bounce")]
                + [(n, _P3) for n in ("d", "dj", "unit")]
                + [(n, ctypes.c_void_p) for n in (
                    "inv_len", "draws", "alive", "segs", "key_dev",
                    "iter_dev")]
                + [("key0", ctypes.c_uint), ("key1", ctypes.c_uint)]
                + [(n, ctypes.c_int) for n in (
                    "n", "rows", "bounce_const", "spp", "antialias")]
                + [("jitter_scale", ctypes.c_float)])


class MegaArgs(ctypes.Structure):
    _fields_ = ([("scene", SceneArgs),
                 ("o", ctypes.c_void_p * 3), ("d", ctypes.c_void_p * 3),
                 ("out", ctypes.c_void_p * 5), ("mat", ctypes.c_void_p),
                 ("n_mat", ctypes.c_int), ("tex", ctypes.c_void_p),
                 ("img_rows", ctypes.c_int),
                 ("seed_w0", ctypes.c_uint), ("seed_w1", ctypes.c_uint)]
                + [(n, ctypes.c_int) for n in (
                    "tile_offset", "n_tiles", "pixpack", "spp", "limit",
                    "antialias", "rr_start", "emissive_terminates",
                    "fix_exit_ior", "need_sphere_uv", "has_refractive",
                    "coherent")]
                + [("inv_spp", ctypes.c_float),
                   ("sky", ctypes.c_float * 3),
                   ("group", ctypes.c_int)])


class FetchArgs(ctypes.Structure):
    _fields_ = [("tex", ctypes.c_void_p), ("img_rows", ctypes.c_int),
                ("mat", ctypes.c_void_p), ("n_mat", ctypes.c_int),
                ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("mat_id", ctypes.c_void_p), ("out", ctypes.c_void_p * 3),
                ("n", ctypes.c_int)]


class WarpGatherArgs(ctypes.Structure):
    _fields_ = [("values", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("valid", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("m", ctypes.c_int), ("n", ctypes.c_int)]


class TemporalArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "out", "accum", "wpix", "accum_out", "w_out", "seg_acc", "segs")]
        + [(n, ctypes.c_float * 3) for n in (
            "cpos", "ctl", "cdu", "cdv", "pos", "tl", "du", "dv", "nrm")]
        + [(n, ctypes.c_float) for n in ("focal", "dudu", "dvdv", "history",
                                         "scale")]
        + [("stride", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in ("width", "height", "warp")])


class CameraRaysArgs(ctypes.Structure):
    _fields_ = ([("o", ctypes.c_void_p), ("d", ctypes.c_void_p)]
                + [(n, ctypes.c_float * 3) for n in ("pos", "tl", "du", "dv")]
                + [(n, ctypes.c_int) for n in ("n", "n_pad", "width")])


class BounceArgs(ctypes.Structure):
    _fields_ = ([(n, _P3) for n in ("o", "d", "thru", "rad")]
                + [("ior", ctypes.c_void_p), ("alive", ctypes.c_void_p),
                   ("pixel_sum", _P3), ("sample", ctypes.c_void_p),
                   ("bounce", ctypes.c_void_p), ("o0p", _P3), ("d0p", _P3),
                   ("dj", _P3), ("raw", ctypes.c_void_p * 12),
                   ("inv_len", ctypes.c_void_p),
                   ("gauss", _P3), ("fresnel", ctypes.c_void_p),
                   ("rr", ctypes.c_void_p)]
                + [(n, ctypes.c_void_p) for n in (
                    "mat_type", "mat_ior", "mat_emit", "tex_type",
                    "tex_light", "tex_dark", "tex_nsq", "tex_off", "tex_w",
                    "tex_h", "atlas")]
                + [("atlas_rows", ctypes.c_int),
                   ("sky", ctypes.c_float * 3)]
                + [(n, ctypes.c_int) for n in (
                    "n", "bounce_const", "rr_start", "limit", "spp",
                    "fix_exit_ior", "has_refractive", "emissive_terminates",
                    "regen", "blocked", "sphere_uv")])


def scene_args(ps) -> SceneArgs:
    """SceneArgs over a PackedScene's tensors (the caller keeps ``ps``
    alive across the launch)."""
    return SceneArgs(
        *[t.data_ptr() for t in (
            ps.sph_f, ps.sph_i, ps.tri_f, ps.tri_i, ps.sph_cl, ps.tri_cl,
            ps.sph_sup, ps.tri_sup, ps.sphp_f, ps.sphp_i, ps.trip_f,
            ps.trip_i)],
        ps.n_sph, ps.n_tri, ps.n_sph_cl, ps.n_tri_cl, ps.n_sph_sup,
        ps.n_tri_sup, ps.sph_leaf, ps.tri_leaf, ps.rows_s, ps.rows_t,
        int(ps.has_one_way), int(ps.needs_tri_uv))


def row_ptrs(x: torch.Tensor):
    """Row pointers of an (R, N) tensor with contiguous rows, from its
    stride (indexing the rows would make R views, ~10 us each)."""
    base, step = x.data_ptr(), x.stride(0) * x.element_size()
    return (ctypes.c_void_p * x.shape[0])(*[base + i * step
                                            for i in range(x.shape[0])])


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in (("rt_nearest_hit", HitArgs),
                           ("rt_hit_resolve", ResolveArgs),
                           ("rt_megakernel", MegaArgs),
                           ("rt_fetch_image", FetchArgs),
                           ("rt_hit_resolve_blocked", BlockedArgs),
                           ("rt_warp_gather", WarpGatherArgs),
                           ("rt_temporal_frame", TemporalArgs),
                           ("rt_camera_rays", CameraRaysArgs),
                           ("rt_wave_bounce", BounceArgs),
                           ("rt_wave_rays", RaysArgs)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.rt_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.rt_occupancy.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# rt_occupancy's kernels: K1 (rt_megakernel), rt_nearest_hit, K5
# (rt_hit_resolve) and K6 (rt_hit_resolve_blocked)
KIND_MEGAKERNEL, KIND_NEAREST, KIND_RESOLVE, KIND_BLOCKED = 0, 1, 2, 3
_RESIDENT: dict = {}


def resident_threads(kind: int, group: int) -> int:
    """Threads of kernel ``kind`` at group size ``group`` that the current
    CUDA device keeps resident at once (rt_occupancy)."""
    key = (kind, group, torch.cuda.current_device())
    if key not in _RESIDENT:
        lib = load()
        threads = ctypes.c_int()
        check(lib, lib.rt_occupancy(kind, group, ctypes.byref(threads)),
              "rt_occupancy")
        _RESIDENT[key] = threads.value
    return _RESIDENT[key]


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")


def launch(name: str, args: ctypes.Structure, device: torch.device) -> None:
    """Call entry point ``name`` with its argument struct ``args`` on
    ``device``'s current stream (the caller keeps the tensors ``args``
    points at alive across the launch); raise if it returned an error,
    else count ``name`` in the program counts."""
    lib = load()
    check(lib, getattr(lib, name)(ctypes.byref(args),
                                  ctypes.c_void_p(stream(device))), name)
    trace.count(name)
