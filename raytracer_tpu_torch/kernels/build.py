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

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("megakernel.cu", "wavefront.cu")
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
                ("out", ctypes.c_void_p * 9), ("n", ctypes.c_int)]


class ResolveArgs(ctypes.Structure):
    _fields_ = [("scene", SceneArgs),
                ("o", ctypes.c_void_p * 3), ("d", ctypes.c_void_p * 3),
                ("out", ctypes.c_void_p * 12), ("n", ctypes.c_int)]


class BlockedArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "sphf", "sphi", "trif", "trii", "sph_cl", "tri_cl", "sph_sup",
        "tri_sup", "bbox")]
        + [(n, ctypes.c_int) for n in (
            "nblocks", "sph_blocks", "tri_blocks", "sph_leaf", "tri_leaf",
            "sc_rows", "tc_rows", "ss_rows", "ts_rows", "has_one_way",
            "needs_tri_uv")]
        + [("o", ctypes.c_void_p * 3), ("d", ctypes.c_void_p * 3),
           ("out", ctypes.c_void_p * 9), ("n", ctypes.c_int)])


class LaneArgs(ctypes.Structure):
    _fields_ = [("keys", ctypes.c_void_p), ("sample", ctypes.c_void_p),
                ("bounce", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_int), ("rows", ctypes.c_int)]


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
                    "fix_exit_ior", "need_sphere_uv", "has_refractive")]
                + [("inv_spp", ctypes.c_float),
                   ("sky", ctypes.c_float * 3)])


class FetchArgs(ctypes.Structure):
    _fields_ = [("tex", ctypes.c_void_p), ("img_rows", ctypes.c_int),
                ("mat", ctypes.c_void_p), ("n_mat", ctypes.c_int),
                ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("mat_id", ctypes.c_void_p), ("out", ctypes.c_void_p * 3),
                ("n", ctypes.c_int)]


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


def ptrs3(x: torch.Tensor):
    """Row pointers of a contiguous (3, N) tensor."""
    return (ctypes.c_void_p * 3)(*[x[i].data_ptr() for i in range(3)])


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
                           ("rt_lane_randoms", LaneArgs)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")
