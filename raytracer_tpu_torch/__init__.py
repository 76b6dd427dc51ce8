"""raytracer_tpu_torch — the progressive Monte-Carlo path tracer on PyTorch
and CUDA.

A port of ``raytracer_tpu`` (JAX on a TPU) to an NVIDIA H100, laid out like
it: ``config``, ``models`` (scene, camera, materials), ``ops`` (rng, sweep,
megakernel, film, integrator), ``runtime`` (renderer, BVH build) and
``utils``. The hand-written CUDA kernels live in ``csrc/`` and are built by
``kernels/build.py`` at first use. This package imports torch and numpy,
never jax.
"""

from .config import CameraConfig, RenderSettings
from .models.scenes import build_scene
from .runtime.renderer import Renderer

__all__ = ["CameraConfig", "RenderSettings", "build_scene", "Renderer"]
