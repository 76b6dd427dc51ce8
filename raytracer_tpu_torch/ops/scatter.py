"""Scattering as branchless masked math over (3, N) tensors.

Port of ``raytracer_tpu/ops/scatter.py`` for the wavefront samplers, in the
same operation order: every ray evaluates every scattering model and
selects by material (src/ray.cu:67-196).
"""

from __future__ import annotations

import torch

from ..config import ANTIALIAS_OFFSET_RANGE
from ..models.materials import MAT_REFRACTIVE


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(3, N) . (3, N) -> (N,)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize(a: torch.Tensor) -> torch.Tensor:
    """(3, N) -> unit vectors, no epsilon guard (src/utils.cu:123)."""
    return a * torch.rsqrt(_dot(a, a))[None, :]


def antialias_jitter(u3: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Jitter ray directions by +-0.001 per axis and renormalise
    (src/ray.cu:130-142, applied every bounce); ``u3`` (3, N) uniform."""
    offset = (u3 - 0.5) * (2.0 * ANTIALIAS_OFFSET_RANGE)
    return _normalize(d + offset)


def _diffuse_dir(gauss: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Hemisphere-flipped Gaussian plus the normal (src/ray.cu:157-178)."""
    flip = torch.where(_dot(gauss, normal) < 0.0, -1.0, 1.0)
    rand_unit = _normalize(gauss * flip[None, :])
    return _normalize(normal + rand_unit)


def _specular_dir(d: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection d - 2(d.n)n (src/ray.cu:180-186)."""
    return _normalize(d - normal * (2.0 * _dot(d, normal))[None, :])


def _schlick(cos_theta, n1, n2):
    """Schlick reflectance (src/ray.cu:188-196)."""
    sqrt_r0 = (n1 - n2) / (n1 + n2)
    r0 = sqrt_r0 * sqrt_r0
    m = 1.0 - cos_theta
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def scatter(gauss, fresnel_u, d, normal, mat_type, smoothness, mat_ior,
            cur_ior, fix_exit_ior: bool = False, has_refractive: bool = True):
    """Outgoing directions and the new current IOR (scatter.py:68-149).

    ``gauss`` (3, N) standard normals, ``fresnel_u`` (N,) uniforms, ``d``
    (3, N) unit incoming directions, ``normal`` (3, N) hit normals with the
    reference orientation, ``mat_type`` (N,) i32, ``smoothness``,
    ``mat_ior``, ``cur_ior`` (N,) f32. ``has_refractive=False`` skips the
    refraction block, which no ray would select."""
    diffuse = _diffuse_dir(gauss, normal)
    specular = _specular_dir(d, normal)
    reflect_dir = _normalize(
        diffuse + (specular - diffuse) * smoothness[None, :])
    if not has_refractive:
        return reflect_dir, cur_ior

    # sphere normals stay outward: dot(n, d) > 0 means exiting
    # (src/ray.cu:84-96); the reference's exit IOR quirk unless fixed
    exiting = _dot(normal, d) > 0.0
    n1 = torch.where(exiting, mat_ior, cur_ior)
    exit_ior = torch.ones_like(cur_ior) if fix_exit_ior else cur_ior
    n2 = torch.where(exiting, exit_ior, mat_ior)
    ref_sign = torch.where(exiting, 1.0, -1.0)
    ref_n = normal * ref_sign[None, :]

    cos1 = torch.clamp(_dot(d, ref_n), max=1.0)
    sin1 = torch.sqrt(torch.clamp(1.0 - cos1 * cos1, min=0.0))
    sin2 = torch.clamp(n1 * sin1 / n2, max=1.0)
    cos2 = torch.sqrt(torch.clamp(1.0 - sin2 * sin2, min=0.0))
    tir = sin1 > (n2 / n1)
    refl_coeff = _schlick(cos1, n1, n2)
    do_reflect = tir | (refl_coeff > fresnel_u)

    # normal incidence, theta1 == 0 (src/ray.cu:116-121)
    safe_sin1 = torch.where(sin1 == 0.0, 1.0, sin1)
    perp = torch.where((sin1 != 0.0)[None, :],
                       (d - ref_n * cos1[None, :]) / safe_sin1[None, :], 0.0)
    refr_dir = _normalize(ref_n * cos2[None, :] + perp * sin2[None, :])
    refractive_dir = torch.where(do_reflect[None, :], reflect_dir, refr_dir)

    is_refr = mat_type == MAT_REFRACTIVE
    new_dir = torch.where(is_refr[None, :], refractive_dir, reflect_dir)
    ior_update = is_refr & ~do_reflect if fix_exit_ior else is_refr
    new_cur_ior = torch.where(ior_update, n2, cur_ior)
    return new_dir, new_cur_ior
