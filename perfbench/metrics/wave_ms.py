"""Device ms a frame of the wavefront iteration's ray set-up and bounce
kernels, ``rt_wave_rays`` and ``rt_wave_bounce``."""

KERNELS = ("wave_rays_kernel", "wave_bounce_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.frames:
        return None
    s = tr.device_s(*KERNELS)
    return 1e3 * s / tr.frames if s > 0 else None
