"""Device ms a frame of K5, ``rt_hit_resolve``: the wavefront samplers'
nearest hit over the scene's resident pools."""

KERNELS = ("hit_resolve_kernel",)


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.frames:
        return None
    s = tr.device_s(*KERNELS)
    return 1e3 * s / tr.frames if s > 0 else None
