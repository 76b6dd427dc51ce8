"""Device ms a frame of K6, ``rt_hit_resolve_blocked``: the wavefront
samplers' nearest hit over the blocked layout, for scenes past the
resident budget."""

KERNELS = ("hit_resolve_blocked_kernel",)


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.frames:
        return None
    s = tr.device_s(*KERNELS)
    return 1e3 * s / tr.frames if s > 0 else None
