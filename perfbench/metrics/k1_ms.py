"""Device ms a frame of K1, ``rt_megakernel``: every sample's whole
path in one kernel, launched once a frame. Where the profiler kept
another number of its launches than it kept frames, it reads nothing."""

KERNELS = ("megakernel",)


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.frames or tr.count(*KERNELS) != tr.frames:
        return None
    return 1e3 * tr.device_s(*KERNELS) / tr.frames
