"""Device ops a frame (kernels, copies, fills) that the profiler
recorded, over the frames whose markers it recorded."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.frames or not tr.ops:
        return None
    return tr.ops / tr.frames
