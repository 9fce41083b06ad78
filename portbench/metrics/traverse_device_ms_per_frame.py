"""Kernels (csrc/traverse*.cu): device milliseconds a frame of the
trace_*_kernel kernels, from the profiler's trace."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or t.traverse_s <= 0:
        return None
    return 1e3 * t.traverse_s / t.frames
