"""Integrator and shading (render/integrator.py, models/, lights/, restir/):
device milliseconds a frame of every kernel and copy not named
trace_*_kernel, from the profiler's trace."""


def read(ctx):
    t = ctx.get("trace")
    return None if t is None else 1e3 * t.integrator_s / t.frames
