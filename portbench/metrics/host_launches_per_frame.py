"""Frame loop (render/renderer.py): host kernel launches a frame, counted
from the profiler's CUDA runtime events (cudaLaunchKernel,
cudaLaunchKernelExC, cuLaunchKernel, cuLaunchKernelEx, and cudaGraphLaunch
once a replay) over the traced frames."""


def read(ctx):
    t = ctx.get("trace")
    return None if t is None else t.launches / t.frames
