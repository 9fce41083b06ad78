"""Frame loop (render/renderer.py): host synchronisations a frame, counted
from the profiler's CUDA runtime events (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize and the synchronous cudaMemcpy)
over the traced frames."""


def read(ctx):
    t = ctx.get("trace")
    return None if t is None else t.syncs / t.frames
