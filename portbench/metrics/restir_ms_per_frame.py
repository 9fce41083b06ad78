"""ReSTIR DI (restir/di.py through render_step's ``stage``): device
milliseconds a frame of the reservoir passes, each pass bracketed once by
CUDA events through the stage hook."""


def read(ctx):
    return ctx.get("restir_ms")
