"""Integrator and shading (render/integrator.py, lights/): stream
milliseconds a frame of direct light at every bounce, the spans
``bounce/direct`` (NEE or RIS with its shadow rays, the alpha march
``march`` included), median over the frames the port's span registry
holds."""

from portbench import program_spans


def read(ctx):
    return program_spans.stream_ms(("bounce/direct",))
