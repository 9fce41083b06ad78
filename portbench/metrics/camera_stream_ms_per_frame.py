"""Integrator and shading (render/integrator.py): stream milliseconds a
frame of the camera pass, the span ``camera`` with its children, median
over the frames the port's span registry holds."""

from portbench import program_spans


def read(ctx):
    return program_spans.stream_ms(("camera",))
