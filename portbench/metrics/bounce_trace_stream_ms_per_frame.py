"""Integrator and shading (render/integrator.py): stream milliseconds a
frame of the bounce rays, their traversal call and the hit interpolation
after it (emission, envmap MIS, the next vertex), the spans
``bounce/trace`` and ``bounce/hit`` at every bounce, median over the
frames the port's span registry holds."""

from portbench import program_spans


def read(ctx):
    return program_spans.stream_ms(("bounce/trace", "bounce/hit"))
