"""Integrator and shading (render/integrator.py, models/): stream
milliseconds a frame of material fetch and BSDF sampling at every bounce,
the spans ``bounce/material`` and ``bounce/bsdf``, median over the frames
the port's span registry holds."""

from portbench import program_spans


def read(ctx):
    return program_spans.stream_ms(("bounce/material", "bounce/bsdf"))
