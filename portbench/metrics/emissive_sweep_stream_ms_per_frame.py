"""Integrator and shading (lights/light_sampling.py): stream milliseconds a
frame of the dense emissive sweep that finds the emitter each RIS or
ReSTIR BSDF candidate reaches, the span ``emissive_sweep`` (inside
``bounce/direct`` and ReSTIR's initial candidates), median over the frames
the port's span registry holds. A port without the span gives None."""

from portbench import program_spans


def read(ctx):
    return program_spans.stream_ms(("emissive_sweep",))
