"""Integrator and shading (models/principled.py): stream milliseconds a
frame of the principled BSDF's eval and sample, the spans
``principled/eval`` (RIS's winner inside ``bounce/direct``, ReSTIR's final
shading) and ``principled/sample`` (inside ``bounce/bsdf``), one kernel
launch each on the card, median over the frames the port's span registry
holds. A port without the spans gives None."""

from portbench import program_spans


def read(ctx):
    return program_spans.stream_ms(("principled/eval", "principled/sample"))
