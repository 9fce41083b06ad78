"""Integrator and shading (render/integrator.py): the share of the
bounce loop's lanes whose path is alive at the bounce's start, 100 x the
port's counters live / lanes summed over a frame's bounces, median over
the frames the port's span registry holds."""

from portbench import program_spans


def read(ctx):
    return program_spans.share("live", "lanes")
