"""Host set-up (accel/build.py): seconds of the BVH8 collapse
(``collapse8_linear``) in the run's BVH build, the port's host span
``bvh/collapse8`` of its set-up step, which the span registry holds apart
from the frames. None where the port has no such span, or built no BVH8."""

from portbench import program_spans


def read(ctx):
    ms = program_spans.stream_ms(("bvh/collapse8",))
    return None if ms is None else ms / 1e3
