"""Kernels (csrc/traverse.cu, csrc/traverse8.cu): stream milliseconds a
frame of the traversal calls, the port's spans ``trace/<kernel>`` (one a
call of a routed kernel's wrapper, ops/cuda_traverse.py), summed over the
frame, median over the frames the port's span registry holds. A port
without those spans gives None."""

from portbench import program_spans

KERNELS = ("trace_coherent", "trace_incoherent", "trace_meganode",
           "trace_stream8", "trace_lane8log")


def read(ctx):
    return program_spans.stream_ms(["trace/" + k for k in KERNELS])
