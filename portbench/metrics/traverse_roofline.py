"""Kernels (csrc/traverse*.cu): the traversal kernels' share of their
roofline over one traced frame: the least time of each of the frame's
traversal launches (portbench/yardstick.py:least_seconds, its box and
triangle tests counted by the reference's own walk over the reference's
own BVH on the launch's captured rays), summed, over the trace_*_kernel
device time of that frame."""


def read(ctx):
    r = ctx.get("roofline")
    if r is None or r["kernel_s"] <= 0 or r["least_s"] <= 0:
        return None
    return 100.0 * r["least_s"] / r["kernel_s"]
