"""Routing (ops/routing.py, ops/cuda_traverse.py,
ops/traverse.py:occluded_alpha): the alpha march's closest-hit segments a
frame, from the port's march_counts over the traced frames; only scenes
with alpha textures march."""


def read(ctx):
    n = ctx.get("march_segments")
    return n if n else None
