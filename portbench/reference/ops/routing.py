"""The reference's tracer: every batch of rays, coherent or not, goes
through its own walk (ops/traverse.py:walk) over its own BVH."""

from __future__ import annotations


def tracer(bvh, coherent: bool, use_kernels: bool = True):
    """The walk that serves a batch of rays: always ``walk``."""
    from .traverse import walk

    return walk
