"""The benchmark measures the port alone: the modules of JAX and of the JAX
package that a process holds, compared on whole top-level names (the part
before the first dot), since the port's name begins with the JAX
package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "hiprt_pt_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})
