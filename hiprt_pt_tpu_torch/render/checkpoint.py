"""Render-state checkpoint / resume, in the file format of
``hiprt_pt_tpu.render.checkpoint``, so that a checkpoint written by either
package loads in the other.

The file is an .npz of the state's leaves ``leaf_{i}``, in the order in
which ``jax.tree_util`` flattens the JAX package's ``RenderState``: its
fields in declaration order (core/state.py, the same order as here), the
``GBuffer`` and ``Reservoir`` fields nested in their own order, and a
``restir`` of None dropped. Each leaf has the JAX package's shape and
dtype: ``sample_count`` an int32 scalar, ``seed`` a uint32 scalar,
``nb_pixels_converged`` an int32 scalar and ``rays_traced`` an f32 scalar
(the port keeps the first two as host ints and the last two as int64
tensors). An f32 count is inexact past 2^24 rays (one 1920x1080 frame
traces 16 to 22 M), so the port also writes ``rays_traced_int64``, the
exact count, and prefers it on load; the JAX package's loader reads only
the ``leaf_{i}`` keys. The port writes the file uncompressed (np.savez: a
1920x1080 state is about 560 MB, which zlib takes tens of seconds to
compress); np.load reads the JAX package's compressed files too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.state import RenderState

# the leaves that the port holds on the host or as int64, with the JAX
# package's dtype for each
_SCALARS = {"sample_count": np.int32, "seed": np.uint32,
            "nb_pixels_converged": np.int32, "rays_traced": np.float32}
_EXACT_RAYS = "rays_traced_int64"


def _leaves(obj, prefix=()):
    """(field path, value) of every leaf, in jax.tree_util's order."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + (f.name,))
        else:
            yield prefix + (f.name,), v


def _path(npz_path: str) -> str:
    return npz_path if npz_path.endswith(".npz") else npz_path + ".npz"


def save_checkpoint(path: str, state: RenderState):
    """Write ``state`` to ``path`` (".npz" appended when missing)."""
    arrays = {}
    for i, (name, v) in enumerate(_leaves(state)):
        if len(name) == 1 and name[0] in _SCALARS:
            arrays[f"leaf_{i}"] = np.asarray(int(v), np.int64).astype(
                _SCALARS[name[0]])
        else:
            arrays[f"leaf_{i}"] = v.detach().cpu().numpy()
    arrays[_EXACT_RAYS] = np.asarray(int(state.rays_traced), np.int64)
    np.savez(_path(path), **arrays)


def load_checkpoint(path: str, template: RenderState) -> RenderState:
    """Restore into the structure of ``template`` (the same resolution and
    the same ReSTIR on/off configuration), on its device; raises
    ValueError when a leaf's shape or the number of leaves differs."""
    leaves = list(_leaves(template))
    with np.load(_path(path)) as data:
        stored = sum(1 for k in data.files if k.startswith("leaf_"))
        if stored != len(leaves):
            raise ValueError(f"checkpoint has {stored} leaves, the template "
                             f"{len(leaves)} (ReSTIR on in one, off in the other?)")
        values = {}
        for i, (name, leaf) in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            shape = () if not isinstance(leaf, torch.Tensor) else tuple(leaf.shape)
            if arr.shape != shape:
                raise ValueError(f"checkpoint leaf {i} ({'.'.join(name)}) shape "
                                 f"{arr.shape} != template {shape}")
            if name in (("sample_count",), ("seed",)):
                values[name] = int(arr)
            elif name in (("rays_traced",), ("nb_pixels_converged",)):
                count = (data[_EXACT_RAYS] if name == ("rays_traced",)
                         and _EXACT_RAYS in data.files else arr)
                values[name] = torch.tensor(int(count), dtype=torch.int64,
                                            device=leaf.device)
            else:
                values[name] = torch.from_numpy(arr).to(leaf.device, leaf.dtype)
    return _rebuild(template, values)


def _rebuild(obj, values, prefix=()):
    """``obj`` with every leaf replaced from ``values`` (by field path)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + (f.name,)
        if dataclasses.is_dataclass(v):
            kw[f.name] = _rebuild(v, values, key)
        elif v is not None:
            kw[f.name] = values[key]
    return dataclasses.replace(obj, **kw)
