"""Carry scenes, BVHs and render states across from the JAX package.

The JAX package's ``SceneData`` (with its texture atlas and envmap),
``BVHData``, ``RenderState`` (also a rank's slice of its sample-DP state
and a shard's rows of its pixel-sharded state), ReSTIR ``Reservoir``,
``WorldSettings`` and the learned denoiser's weights are given as dicts of
numpy arrays keyed by field name (nested dicts for the material bank, the
G-buffers and the reservoirs), so this
module imports nothing of JAX. ``to_numpy`` turns a port dataclass back into
such a dict. Each ``*_from_numpy`` puts its tensors on ``device``: the GPU
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .accel.build import (MAX_MEGANODE_ROWS, BVHData, Lane8Sizes, depth8_of,
                          meganode_depth)
from .assets.scene import EnvmapData, SceneData, TextureAtlas
from .core.device import resolve_device
from .core.material import FIELD_NAMES, MaterialBank
from .core.settings import WorldSettings
from .core.state import GBuffer, RenderState
from .restir.reservoir import Reservoir


def _t(x, device):
    return torch.from_numpy(np.array(x)).to(device)


def atlas_from_numpy(d: dict, device=None) -> TextureAtlas:
    """TextureAtlas from the JAX package's atlas fields."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(TextureAtlas):
        v = d[f.name]
        kw[f.name] = (tuple(v) if isinstance(v, (tuple, list))
                      else _t(v, device) if isinstance(v, np.ndarray) else v)
    return TextureAtlas(**kw)


def envmap_from_numpy(d: dict, device=None) -> EnvmapData:
    """EnvmapData from the JAX package's envmap fields."""
    device = resolve_device(device)
    return EnvmapData(
        total_luminance=float(np.asarray(d["total_luminance"])),
        **{k: _t(d[k], device)
           for k in ("texels", "cdf", "alias_probas", "alias_indices")})


def world_from_numpy(d: dict) -> WorldSettings:
    """WorldSettings (host values) from the JAX package's world fields."""
    def rows(x):
        return tuple(tuple(float(c) for c in r) for r in np.asarray(x))

    return WorldSettings(
        ambient_light_type=int(np.asarray(d["ambient_light_type"])),
        uniform_light_color=tuple(
            float(c) for c in np.asarray(d["uniform_light_color"])),
        envmap_intensity=float(np.asarray(d["envmap_intensity"])),
        envmap_to_world=rows(d["envmap_to_world"]),
        world_to_envmap=rows(d["world_to_envmap"]))


def scene_from_numpy(d: dict, device=None) -> SceneData:
    """SceneData from the JAX package's scene fields, with its texture
    atlas and envmap."""
    device = resolve_device(device)
    mats = MaterialBank(**{k: _t(d["materials"][k], device) for k in FIELD_NAMES})
    kw = {}
    for f in dataclasses.fields(SceneData):
        if f.name in ("materials", "envmap", "textures"):
            continue
        v = d[f.name]
        if f.name == "num_emissives":
            kw[f.name] = int(np.asarray(v))
        elif f.name == "emissive_total_area":
            kw[f.name] = float(np.asarray(v))
        else:
            kw[f.name] = _t(v, device)
    textures = d.get("textures")
    if textures is not None:
        textures = atlas_from_numpy(textures, device)
    envmap = d.get("envmap")
    if envmap is not None:
        envmap = envmap_from_numpy(envmap, device)
    return SceneData(materials=mats, textures=textures, envmap=envmap, **kw)


def bvh4_depth(nodes4: np.ndarray) -> int:
    """Max internal-node depth (root = 1) of a BVH4 table: internal child
    refs are > 0 (ref 0 is the root, which is nobody's child, and marks an
    empty slot)."""
    refs = np.ascontiguousarray(nodes4[:, 24:28]).view(np.int32)
    frontier = np.zeros((1,), np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        ch = refs[frontier].ravel()
        frontier = ch[ch > 0].astype(np.int64)
    return depth


def bvh_from_numpy(d: dict, device=None) -> BVHData:
    """BVHData from the JAX package's ``nodes4``, ``leaf_rows``,
    ``tri_rows`` and, optionally, its meganode table ``nodes``, its BVH8
    ``nodes8l`` + ``leaf_rows8`` and its lane8 tables (``nodes_lane8``,
    ``leaves_lane8``, ``lane8_depth``, of which only the sizes are kept).
    The depths are measured here when not given; a meganode table of more
    than MAX_MEGANODE_ROWS rows is dropped, as ``build_bvh`` drops it."""
    device = resolve_device(device)
    nodes4 = np.asarray(d["nodes4"], np.float32)
    depth4 = d.get("depth4")
    nodes = d.get("nodes")
    if nodes is not None:
        nodes = np.asarray(nodes, np.float32)
    depth2 = d.get("depth2")
    if depth2 is None:
        depth2 = meganode_depth(nodes) if nodes is not None else 0
    if nodes is not None and nodes.shape[0] > MAX_MEGANODE_ROWS:
        nodes = None
    nodes8l, leaf_rows8, depth8 = d.get("nodes8l"), d.get("leaf_rows8"), 0
    if nodes8l is not None:
        nodes8l = np.asarray(nodes8l, np.float32)
        depth8 = d.get("depth8") or depth8_of(nodes8l)
        nodes8l = _t(nodes8l, device)
        leaf_rows8 = _t(np.asarray(leaf_rows8, np.float32), device)
    lane8 = None
    if d.get("leaves_lane8") is not None:
        leaves, row_bytes = np.shape(d["leaves_lane8"])
        lane8 = Lane8Sizes(nodes=int(np.shape(d["nodes_lane8"])[0]),
                           leaves=int(leaves), row_bytes=int(row_bytes),
                           depth=int(d["lane8_depth"]))
    return BVHData(
        nodes4=_t(nodes4, device),
        leaf_rows=_t(np.asarray(d["leaf_rows"], np.float32), device),
        tri_rows=_t(np.asarray(d["tri_rows"], np.float32), device),
        depth4=int(depth4) if depth4 is not None else bvh4_depth(nodes4),
        nodes=None if nodes is None else _t(nodes, device),
        depth2=int(depth2),
        nodes8l=nodes8l, leaf_rows8=leaf_rows8, depth8=int(depth8),
        lane8=lane8,
    )


def _gbuffer(d: dict, device) -> GBuffer:
    return GBuffer(**{f.name: _t(d[f.name], device)
                      for f in dataclasses.fields(GBuffer)})


def reservoir_from_numpy(d: dict, device=None) -> Reservoir:
    """Reservoir from the JAX package's reservoir fields."""
    device = resolve_device(device)
    return Reservoir(**{f.name: _t(d[f.name], device)
                        for f in dataclasses.fields(Reservoir)})


def state_from_numpy(d: dict, device=None) -> RenderState:
    """RenderState from the JAX package's state fields, with its ReSTIR
    reservoirs when it has them."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(RenderState):
        if f.name == "restir":
            v = d.get(f.name)
            kw[f.name] = None if v is None else reservoir_from_numpy(v, device)
            continue
        v = d[f.name]
        if f.name in ("gbuffer", "prev_gbuffer"):
            kw[f.name] = _gbuffer(v, device)
        elif f.name in ("sample_count", "seed"):
            kw[f.name] = int(np.asarray(v))
        elif f.name in ("rays_traced", "nb_pixels_converged"):
            kw[f.name] = torch.tensor(int(np.asarray(v)), dtype=torch.int64,
                                      device=device)
        else:
            kw[f.name] = _t(v, device)
    return RenderState(**kw)


def _map_arrays(d, fn):
    """A nested dict of numpy arrays with ``fn`` applied to each array."""
    if isinstance(d, dict):
        return {k: _map_arrays(v, fn) for k, v in d.items()}
    return fn(np.asarray(d)) if d is not None else None


def sample_dp_state_from_numpy(d: dict, rank: int, device=None) -> RenderState:
    """Rank ``rank``'s RenderState of a JAX sample-DP state (its
    ``init_sample_dp_state``: every field stacked on a leading 'samples'
    axis, one slice per device): the k-th slice, the state that the port's
    sample-DP rank k holds (parallel/mesh.py)."""
    return state_from_numpy(_map_arrays(d, lambda a: a[rank]), device)


def shard_state_from_numpy(d: dict, start: int, stop: int,
                           device=None) -> RenderState:
    """The RenderState of pixels [start, stop) of a JAX pixel-sharded state
    (the whole image's fields, as ``jax.device_get`` gives them): its
    per-pixel rows, and the counters, which are the image's; the state that
    the port's pixel shard [start, stop) holds (parallel/mesh.py)."""
    n = np.asarray(d["accum"]).shape[0]
    return state_from_numpy(_map_arrays(
        d, lambda a: a[start:stop] if a.ndim >= 1 and a.shape[0] == n else a),
        device)


def denoiser_params_from_numpy(d: dict, device=None):
    """render/denoise_nn.py's DenoiserNet from the JAX package's denoiser
    weights (``w{i}`` HWIO, ``b{i}``, as its data_denoiser.npz holds them):
    each weight goes to OIHW."""
    from .render.denoise_nn import DenoiserNet

    net = DenoiserNet()
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            conv.weight.copy_(torch.from_numpy(
                np.asarray(d[f"w{i}"], np.float32).transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(np.asarray(d[f"b{i}"], np.float32)))
    return net.to(resolve_device(device))


def to_numpy(obj):
    """A port dataclass (or tensor) → nested dict of numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj
