"""Multi-device rendering — pixel and sample data parallelism over
``torch.distributed``, mirroring ``hiprt_pt_tpu.parallel.mesh``.

The JAX package runs one program over a device mesh, and XLA makes every
global decision of the render step for it. The port runs one process per
rank (a frame is tens of thousands of host launches, which one process
driving several devices would serialise), each on its own device, in a
process group that the caller has initialised (``torch.distributed.
init_process_group``; parallel/launch.py starts ranks on one host):

- **Pixel DP** (``make_mesh``, axis "pixels"): rank k renders the k-th of
  ``size`` equal ranges of whole 128-pixel tiles of the canonical
  (tile-major) order: the RIS light tiles, ReSTIR's tile ids and the
  coherent kernel's packets stay whole. ``render_step(..., shard=...)``
  keys each pixel by its index in the image and makes its global decisions
  through the group (``Shard``): the bounce skip and the alpha march's
  segment skip, the ray and converged-pixel counters, ReSTIR's neighbour
  rows, so that the ranks' states put together are one device's, bit for
  bit. ``gather_render_state`` puts them together.
- **Sample DP** (``make_sample_mesh``, axis "samples"): every rank renders
  the whole image with its own seed (seed + 9176·rank); ReSTIR's reuse
  reads the rank's own reservoirs; ``merge_sample_dp`` averages the
  accumulations.

Scene, BVH, camera and world are replicated: rank 0 builds them and
``replicate`` broadcasts their tensors. A backend runs the collectives:
NCCL with one rank per card, gloo with several ranks on one card (NCCL
refuses two ranks on one device) or on the CPU. Gloo runs only some
collectives on CUDA tensors (GLOO_CUDA_OPS); ``_collective`` stages the
others through a host copy.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..core.settings import LightSamplingStrategy
from ..core.state import RenderState, init_render_state
from ..ops.pixel_order import TILE_H, TILE_W, PixelRange, is_tileable

TILE = TILE_W * TILE_H
# deterministic per-rank seed decorrelation stride of sample DP (the JAX
# package's _SAMPLE_DP_SEED_STRIDE)
_SAMPLE_DP_SEED_STRIDE = 9176
# the collectives gloo runs on CUDA tensors (torch.distributed's backend
# table); the others are staged through a host copy
GLOO_CUDA_OPS = ("broadcast", "all_reduce")
# bytes between two tensors of replicate's buffer: each keeps the alignment
# of an allocation (the kernels read tables with 16-byte loads)
_ALIGN = 512

# the collectives' calls and host seconds since reset_collective_stats(),
# by operation; with ``sync`` the device is synchronised before each is
# timed, so that the seconds are the collective's own and its wait for the
# other ranks, not the queued work it waits for
collective_stats: dict = {}


def reset_collective_stats(sync: bool = False) -> None:
    collective_stats.clear()
    collective_stats.update(calls={}, seconds={}, sync=sync)


reset_collective_stats()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: its rank and the group's size, the
    process group (None: the default group), its device and the axis."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_name: str = "pixels"

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank``."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def shard(self, width: int, height: int) -> "Shard":
        """This rank's pixel shard of a width x height image."""
        start, stop = shard_bounds(width, height, self.size, self.rank)
        return Shard(width, height, start, stop, self)


def _default_device() -> torch.device:
    """cuda:<local rank> when the host has a card per local rank, else
    cuda:0, which the ranks share; no CUDA device raises, as at every entry
    point (core/device.py)."""
    resolve_device()
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                    dist.get_world_size()))
    if torch.cuda.device_count() >= local_size:
        return torch.device("cuda", local)
    return torch.device("cuda", 0)


def make_mesh(group=None, device=None, axis_name: str = "pixels") -> Mesh:
    """This rank's mesh over ``group`` (default: the default process group,
    which must be initialised). ``device``: the rank's device (default:
    cuda:<local rank>, or cuda:0 when the ranks share one card; "cpu" only
    when asked for)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "parallel/launch.py:launch)")
    device = torch.device(device) if device is not None else _default_device()
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), device=device,
                axis_name=axis_name)


def make_sample_mesh(group=None, device=None) -> Mesh:
    """A mesh over the sample axis (sample DP: every rank renders the whole
    image with its own seed; the accumulations merge by their mean)."""
    return make_mesh(group, device, axis_name="samples")


def _tile_range(n: int, size: int, rank: int, what: str):
    tiles, rest = divmod(n, TILE)
    if rest or tiles % size:
        raise ValueError(f"{what} is {n / TILE:g} tiles of {TILE} pixels, "
                         f"which do not split evenly over {size} ranks")
    per = tiles // size * TILE
    return rank * per, (rank + 1) * per


def shard_bounds(width: int, height: int, size: int, rank: int):
    """[start, stop) of rank ``rank``'s pixels: the image's 128-pixel tiles
    split into ``size`` equal, contiguous ranges of the canonical order.
    An image that is not tileable, or whose tiles do not split evenly,
    raises ValueError."""
    if not is_tileable(width, height):
        raise ValueError(f"{width}x{height} is not a whole number of "
                         f"{TILE_W}x{TILE_H} tiles, so it has no pixel shards")
    return _tile_range(width * height, size, rank, f"{width}x{height}")


# ------------------------------------------------------------ collectives


def _collective(mesh: Mesh, op: str, x: torch.Tensor, fn):
    """``fn(x)``, a collective on x: on a host copy where the backend has
    no CUDA form of ``op`` (gloo beyond GLOO_CUDA_OPS), the result back on
    x's device. Counts and times it (collective_stats)."""
    sync = collective_stats["sync"] and x.is_cuda
    if sync:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    staged = (x.is_cuda and mesh.backend == "gloo"
              and op not in GLOO_CUDA_OPS)
    out = fn(x.cpu() if staged else x)
    if staged:
        out = out.to(x.device)
    if sync:
        torch.cuda.synchronize(x.device)
    calls, secs = collective_stats["calls"], collective_stats["seconds"]
    calls[op] = calls.get(op, 0) + 1
    secs[op] = secs.get(op, 0.0) + time.perf_counter() - t0
    return out


def all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM):
    """x reduced over the mesh's ranks (a new tensor)."""
    def run(t):
        t = t.clone()
        dist.all_reduce(t, op=op, group=mesh.group)
        return t
    return _collective(mesh, "all_reduce", x, run)


def _broadcast_(x: torch.Tensor, mesh: Mesh, src: int) -> torch.Tensor:
    """x (contiguous) broadcast from mesh rank ``src``: in place, unless
    the backend stages it through the host."""
    def run(t):
        dist.broadcast(t, src=mesh.global_rank(src), group=mesh.group)
        return t
    return _collective(mesh, "broadcast", x, run)


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Mesh rank ``src``'s x on every rank (a new tensor; x must have its
    shape and dtype)."""
    return _broadcast_(x.clone(memory_format=torch.contiguous_format),
                       mesh, src)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x (each of the same shape) concatenated along dim 0 in
    rank order."""
    if x.dtype == torch.bool:
        return all_gather_rows(x.view(torch.uint8), mesh).view(torch.bool)

    def run(t):
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t, group=mesh.group)
        return torch.cat(parts, dim=0)
    return _collective(mesh, "all_gather", x.contiguous(), run)


@dataclasses.dataclass(frozen=True)
class Shard(PixelRange):
    """A rank's pixel range (ops/pixel_order.py:PixelRange) whose global
    decisions are its mesh's collectives. Rank k holds the k-th range, so
    mesh rank 0 holds pixel 0."""

    mesh: Mesh

    def any(self, flag: torch.Tensor) -> bool:
        own = flag.any().to(torch.int32).reshape(1)
        return bool(all_reduce(own, self.mesh, dist.ReduceOp.MAX).item())

    def count(self, flag: torch.Tensor) -> int:
        own = flag.sum().reshape(1)
        return int(all_reduce(own, self.mesh).item())

    def sum(self, count: torch.Tensor) -> torch.Tensor:
        return all_reduce(count, self.mesh)

    def gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(rows, self.mesh)

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        return broadcast(x, self.mesh, src=0)


# ------------------------------------------------------------ replication


class _TensorPickler(pickle.Pickler):
    """Pickles a tree with its tensors left out, each replaced by its index,
    shape and dtype."""

    def __init__(self, f, tensors: list):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.tensors = tensors

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            self.tensors.append(obj)
            return (len(self.tensors) - 1, tuple(obj.shape), obj.dtype)
        return None


class _TensorUnpickler(pickle.Unpickler):
    """Rebuilds a tree, its tensors from ``make(index, shape, dtype)``."""

    def __init__(self, f, make):
        super().__init__(f)
        self.make = make

    def persistent_load(self, pid):
        return self.make(*pid)


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


def replicate(tree, mesh: Mesh, src: int = 0):
    """Mesh rank ``src``'s ``tree`` (a scene, BVH, camera, world, settings:
    any picklable object whose arrays are tensors) on every rank, its
    tensors on the rank's device and bit-identical to ``src``'s; the other
    ranks may pass None. The tree's structure is broadcast as a pickle
    without its tensors, then the tensors' bytes in one buffer."""
    tensors: list = []
    if mesh.rank == src:
        buf = io.BytesIO()
        _TensorPickler(buf, tensors).dump(tree)
        skeleton = torch.frombuffer(bytearray(buf.getvalue()),
                                    dtype=torch.uint8).to(mesh.device)
        length = torch.tensor([skeleton.numel()], dtype=torch.int64,
                              device=mesh.device)
    else:
        length = torch.zeros((1,), dtype=torch.int64, device=mesh.device)
    length = _broadcast_(length, mesh, src)
    if mesh.rank != src:
        skeleton = torch.empty((int(length.item()),), dtype=torch.uint8,
                               device=mesh.device)
    skeleton = _broadcast_(skeleton, mesh, src)
    raw = skeleton.cpu().numpy().tobytes()

    slots = []

    def collect(i, shape, dtype):
        slots.append((i, shape, dtype))

    _TensorUnpickler(io.BytesIO(raw), collect).load()
    offsets, total = {}, 0
    for i, shape, dtype in slots:
        offsets[i] = total
        total += -(-_nbytes(shape, dtype) // _ALIGN) * _ALIGN
    blob = torch.zeros((max(total, 1),), dtype=torch.uint8, device=mesh.device)
    if mesh.rank == src:
        for i, _shape, _dtype in slots:
            t = tensors[i].detach().to(mesh.device).contiguous()
            off = offsets[i]
            blob[off:off + t.numel() * t.element_size()] = (
                t.reshape(-1).view(torch.uint8))
    blob = _broadcast_(blob, mesh, src)

    def make(i, shape, dtype):
        off = offsets[i]
        piece = blob[off:off + _nbytes(shape, dtype)]
        return piece.view(dtype).reshape(shape)

    return _TensorUnpickler(io.BytesIO(raw), make).load()


# ------------------------------------------------------------ render states


def map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to each of its tensors, through nested
    dataclasses (the G-buffers, the reservoirs); other fields as they
    are."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


def _map_pixels(state: RenderState, fn) -> RenderState:
    """``state`` with ``fn`` applied to its per-pixel tensors (leading dim
    the state's pixel count)."""
    n = state.num_pixels
    return map_tensors(state, lambda x: fn(x) if x.ndim >= 1
                        and x.shape[0] == n else x)


def shard_render_state(state: RenderState, mesh: Mesh) -> RenderState:
    """This rank's shard of a whole-image state: the per-pixel fields sliced
    to its range, every field on its device; the counters stay the
    image's."""
    start, stop = _tile_range(state.num_pixels, mesh.size, mesh.rank,
                              f"a state of {state.num_pixels} pixels")
    state = _map_pixels(state, lambda x: x[start:stop])
    return map_tensors(state, lambda x: x.to(mesh.device).contiguous())


def init_sharded_render_state(width: int, height: int, mesh: Mesh,
                              seed: int = 42,
                              with_restir: bool = False) -> RenderState:
    """This rank's shard of a fresh state, built directly on its device."""
    start, stop = shard_bounds(width, height, mesh.size, mesh.rank)
    return init_render_state(width, height, seed, mesh.device,
                             with_restir=with_restir, pixels=stop - start)


def gather_render_state(state: RenderState, mesh: Mesh, dst: int = 0):
    """The whole-image state of the ranks' shards, in the canonical order,
    on mesh rank ``dst``; the other ranks get None. Every rank must call
    it."""
    full = _map_pixels(state, lambda x: all_gather_rows(x, mesh))
    return full if mesh.rank == dst else None


def init_sample_dp_state(width: int, height: int, mesh: Mesh, seed: int = 42,
                         with_restir: bool = False) -> RenderState:
    """This rank's whole-image state of sample DP, seeded seed + 9176·rank
    (the JAX package's k-th slice of its stacked 'samples' axis)."""
    return init_render_state(width, height,
                             seed + _SAMPLE_DP_SEED_STRIDE * mesh.rank,
                             mesh.device, with_restir=with_restir)


def sample_dp_render(options, width: int, height: int, scene, bvh, camera,
                     settings, world, mesh: Mesh,
                     state: RenderState) -> RenderState:
    """One render step of this rank's whole-image state (sample DP): the
    same scene and camera on every rank, the rank's own seed; ReSTIR's
    temporal and spatial reuse read the rank's own reservoirs. The
    accumulation stays the rank's; merge_sample_dp averages it."""
    from ..render.renderer import render_step

    return render_step(options, width, height, scene, bvh, state, camera,
                       settings, world)


def merge_sample_dp(state: RenderState, mesh: Mesh):
    """(The mean of the ranks' accumulations (N,3), the total sample count
    over the ranks), on every rank."""
    accum = all_reduce(state.accum, mesh) / mesh.size
    count = torch.tensor([state.sample_count], dtype=torch.int64,
                         device=state.accum.device)
    return accum, int(all_reduce(count, mesh).item())


def distributed_render(options, width: int, height: int, scene, bvh, camera,
                       settings, world, mesh: Mesh,
                       state: Optional[RenderState] = None) -> RenderState:
    """One render step of this rank's pixel shard (seed 42 when no state is
    given); the counters and the step's global decisions are the image's.
    ``scene``, ``bvh``, ``camera``: the rank's copies (replicate)."""
    from ..render.renderer import render_step

    if state is None:
        state = init_sharded_render_state(
            width, height, mesh, 42, with_restir=options.direct_light_sampling
            == LightSamplingStrategy.RESTIR_DI)
    return render_step(options, width, height, scene, bvh, state, camera,
                       settings, world, shard=mesh.shard(width, height))
