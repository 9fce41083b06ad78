"""Multi-device and multi-process rendering on ``torch.distributed``,
mirroring ``hiprt_pt_tpu.parallel``: pixel and sample data parallelism
(mesh.py), the frame-sequence split (frames.py), and ranks on one host
(launch.py)."""

from .mesh import (
    distributed_render,
    gather_render_state,
    init_sample_dp_state,
    init_sharded_render_state,
    make_mesh,
    make_sample_mesh,
    merge_sample_dp,
    replicate,
    sample_dp_render,
    shard_render_state,
)

__all__ = [
    "make_mesh",
    "make_sample_mesh",
    "shard_render_state",
    "replicate",
    "init_sharded_render_state",
    "init_sample_dp_state",
    "sample_dp_render",
    "merge_sample_dp",
    "distributed_render",
    "gather_render_state",
]
