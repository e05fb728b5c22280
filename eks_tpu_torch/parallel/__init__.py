"""Device-mesh parallelism: keypoint-axis and time-axis sharding of the
smoothing step. The public façade: the mesh and the sharded scans live in
``ops/shards.py``, the keypoint-axis optimizer and final pass in
``core.py``, the whole-step helpers in ``parallel/mesh.py``; nothing inside
the package imports this package."""

from eks_tpu_torch.core import optimize_blocks_sharded, smooth_all_sharded
from eks_tpu_torch.ops.shards import (
    filter_prefix_paired_sharded,
    filter_prefix_sharded,
    make_mesh,
    smoother_suffix_paired_sharded,
    smoother_suffix_sharded,
)
from eks_tpu_torch.parallel.mesh import (
    optimize_and_smooth_sharded,
    pad_and_shard_leading,
    shard_leading,
    shard_time,
    smooth_time_sharded,
)

__all__ = [
    "filter_prefix_paired_sharded",
    "filter_prefix_sharded",
    "make_mesh",
    "optimize_and_smooth_sharded",
    "optimize_blocks_sharded",
    "pad_and_shard_leading",
    "shard_leading",
    "shard_time",
    "smooth_all_sharded",
    "smooth_time_sharded",
    "smoother_suffix_paired_sharded",
    "smoother_suffix_sharded",
]
