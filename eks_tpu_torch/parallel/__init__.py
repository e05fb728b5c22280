"""Device-mesh parallelism: keypoint-axis and time-axis sharding of the
smoothing step (``parallel/mesh.py``)."""

from eks_tpu_torch.parallel.mesh import (
    filter_prefix_paired_sharded,
    filter_prefix_sharded,
    make_mesh,
    optimize_and_smooth_sharded,
    optimize_blocks_sharded,
    pad_and_shard_leading,
    shard_leading,
    shard_time,
    smooth_all_sharded,
    smooth_time_sharded,
    smoother_suffix_paired_sharded,
    smoother_suffix_sharded,
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
