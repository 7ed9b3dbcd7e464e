"""Distribution layer of the port: the collectives backend seam
(Torrent gradient reduction, ring collectives, the multi-chain
broadcast plan)."""

from .collectives import (
    GradBucket,
    MultiChainPlan,
    all_reduce_shards,
    assign_buckets,
    bucket_shard_layout,
    ef_residual_init,
    resolve_ring_chains,
    ring_order_for_axis,
    torrent_all_gather,
    torrent_all_to_all,
    torrent_grad_reduce,
    torrent_joint_grad_reduce,
    torrent_reduce_scatter,
)

__all__ = [
    "GradBucket",
    "MultiChainPlan",
    "all_reduce_shards",
    "assign_buckets",
    "bucket_shard_layout",
    "ef_residual_init",
    "resolve_ring_chains",
    "ring_order_for_axis",
    "torrent_all_gather",
    "torrent_all_to_all",
    "torrent_grad_reduce",
    "torrent_joint_grad_reduce",
    "torrent_reduce_scatter",
]
