"""Ranks, batch slicing and collectives for several devices (port of
``pointsecguard_tpu/parallel``): ``--devices N [--shard_points P]``. JAX's
``batch_sharding`` and ``replicated`` name sharding specs of a global
array; a rank here holds its part, so ``make_batch_put`` / ``shard_batch``
take their place."""

from pointsecguard_tpu_torch.parallel.mesh import (
    Mesh,
    RankContext,
    data_parallel_mesh,
    is_main,
    make_batch_put,
    make_mesh,
    make_stacked_batch_put,
    replicate,
    run_cli,
    shard_batch,
    spawn,
)
from pointsecguard_tpu_torch.parallel.spmd_ops import (
    all_gather,
    dp_map,
    gather_for_loss,
    gather_rows,
    knn_points_sharded,
    points_sharded_forward,
    sp_shapes_ok,
    sum_rows,
    sync_batchnorm,
)

__all__ = [
    "Mesh",
    "RankContext",
    "all_gather",
    "data_parallel_mesh",
    "dp_map",
    "gather_for_loss",
    "gather_rows",
    "is_main",
    "knn_points_sharded",
    "make_batch_put",
    "make_mesh",
    "make_stacked_batch_put",
    "points_sharded_forward",
    "replicate",
    "run_cli",
    "shard_batch",
    "sp_shapes_ok",
    "spawn",
    "sum_rows",
    "sync_batchnorm",
]
