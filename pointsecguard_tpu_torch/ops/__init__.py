"""Point-cloud ops of the port (the JAX package's ``ops`` slice that the
PointNet++, RandLA-Net and ResGCN paths run)."""

from pointsecguard_tpu_torch.ops.distance import square_distance
from pointsecguard_tpu_torch.ops.gather import gather_points
from pointsecguard_tpu_torch.ops.grouping import (
    group_relative,
    sample_and_group,
    sample_and_group_all,
)
from pointsecguard_tpu_torch.ops.interpolate import (
    apply_three_nn,
    nearest_upsample,
    three_nn_plan,
    three_nn_weights,
)
from pointsecguard_tpu_torch.ops.neighbors import (
    ball_query,
    dense_knn_graph,
    dilate_neighbors,
    knn,
    repeat_pad_k,
)
from pointsecguard_tpu_torch.ops.sampling import (
    farthest_point_sample,
    random_sample_pool,
)
from pointsecguard_tpu_torch.ops.selection import bottom_k_indices

__all__ = [
    "apply_three_nn",
    "ball_query",
    "dense_knn_graph",
    "dilate_neighbors",
    "bottom_k_indices",
    "farthest_point_sample",
    "gather_points",
    "group_relative",
    "knn",
    "nearest_upsample",
    "random_sample_pool",
    "repeat_pad_k",
    "sample_and_group",
    "sample_and_group_all",
    "square_distance",
    "three_nn_plan",
    "three_nn_weights",
]
