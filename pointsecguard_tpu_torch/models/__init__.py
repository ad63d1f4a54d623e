"""Models of the port (PointNet++ SSG, RandLA-Net and ResGCN-28 so far)."""

from pointsecguard_tpu_torch.models.common import init_parameters
from pointsecguard_tpu_torch.models.pointnet2 import (
    PointNet2SemSegSSG,
    build_geometry,
    weighted_nll_loss,
)
from pointsecguard_tpu_torch.models.randlanet import (
    RandLANet,
    build_pyramid,
    weighted_softmax_ce_loss,
)
from pointsecguard_tpu_torch.models.resgcn import DenseDeepGCN

__all__ = ["DenseDeepGCN", "PointNet2SemSegSSG", "RandLANet", "build_geometry",
           "build_pyramid", "init_parameters", "weighted_nll_loss",
           "weighted_softmax_ce_loss"]
