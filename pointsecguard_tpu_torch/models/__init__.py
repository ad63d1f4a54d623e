"""Models of the port (PointNet++ SSG and RandLA-Net so far)."""

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

__all__ = ["PointNet2SemSegSSG", "RandLANet", "build_geometry", "build_pyramid",
           "init_parameters", "weighted_nll_loss", "weighted_softmax_ce_loss"]
