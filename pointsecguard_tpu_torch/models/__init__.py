"""Models of the port: PointNet++ SSG and MSG, PointNet, RandLA-Net and
ResGCN-28."""

from pointsecguard_tpu_torch.models.common import init_parameters
from pointsecguard_tpu_torch.models.pointnet import (
    PointNetSemSeg,
    feature_transform_regularizer,
    pointnet_aux_loss,
)
from pointsecguard_tpu_torch.models.pointnet2 import (
    PointNet2SemSegMSG,
    PointNet2SemSegSSG,
    build_geometry,
    build_geometry_msg,
    weighted_nll_loss,
)
from pointsecguard_tpu_torch.models.randlanet import (
    RandLANet,
    build_pyramid,
    weighted_softmax_ce_loss,
)
from pointsecguard_tpu_torch.models.resgcn import DenseDeepGCN

__all__ = ["DenseDeepGCN", "PointNet2SemSegMSG", "PointNet2SemSegSSG",
           "PointNetSemSeg", "RandLANet", "build_geometry", "build_geometry_msg",
           "build_pyramid", "feature_transform_regularizer", "init_parameters",
           "pointnet_aux_loss", "weighted_nll_loss", "weighted_softmax_ce_loss"]
