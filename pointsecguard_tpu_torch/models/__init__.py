"""Models of the port: PointNet++ SSG and MSG, PointNet, RandLA-Net and
ResGCN-28 for segmentation; PointNet++ SSG and MSG and PointNet
classifiers."""

from pointsecguard_tpu_torch.models.common import init_parameters
from pointsecguard_tpu_torch.models.pointnet import (
    PointNetCls,
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
from pointsecguard_tpu_torch.models.pointnet2_cls import (
    PointNet2ClsMSG,
    PointNet2ClsSSG,
    build_geometry_cls,
    build_geometry_cls_msg,
)
from pointsecguard_tpu_torch.models.randlanet import (
    RandLANet,
    build_pyramid,
    weighted_softmax_ce_loss,
)
from pointsecguard_tpu_torch.models.resgcn import DenseDeepGCN

__all__ = ["DenseDeepGCN", "PointNet2ClsMSG", "PointNet2ClsSSG", "PointNet2SemSegMSG",
           "PointNet2SemSegSSG", "PointNetCls", "PointNetSemSeg", "RandLANet",
           "build_geometry", "build_geometry_cls", "build_geometry_cls_msg",
           "build_geometry_msg",
           "build_pyramid", "feature_transform_regularizer", "init_parameters",
           "pointnet_aux_loss", "weighted_nll_loss", "weighted_softmax_ce_loss"]
