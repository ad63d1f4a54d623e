"""Models of the port (PointNet++ SSG so far)."""

from pointsecguard_tpu_torch.models.pointnet2 import (
    PointNet2SemSegSSG,
    build_geometry,
)

__all__ = ["PointNet2SemSegSSG", "build_geometry"]
