"""How the port runs the ``pointnet2_ssg`` configurations: its
``models/pointnet2.py`` ``PointNet2SemSegSSG`` and the trainer's family
for it, at the sizes the port fixes, which have to be the configuration's."""

from __future__ import annotations

import torch

PRESET = "pointnet2"  # the attack presets' model family


def build(cfg: dict, device, precision: str):
    """(model on ``device``, family) of the port; raises where the port's
    sizes are not the configuration's."""
    from pointsecguard_tpu_torch.models import pointnet2
    from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS
    from pointsecguard_tpu_torch.utils.runtime import model_dtype

    fixed = {"sa_npoints": pointnet2.SSG_NPOINTS, "sa_radii": pointnet2.SSG_RADII,
             "sa_nsamples": pointnet2.SSG_NSAMPLES, "sa_mlps": pointnet2.SSG_SA_MLPS,
             "fp_mlps": pointnet2.SSG_FP_MLPS}
    for key, value in fixed.items():
        if [list(v) if isinstance(v, tuple) else v for v in value] != cfg[key]:
            raise ValueError(f"the port's PointNet++ SSG has {key} {value}, "
                             f"the configuration {cfg[key]}")
    model_cls, family = POINTNET_MODELS["pointnet2"]
    model = model_cls(num_classes=cfg["num_classes"], in_features=cfg["in_channels"],
                      dtype=model_dtype(precision))
    return model.to(device), family


graphs = None  # the geometry is the plan's: ``geometry_arrays``


def geometry_arrays(plan: dict) -> list[torch.Tensor]:
    """The plan's centres, group indices and 3-NN indices, in the order of
    the reference's ``geometry_arrays``."""
    return ([c for c, _ in plan["sa"]] + [i for _, i in plan["sa"]]
            + [i for i, _ in plan["fp"]])
