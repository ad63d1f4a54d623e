"""Colour-perturbation attacks of the port: the PGD engine (NB / tar_NB)
and its reference presets (port of ``pointsecguard_tpu/attacks/__init__.py:59-130``).

C&W (NU / tar_NU), the ares registry, black-box and decision attacks,
defenses and noise controls are not ported yet.
"""

from __future__ import annotations

import dataclasses

from pointsecguard_tpu_torch.attacks.common import (
    AttackResult,
    make_target_labels,
    per_point_ce,
    per_sample_accuracy,
    point_accuracy,
)
from pointsecguard_tpu_torch.attacks.pgd import PGDConfig, pgd_color_attack

# The reference's PGD benchmark configurations, keyed by (model_family,
# attack). Sources: BASELINE.md / SURVEY.md §2.
_PRESETS: dict[tuple[str, str], PGDConfig] = {
    # PointNet++ (`PointNet/NB_nontarget_test_semseg.py:169` etc.)
    ("pointnet2", "nb"): PGDConfig(eps=0.1, alpha=0.05, iters=10),
    ("pointnet2", "tar_nb"): PGDConfig(
        eps=0.5, alpha=0.1, iters=500, targeted=True, ce_reduction="mean"
    ),
    # RandLA-Net / ares (`tester_S3DIS.py:142-145,277-280`)
    ("randla", "nb"): PGDConfig(
        eps=17.0, alpha=1.7, iters=10, loss="hinge", step_norm="l2",
        rand_init_eps=17.0 / 5.0,
    ),
    ("randla", "tar_nb"): PGDConfig(
        eps=10.0, alpha=1.0, iters=20, loss="hinge", step_norm="l2",
        targeted=True, rand_init_eps=2.0, early_exit_sr=0.90,
    ),
    # ResGCN (`ResGCN/sem_seg_dense/attacks.py:75,210`)
    ("resgcn", "nb"): PGDConfig(eps=0.3, alpha=2.0 / 255.0, iters=50),
    ("resgcn", "tar_nb"): PGDConfig(
        eps=0.4, alpha=0.04, iters=50, targeted=True, ce_reduction="mean"
    ),
}


def attack_preset(model: str, attack: str, **overrides) -> PGDConfig:
    """Reference PGD budget for (model, attack), with optional overrides.

    Targeted presets still need ``target=<class>``. The C&W presets (nu,
    tar_nu) are not ported yet and raise KeyError."""
    cfg = _PRESETS[(model, attack)]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = [
    "AttackResult",
    "PGDConfig",
    "attack_preset",
    "make_target_labels",
    "per_point_ce",
    "per_sample_accuracy",
    "pgd_color_attack",
    "point_accuracy",
]
