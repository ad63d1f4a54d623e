"""Colour-perturbation attacks of the port: the PGD engine (NB / tar_NB,
and MIM with ``PGDConfig.momentum``), the C&W engine (NU / tar_NU), their
reference presets (port of ``pointsecguard_tpu/attacks/__init__.py:59-130``),
both with the per-step trajectory mode, the score-based NES, SPSA and
NAttack (``blackbox.py``), DeepFool (``deepfool.py``), the decision-based
Boundary and Evolutionary (``decision.py``; those three need one decision
per shape, the classifiers), the ares registry and benchmark harnesses
(``benchmark.py``: all eleven names), the equal-norm noise control, the
colour defenses ``cli.attack`` deploys and the coordinate defenses SOR and
SRS that ``cli.attack_object`` deploys.
"""

from __future__ import annotations

import dataclasses

from pointsecguard_tpu_torch.attacks.benchmark import (
    ATTACKS,
    AttackBenchmark,
    distortion_binsearch,
    iteration_curve,
    load_attack,
    run_registered_attack,
    worst_case_run,
)
from pointsecguard_tpu_torch.attacks.blackbox import (
    NAttackConfig,
    NESConfig,
    SPSAConfig,
    nattack,
    nes_attack,
    spsa_attack,
)
from pointsecguard_tpu_torch.attacks.common import (
    AttackResult,
    make_target_labels,
    per_point_ce,
    per_sample_accuracy,
    point_accuracy,
)
from pointsecguard_tpu_torch.attacks.cw import CWConfig, cw_color_attack
from pointsecguard_tpu_torch.attacks.decision import (
    BoundaryConfig,
    EvolutionaryConfig,
    boundary_attack,
    evolutionary_attack,
)
from pointsecguard_tpu_torch.attacks.deepfool import DeepFoolConfig, deepfool_attack
from pointsecguard_tpu_torch.attacks.defenses import (
    apply_color_defense,
    bit_depth_reduction,
    jpeg_color_compression,
    random_color_jitter,
    random_color_resample,
    randomized_defense_wraps,
    seeded_draws,
    simple_random_subsample,
    srs_donors,
    statistical_outlier_removal,
)
from pointsecguard_tpu_torch.attacks.noise import equal_norm_color_noise
from pointsecguard_tpu_torch.attacks.pgd import PGDConfig, pgd_color_attack

# The reference's benchmark configurations, keyed by (model_family,
# attack). Sources: BASELINE.md / SURVEY.md §2.
_PRESETS: dict[tuple[str, str], PGDConfig | CWConfig] = {
    # PointNet++ (`PointNet/NB_nontarget_test_semseg.py:169` etc.)
    ("pointnet2", "nb"): PGDConfig(eps=0.1, alpha=0.05, iters=10),
    ("pointnet2", "nu"): CWConfig(
        steps=1000, lr=0.01, f_coeff=1.0, smooth_coeff=0.1, l2_coeff=0.1
    ),
    ("pointnet2", "tar_nb"): PGDConfig(
        eps=0.5, alpha=0.1, iters=500, targeted=True, ce_reduction="mean"
    ),
    ("pointnet2", "tar_nu"): CWConfig(
        steps=1000, lr=0.01, f_coeff=1.0, smooth_coeff=1.0, l2_coeff=1.0,
        smooth_k=5, targeted=True, lr_halve_every=50,
    ),
    # RandLA-Net / ares (`tester_S3DIS.py:142-145,277-280`)
    ("randla", "nb"): PGDConfig(
        eps=17.0, alpha=1.7, iters=10, loss="hinge", step_norm="l2",
        rand_init_eps=17.0 / 5.0,
    ),
    ("randla", "nu"): CWConfig(flavor="ares", steps=1000, lr=0.01, f_coeff=0.5),
    ("randla", "tar_nb"): PGDConfig(
        eps=10.0, alpha=1.0, iters=20, loss="hinge", step_norm="l2",
        targeted=True, rand_init_eps=2.0, early_exit_sr=0.90,
    ),
    ("randla", "tar_nu"): CWConfig(
        flavor="ares", steps=1000, lr=0.01, f_coeff=1.0, targeted=True,
        success_sr=0.95,
    ),
    # ResGCN (`ResGCN/sem_seg_dense/attacks.py:75,134,210,288`)
    ("resgcn", "nb"): PGDConfig(eps=0.3, alpha=2.0 / 255.0, iters=50),
    ("resgcn", "nu"): CWConfig(
        steps=1000, lr=0.1, f_coeff=0.1, smooth_coeff=1e-4, l2_coeff=1.0
    ),
    ("resgcn", "tar_nb"): PGDConfig(
        eps=0.4, alpha=0.04, iters=50, targeted=True, ce_reduction="mean"
    ),
    ("resgcn", "tar_nu"): CWConfig(
        steps=1000, lr=0.1, f_coeff=1.0, smooth_coeff=1e-4, l2_coeff=0.1,
        smooth_k=5, targeted=True,
    ),
}


def attack_preset(model: str, attack: str, **overrides) -> PGDConfig | CWConfig:
    """Reference attack budget for (model, attack) — a ``PGDConfig`` for
    nb / tar_nb, a ``CWConfig`` for nu / tar_nu — with optional overrides.
    Targeted presets still need ``target=<class>``."""
    cfg = _PRESETS[(model, attack)]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = [
    "ATTACKS",
    "AttackBenchmark",
    "AttackResult",
    "BoundaryConfig",
    "CWConfig",
    "DeepFoolConfig",
    "EvolutionaryConfig",
    "NAttackConfig",
    "NESConfig",
    "PGDConfig",
    "SPSAConfig",
    "apply_color_defense",
    "attack_preset",
    "bit_depth_reduction",
    "boundary_attack",
    "cw_color_attack",
    "deepfool_attack",
    "distortion_binsearch",
    "equal_norm_color_noise",
    "evolutionary_attack",
    "iteration_curve",
    "jpeg_color_compression",
    "load_attack",
    "make_target_labels",
    "nattack",
    "nes_attack",
    "per_point_ce",
    "per_sample_accuracy",
    "pgd_color_attack",
    "point_accuracy",
    "random_color_jitter",
    "random_color_resample",
    "randomized_defense_wraps",
    "run_registered_attack",
    "seeded_draws",
    "simple_random_subsample",
    "spsa_attack",
    "srs_donors",
    "statistical_outlier_removal",
    "worst_case_run",
]
