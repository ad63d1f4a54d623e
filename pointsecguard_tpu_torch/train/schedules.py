"""Training schedules of the reference scripts (port of
``pointsecguard_tpu/train/schedules.py:6-32``)."""

from __future__ import annotations


def pointnet2_lr(epoch: int, *, base: float = 0.001, decay: float = 0.7,
                 step_size: int = 10, clip: float = 1e-5) -> float:
    """Step-decayed Adam lr with floor (`train_semseg.py:140,151`)."""
    return max(base * decay ** (epoch // step_size), clip)


def pointnet2_bn_momentum(epoch: int, *, original: float = 0.1,
                          decay: float = 0.5, step_size: int = 10,
                          floor: float = 0.01) -> float:
    """Torch-style BN momentum anneal (`train_semseg.py:141-158`).
    Returns the *torch* momentum m; the port's BatchNorm takes keep = 1 − m."""
    m = original * decay ** (epoch // step_size)
    return max(m, floor)


def randla_lr(epoch: int, *, base: float = 1e-2, decay: float = 0.95) -> float:
    """Per-epoch exponential decay (`helper_tool.py:58`, `RandLANet.py:232`)."""
    return base * decay**epoch


def resgcn_lr(epoch: int, *, base: float = 1e-3, decay: float = 0.5,
              adjust_freq: int = 20, enabled: bool = False) -> float:
    """StepLR (`ResGCN/sem_seg_dense/train.py:33`, `config.py:43-45`;
    lr_decay_rate defaults to 0, which disables the schedule in the
    reference): the constant ``base`` unless ``enabled``."""
    if not enabled:
        return base
    return base * decay ** (epoch // adjust_freq)
