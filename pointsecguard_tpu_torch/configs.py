"""Configurations of the port: the fields of ``pointsecguard_tpu/configs.py``
that its ported paths read."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RandlaConfig:
    """`helper_tool.py:44-66` ConfigS3DIS."""

    k_n: int = 16
    num_layers: int = 5
    num_points: int = 40960
    sub_grid_size: float = 0.04
    batch_size: int = 6
    val_batch_size: int = 1
    train_steps: int = 500
    val_steps: int = 100
    sub_sampling_ratio: tuple = (4, 4, 4, 4, 2)
    d_out: tuple = (16, 64, 128, 256, 512)
    noise_init: float = 3.5
    max_epoch: int = 100
    learning_rate: float = 1e-2
    lr_decay: float = 0.95
