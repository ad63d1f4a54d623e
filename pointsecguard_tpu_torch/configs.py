"""Configurations of the port: the fields of ``pointsecguard_tpu/configs.py``
that its ported paths read (training fields come with the trainer)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RandlaConfig:
    """`helper_tool.py:44-66` ConfigS3DIS, as far as the attack path reads it."""

    k_n: int = 16
    num_layers: int = 5
    num_points: int = 40960
    val_batch_size: int = 1
    sub_sampling_ratio: tuple = (4, 4, 4, 4, 2)
    d_out: tuple = (16, 64, 128, 256, 512)
