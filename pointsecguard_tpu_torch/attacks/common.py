"""Shared attack machinery (port of ``pointsecguard_tpu/attacks/common.py``).

Attacks perturb only the RGB colour channels (slice 3:6 of the feature
axis); xyz is never touched — the paper's colour threat model.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

COLOR_SLICE = slice(3, 6)


class AttackResult(NamedTuple):
    """Outcome of one batched attack run (all fields on the device)."""

    points_adv: torch.Tensor  # [B, N, C] adversarial inputs
    steps: torch.Tensor  # [] int32 — iterations executed
    acc: torch.Tensor  # [] adversarial overall point accuracy
    success_rate: torch.Tensor  # [] targeted success rate (0 if untargeted)
    l2_dist: torch.Tensor  # [B] L2 distortion of the perturbed channels
    adv_pred: torch.Tensor  # [B, N] adversarial per-point predictions
    # [B] int32 per-sample exit iteration (each sample behaves as it would
    # alone at batch size 1); equals ``steps`` for fixed-length runs
    steps_b: torch.Tensor | None = None


def per_point_ce(outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy treating ``outputs`` as logits — the reference applies
    ``nn.CrossEntropyLoss`` to whatever the model returns, so on
    PointNet++'s log-probs the softmax is taken twice (`nontarget.py:34`)."""
    lp = torch.log_softmax(outputs, dim=-1)
    return -torch.gather(lp, -1, labels.long()[..., None])[..., 0]


def hinge_logit_loss(
    outputs: torch.Tensor,
    ys: torch.Tensor,
    num_classes: int,
    *,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """ares `colperloss` (`bim.py:110-116`): per-point
    max(0, max_other_logit − y_logit), summed over points → [B]."""
    one_hot = torch.nn.functional.one_hot(ys.long(), num_classes).to(outputs.dtype)
    real = torch.sum(one_hot * outputs, dim=-1)
    other = torch.amax((1.0 - one_hot) * outputs, dim=-1)
    per_point = torch.clamp(other - real, min=0.0)
    if point_mask is not None:
        per_point = per_point * point_mask.to(per_point.dtype)
    return torch.sum(per_point, dim=-1)


def point_accuracy(
    outputs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Overall (or masked) point accuracy."""
    correct = (torch.argmax(outputs, dim=-1) == labels).float()
    if mask is None:
        return torch.mean(correct)
    m = mask.float()
    return torch.sum(correct * m) / torch.clamp(torch.sum(m), min=1.0)


def per_sample_accuracy(
    pred: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-cloud (or per-cloud masked) point accuracy → [B]."""
    correct = (pred == labels).float()
    if mask is None:
        return torch.mean(correct, dim=1)
    m = mask.float()
    return torch.sum(correct * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)


def make_target_labels(
    labels: torch.Tensor, origin: int, target: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Targeted-attack label remap (`bim.py:436-440`): mask = (label ==
    origin); the remapped labels carry ``target`` where the mask is set."""
    mask = labels == origin
    return torch.where(mask, torch.full_like(labels, target), labels), mask
