"""Shared attack machinery (port of ``pointsecguard_tpu/attacks/common.py``).

Attacks perturb only the RGB colour channels (slice 3:6 of the feature
axis); xyz is never touched — the paper's colour threat model.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pointsecguard_tpu_torch.ops.distance import square_distance
from pointsecguard_tpu_torch.ops.selection import bottom_k_indices

COLOR_SLICE = slice(3, 6)


def set_color(points: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """``points`` with its colour channels replaced by ``color``."""
    lo, hi = COLOR_SLICE.start, COLOR_SLICE.stop
    return torch.cat([points[..., :lo], color, points[..., hi:]], dim=-1)


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


def cw_f_prob(
    outputs: torch.Tensor, labels: torch.Tensor, kappa: float, num_classes: int
) -> torch.Tensor:
    """The C&W f on softmax probabilities (`nontarget.py:120-128`):
    clamp(p_true − max_other_p, min=−κ) per point."""
    probs = torch.softmax(outputs, dim=-1)
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).to(probs.dtype)
    j = torch.sum(one_hot * probs, dim=-1)
    i = torch.amax((1.0 - one_hot) * probs, dim=-1)
    return torch.clamp(j - i, min=-kappa)


def cw_f_targeted(
    outputs: torch.Tensor, target: int, kappa: float, num_classes: int
) -> torch.Tensor:
    """Targeted C&W f on raw outputs (`tcolper.py:155-163` direction):
    clamp(max_other − target_out, min=−κ) per point; minimising it drives
    the target class above all others (the PointNet fork's `tar_f` has
    the sign inverted, `target.py:159-167`; the JAX package implements the
    working direction, and so does the port)."""
    one_hot = torch.zeros(num_classes, dtype=outputs.dtype, device=outputs.device)
    one_hot[target] = 1.0
    i = torch.sum(one_hot * outputs, dim=-1)
    j = torch.amax((1.0 - one_hot) * outputs, dim=-1)
    return torch.clamp(j - i, min=-kappa)


class _ColorSmoothness(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adv_color, ref_color, k):
        # the JAX association (Σa² − 2·a·rᵀ) + Σr² in full float32
        d2k, idx = bottom_k_indices(square_distance(adv_color, ref_color), k)
        # clamp before the sqrt: the self pair starts at ~0 and sqrt'(0) = ∞
        d = torch.sqrt(torch.clamp(d2k, min=1e-12))
        ctx.save_for_backward(adv_color, ref_color, d, idx)
        return torch.sum(d, dim=(1, 2))

    @staticmethod
    def backward(ctx, g):
        adv_color, ref_color, d, idx = ctx.saved_tensors
        B, N, k = idx.shape
        flat = idx.reshape(B, N * k, 1).long().expand(-1, -1, ref_color.shape[-1])
        ref_sel = torch.gather(ref_color, 1, flat).reshape(B, N, k, -1)
        diff = adv_color[:, :, None, :] - ref_sel
        dinv = 1.0 / torch.clamp(d, min=1e-6)
        grad_adv = g[:, None, None] * torch.sum(diff * dinv[..., None], dim=2)
        return grad_adv, torch.zeros_like(ref_color), None


def color_smoothness(adv_color: torch.Tensor, ref_color: torch.Tensor, k: int) -> torch.Tensor:
    """kNN colour-space smoothness term (`nontarget.py:130-135`): for each
    point the sum of its k smallest colour distances to the reference
    cloud → [B]. The neighbours are selected by ``bottom_k_indices`` (the
    bottom-k kernel on the card). The backward reuses that selection,
    d‖a−r‖/da = (a−r)/‖a−r‖ over each point's selected neighbours, and
    gives ``ref_color`` a zero gradient: every caller passes the constant
    clean colours (the JAX package's custom VJP, `attacks/common.py:111-168`)."""
    return _ColorSmoothness.apply(adv_color, ref_color, k)


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


def pooled_accuracy(
    pred: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None,
    rows: int | None = None,
) -> torch.Tensor:
    """Point accuracy pooled over the (masked) points of the first ``rows``
    clouds → [] (all clouds when None): the trajectory's per-step figure.
    The JAX engines take the mean of per-cloud means over every row, a
    caller's padded copies included (`attacks/pgd.py:251-253`,
    `attacks/cw.py:263-265`); the two agree at batch 1 and on equal masks
    without padding."""
    correct = (pred[:rows] == labels[:rows]).float()
    if mask is None:
        return torch.mean(correct)
    m = mask[:rows].float()
    return torch.sum(correct * m) / torch.clamp(torch.sum(m), min=1.0)


@torch.no_grad()
def finish_attack_result(
    outputs_fn, adv: torch.Tensor, points: torch.Tensor, labels: torch.Tensor,
    steps: int, *, channels: tuple[int, int], targeted: bool = False,
    target: int = -1, mask: torch.Tensor | None = None,
) -> AttackResult:
    """Shared attack epilogue (JAX `attacks/common.py:206-230`): the final
    forward, accuracy, targeted success rate and per-cloud L2 over the
    perturbed channel slice."""
    lo, hi = channels
    outputs = outputs_fn(adv)
    adv_pred = torch.argmax(outputs, dim=-1)
    acc = point_accuracy(outputs, labels, None if targeted else mask)
    if targeted and mask is not None:
        sr = point_accuracy(outputs, torch.full_like(labels, target), mask)
    else:
        sr = torch.zeros((), device=points.device)
    diff = (adv[..., lo:hi] - points[..., lo:hi]).reshape(points.shape[0], -1)
    return AttackResult(adv, torch.tensor(steps, dtype=torch.int32), acc, sr,
                        torch.linalg.norm(diff, dim=1), adv_pred)


def make_target_labels(
    labels: torch.Tensor, origin: int, target: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Targeted-attack label remap (`bim.py:436-440`): mask = (label ==
    origin); the remapped labels carry ``target`` where the mask is set."""
    mask = labels == origin
    return torch.where(mask, torch.full_like(labels, target), labels), mask
