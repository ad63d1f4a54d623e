"""NB / tar_NB: norm-bounded (PGD/BIM) colour attacks (port of
``pointsecguard_tpu/attacks/pgd.py:38-273``).

Covers the reference's PyTorch untargeted ``NB_attack`` (CE loss, sign
step, L∞ ε-ball, [0,1] clip; `nontarget.py:10-42`), targeted
``tar_NB_attack`` (CE toward a constant target, masked update, descent;
`target.py:7-45`) and the ares BIM/TBIM variants (hinge logit loss, L2
unit-gradient step, random init, per-sample early exit at success rate).

Input gradients come from ``torch.autograd.grad`` with respect to the
perturbed channel slice. Without early exit (every PointNet++ preset)
the loop never reads a value back to the host, so the GPU runs the
iterations back to back; with early exit, one ``done.all()`` read per
iteration decides whether to go on. With ``cfg.momentum`` > 0 (MIM) the
step is taken on the accumulator of L1-normalised gradients (JAX
`attacks/pgd.py:155-178`). ``trajectory=True`` (``--log_steps``)
turns early exit off, runs exactly ``cfg.iters`` steps and also returns
the per-step accuracy, success rate and per-cloud L2, kept on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pointsecguard_tpu_torch.attacks.common import (
    AttackResult,
    hinge_logit_loss,
    per_point_ce,
    per_sample_accuracy,
    point_accuracy,
    pooled_accuracy,
)


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    """Norm-bounded attack configuration (one preset per reference
    attack script — BASELINE.md 'Attack budgets')."""

    eps: float
    alpha: float
    iters: int
    loss: str = "ce"  # "ce" (torch forks) | "hinge" (ares colperloss)
    step_norm: str = "linf"  # "linf" sign step | "l2" unit-gradient step
    ce_reduction: str = "sum_over_points"  # NB `nontarget.py:34` | "mean"
    targeted: bool = False
    target: int = -1
    num_classes: int = 13
    rand_init_eps: float = 0.0  # ares NBattack random start magnitude
    early_exit_sr: float = 0.0  # >0 ⇒ per-sample stop past this success rate
    # >0 ⇒ MIM (Dong et al. 2018; the ares registry's 'mim'): accumulate the
    # per-cloud L1-normalised gradient with this decay, step on the sum
    momentum: float = 0.0
    channels: tuple[int, int] = (3, 6)
    clip: tuple[float, float] | None = (0.0, 1.0)


def pgd_color_attack(
    outputs_fn: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg: PGDConfig,
    *,
    mask: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    trajectory: bool = False,
    valid_rows: int | None = None,
) -> AttackResult | tuple[AttackResult, dict]:
    """Run the attack on a batch.

    Args:
      outputs_fn: points [B,N,C] → model outputs [B,N,K] (log-probs or
        logits; CE is applied on top either way, as the reference does).
        The caller puts the model in eval mode with its parameters'
        ``requires_grad`` off: only the colours need a gradient.
      points: [B, N, C] clean inputs, colours in ``cfg.channels``.
      labels: [B, N] ground truth.
      cfg: attack budget.
      mask: [B, N] bool — points allowed to change (targeted attacks).
      generator: draws the random init (required if rand_init_eps > 0).
      trajectory: no early exit, exactly ``cfg.iters`` steps, and return
        ``(result, traj)`` with ``traj`` = {"acc": [iters], "sr": [iters],
        "l2": [iters, B]} (JAX `attacks/pgd.py:243-256`): each step's
        accuracy and success rate of the evaluation before its update
        (``pooled_accuracy``), and the L2 after it.
      valid_rows: the trajectory pools its accuracy and success rate over
        the first ``valid_rows`` clouds (a caller's padded rows excluded;
        default all).
    """
    lo, hi = cfg.channels
    points = points.detach()
    color0 = points[..., lo:hi]
    B = points.shape[0]
    m = None if mask is None else mask.to(points.dtype)[..., None]

    if not cfg.targeted:
        ys = labels
    elif cfg.loss == "hinge" and mask is not None:
        ys = torch.where(mask, torch.full_like(labels, cfg.target), labels)
    else:  # torch tar_NB: constant full target vector (`target.py:29`)
        ys = torch.full_like(labels, cfg.target)

    def with_color(color):
        return torch.cat([points[..., :lo], color, points[..., hi:]], dim=-1)

    def attack_loss(color):
        adv = with_color(color if m is None else m * color + (1 - m) * color0)
        outputs = outputs_fn(adv)
        if cfg.loss == "ce":
            ce = per_point_ce(outputs, ys)
            if mask is not None and not cfg.targeted:
                loss = torch.sum(ce * m[..., 0]) / torch.clamp(m.sum(), min=1.0)
            elif mask is not None or cfg.ce_reduction != "sum_over_points":
                loss = torch.mean(ce)
            else:  # `nontarget.py:34`: sum-CE over everything / num_points
                loss = torch.sum(ce) / points.shape[1]
        elif cfg.loss == "hinge":
            point_mask = mask if cfg.targeted else None
            loss = torch.sum(hinge_logit_loss(
                outputs, ys, cfg.num_classes, point_mask=point_mask))
        else:
            raise ValueError(cfg.loss)
        return loss, outputs

    def project(color):
        if cfg.step_norm == "linf":
            eta = torch.clamp(color - color0, -cfg.eps, cfg.eps)
        else:
            delta = (color - color0).reshape(B, -1)
            norm = torch.linalg.norm(delta, dim=1, keepdim=True)
            scale = torch.clamp(cfg.eps / torch.clamp(norm, min=1e-12), max=1.0)
            eta = (delta * scale).reshape(color0.shape)
        out = color0 + eta
        if cfg.clip is not None:
            out = torch.clamp(out, cfg.clip[0], cfg.clip[1])
        if m is not None:
            out = m * out + (1 - m) * color0
        return out

    def unit_l2(g):
        flat = g.reshape(B, -1)
        norm = torch.clamp(torch.linalg.norm(flat, dim=1, keepdim=True), min=1e-12)
        return (flat / norm).reshape(g.shape)

    color = color0
    if cfg.rand_init_eps > 0:
        if generator is None:
            raise ValueError("rand_init_eps > 0 requires a generator")
        if cfg.step_norm == "linf":
            noise = torch.rand(color0.shape, generator=generator,
                               device=generator.device)
            noise = (2 * noise - 1) * cfg.rand_init_eps
        else:
            g = torch.randn(color0.shape, generator=generator,
                            device=generator.device)
            noise = cfg.rand_init_eps * unit_l2(g)
        color = project(color0 + noise.to(color0.device))

    # per-sample early exit (TBIM `:508`): a cloud's colour and step count
    # freeze once ITS success rate passes the threshold, as at batch 1
    track_exit = cfg.early_exit_sr > 0 and not trajectory
    if track_exit and cfg.targeted and mask is not None:
        done = mask.sum(dim=1) == 0  # can never succeed: never stalls
    else:
        done = torch.zeros(B, dtype=torch.bool, device=points.device)
    snap = color
    steps_b = torch.zeros(B, dtype=torch.int32, device=points.device)
    direction = -1.0 if cfg.targeted else 1.0
    traj = {"acc": [], "sr": [], "l2": []}
    g_acc = torch.zeros_like(color) if cfg.momentum > 0 else None
    steps = 0
    for i in range(cfg.iters):
        if track_exit and bool(done.all()):
            break
        leaf = color.detach().requires_grad_(True)
        loss, outputs = attack_loss(leaf)
        (g,) = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            if g_acc is not None:
                # MIM accumulator (Dong et al. 2018 eq. 6): per-cloud
                # L1-normalised gradient with decay μ
                flat = g.reshape(B, -1)
                l1 = torch.clamp(torch.sum(torch.abs(flat), dim=1, keepdim=True), min=1e-12)
                g_acc = cfg.momentum * g_acc + (flat / l1).reshape(g.shape)
                g = g_acc
            step = torch.sign(g) if cfg.step_norm == "linf" else unit_l2(g)
            color = project(color + direction * cfg.alpha * step)
            live = ~done
            snap = torch.where(live[:, None, None], color, snap)
            steps_b = torch.where(live, torch.full_like(steps_b, i + 1), steps_b)
            if track_exit and cfg.targeted and mask is not None:
                pred = torch.argmax(outputs, dim=-1)
                sr_b = per_sample_accuracy(
                    pred, torch.full_like(labels, cfg.target), mask)
                done = done | (sr_b > cfg.early_exit_sr)
            if trajectory:
                pred = torch.argmax(outputs, dim=-1)
                traj["acc"].append(pooled_accuracy(
                    pred, labels, None if cfg.targeted else mask, valid_rows))
                traj["sr"].append(
                    pooled_accuracy(pred, torch.full_like(labels, cfg.target), mask,
                                    valid_rows)
                    if cfg.targeted and mask is not None
                    else torch.zeros((), device=points.device))
                traj["l2"].append(torch.linalg.norm((color - color0).reshape(B, -1), dim=1))
        steps = i + 1

    with torch.no_grad():
        adv = with_color(snap)
        outputs = outputs_fn(adv)
        adv_pred = torch.argmax(outputs, dim=-1)
        acc = point_accuracy(outputs, labels, None if cfg.targeted else mask)
        if cfg.targeted and mask is not None:
            sr = point_accuracy(outputs, torch.full_like(labels, cfg.target), mask)
        else:
            sr = torch.zeros((), device=points.device)
        l2 = torch.linalg.norm((snap - color0).reshape(B, -1), dim=1)
    result = AttackResult(
        adv, torch.tensor(steps, dtype=torch.int32), acc, sr, l2, adv_pred,
        steps_b,
    )
    if trajectory:
        return result, {k: torch.stack(v) for k, v in traj.items()}
    return result
