"""NU / tar_NU: norm-unbounded (C&W) colour attacks (port of
``pointsecguard_tpu/attacks/cw.py:47-304``).

One engine for the reference's C&W harnesses:

- the PyTorch forks' ``NU_attack`` / ``tar_NU_attack`` (flavour "torch",
  `nontarget.py:44-135`, `target.py:52-175`): the variable is the
  tanh-space colour, cost = f(softmax) or targeted f + smooth-kNN + L2
  with per-fork coefficients, Adam, lr halving with a moment reset;
- ares ``NUattack`` / ``tar_NUattack`` (flavour "ares", `NUattack.py:12-320`,
  `tar_NUattack.py:12-244`): a delta added in atanh space, cost = the L2
  norm per cloud + c·hinge(logits).

Early exit is per sample: a cloud's colour, prediction and step count
freeze at the iteration its own success test fires (accuracy below
``success_acc`` untargeted, success rate above ``success_sr`` targeted),
so a batch equals its B=1 runs. The JAX engine runs the loop as one
``lax.while_loop``; this one is eager and reads ``done.all()`` back to the
host once per iteration to decide whether to go on, with the same
semantics (``steps`` is the number of iterations executed).
``trajectory=True`` (``--log_steps``) runs exactly ``cfg.steps`` steps with
no early exit and no read, and also returns the per-step accuracy, success
rate and per-cloud L2, kept on the device until the caller reads them.
``ranks_sum`` (a rank of a data-parallel run) sums the trajectory's
per-step counts over the ranks after the loop and makes the ranks agree
on the early exit, as in ``attacks/pgd.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pointsecguard_tpu_torch.attacks.common import (
    AttackResult,
    all_done,
    color_smoothness,
    cw_f_prob,
    cw_f_targeted,
    per_sample_accuracy,
    pooled_counts,
    pooled_rate,
    result_counts,
    trajectory_rates,
)

_TANH_BOUND = 1.0 - 1e-6  # ares `_scale_to_tanh` clamp (`NUattack.py:115-119`)


@dataclasses.dataclass(frozen=True)
class CWConfig:
    """C&W attack configuration. The coefficients (f / smooth / l2)
    encode the per-fork cost formulas:

    - PointNet NU / tar_NU:  1·f + c·smooth + c·L2  (`nontarget.py:84`)
    - ResGCN NU:             c·f + 1e-4·smooth + 1·L2  (`colper.py:79`)
    - ResGCN tar_NU:         1·f + 1e-4·smooth + c·L2  (`tcolper.py:99`)
    - ares (flavor="ares"):  L2 norm + c·hinge  (`NUattack.py:58`)
    """

    steps: int = 1000
    lr: float = 0.01
    kappa: float = 0.0
    flavor: str = "torch"  # "torch" | "ares"
    f_coeff: float = 1.0
    smooth_coeff: float = 0.1
    l2_coeff: float = 0.1
    smooth_k: int = 10  # 10 untargeted, 5 targeted (`nontarget.py:57`, `target.py:64`)
    targeted: bool = False
    target: int = -1
    num_classes: int = 13
    success_acc: float = 1.0 / 13.0  # untargeted early exit (`nontarget.py:95`)
    success_sr: float = 0.9  # targeted early exit (`target.py:120`)
    lr_halve_every: int = 0  # 50 for torch targeted (`target.py:123-125`)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    channels: tuple[int, int] = (3, 6)
    box: tuple[float, float] = (0.0, 1.0)  # the tanh box of the perturbed channels


def _atanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.log((1 + x) / (1 - x))


def _true_margin(outputs: torch.Tensor, labels: torch.Tensor, num_classes: int):
    """logit(true) − max other logit per point (the ares untargeted hinge,
    in its working direction)."""
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).to(outputs.dtype)
    real = torch.sum(one_hot * outputs, dim=-1)
    other = torch.amax((1.0 - one_hot) * outputs - 1e9 * one_hot, dim=-1)
    return real - other


def cw_color_attack(
    outputs_fn: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg: CWConfig,
    *,
    mask: torch.Tensor | None = None,
    trajectory: bool = False,
    valid_rows: int | None = None,
    ranks_sum: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> AttackResult | tuple[AttackResult, dict]:
    """Run the C&W colour attack on a batch.

    Args:
      outputs_fn: points [B, N, C] → model outputs [B, N, K]. The caller
        puts the model in eval mode with its parameters' ``requires_grad``
        off: only the colours need a gradient.
      points: [B, N, C] clean inputs, colours in ``cfg.channels``.
      labels: [B, N] ground truth.
      cfg: attack configuration.
      mask: [B, N] bool — the points allowed to change (targeted), or the
        valid points (untargeted).
      trajectory: no early exit, exactly ``cfg.steps`` steps, and return
        ``(result, traj)`` with ``traj`` = {"acc": [steps], "sr": [steps],
        "l2": [steps, B]} (JAX `attacks/cw.py:260-270`): each step's
        accuracy and success rate (``pooled_counts``) and the L2 of the
        colour it evaluated.
      valid_rows: the trajectory pools over the first ``valid_rows`` clouds
        (a caller's padded rows excluded; default all).
      ranks_sum: the sum of a tensor over the ranks that split the batch
        (``pgd_color_attack``'s).
    """
    lo, hi = cfg.channels
    points = points.detach()
    color0 = points[..., lo:hi]
    B = labels.shape[0]
    dev = points.device
    m = None if mask is None else mask.to(points.dtype)[..., None]

    # x = mid + half·tanh(w) maps ℝ onto (lo, hi); with the (0, 1) box this
    # is the reference's 0.5·(tanh(w) + 1)
    mid = 0.5 * (cfg.box[0] + cfg.box[1])
    half = 0.5 * (cfg.box[1] - cfg.box[0])
    norm0 = torch.clamp((color0 - mid) / half, -_TANH_BOUND, _TANH_BOUND)
    if cfg.flavor == "torch":
        w = _atanh(norm0)  # the variable is the tanh-space colour
    else:
        w = torch.zeros_like(color0)  # a delta added in atanh space
        ws_base = _atanh(norm0 * _TANH_BOUND)

    def adv_color_of(w):
        c = mid + half * torch.tanh(w if cfg.flavor == "torch" else ws_base + w)
        if m is not None:
            c = m * c + (1 - m) * color0
        return c

    def with_color(color):
        return torch.cat([points[..., :lo], color, points[..., hi:]], dim=-1)

    def masked_sum(per_point):
        return torch.sum(per_point if m is None else per_point * m[..., 0])

    def cost_fn(w):
        c = adv_color_of(w)
        outputs = outputs_fn(with_color(c))
        if cfg.targeted:
            f = masked_sum(cw_f_targeted(outputs, cfg.target, cfg.kappa, cfg.num_classes))
        elif cfg.flavor == "ares":
            # the hinge of the true-class margin (working direction); an
            # untargeted mask keeps the objective on the valid points
            f = masked_sum(torch.clamp(
                _true_margin(outputs, labels, cfg.num_classes) + cfg.kappa, min=0.0))
        else:
            f = masked_sum(cw_f_prob(outputs, labels, cfg.kappa, cfg.num_classes))
        if cfg.flavor == "ares":
            # the L2 norm per cloud + c·hinge (`NUattack.py:52-58`)
            dist = torch.linalg.norm((c - color0).reshape(B, -1), dim=1)
            return torch.sum(dist) + cfg.f_coeff * f, outputs
        cost = cfg.f_coeff * f + cfg.l2_coeff * torch.sum((c - color0) ** 2)
        if cfg.smooth_coeff:  # no [N, N] matrix when the term is off
            cost = cost + cfg.smooth_coeff * torch.sum(
                color_smoothness(c, color0, cfg.smooth_k))
        return cost, outputs

    target_labels = torch.full_like(labels, cfg.target)
    # targeted clouds with an empty mask can never reach the success
    # exit: done from the start, so they cannot stall the batch
    if cfg.targeted and mask is not None and not trajectory:
        done = mask.sum(dim=1) == 0
    else:
        done = torch.zeros(B, dtype=torch.bool, device=dev)
    snap = color0
    pred_snap = torch.zeros_like(labels)
    steps_b = torch.zeros(B, dtype=torch.int32, device=dev)
    # Adam with torch semantics; lr halving (`target.py:123-125`) restarts
    # it at half the rate with fresh moments
    mm = torch.zeros_like(w)
    vv = torch.zeros_like(w)
    t, lr = 0, cfg.lr
    traj = {"acc": [], "sr": [], "l2": []}
    i = 0
    while i < cfg.steps and (trajectory or not all_done(done, ranks_sum)):
        leaf = w.detach().requires_grad_(True)
        cost, outputs = cost_fn(leaf)
        (g,) = torch.autograd.grad(cost, leaf)
        with torch.no_grad():
            pred = torch.argmax(outputs, dim=-1)
            if cfg.targeted:
                success = per_sample_accuracy(pred, target_labels, mask) > cfg.success_sr
            else:
                success = per_sample_accuracy(pred, labels, mask) < cfg.success_acc
            # the exit state of the live samples (and, at the first
            # iteration, of the clouds done from the start)
            write = torch.ones_like(done) if i == 0 else ~done
            snap = torch.where(write[:, None, None], adv_color_of(w), snap)
            pred_snap = torch.where(write[:, None], pred, pred_snap)
            steps_b = torch.where(done, steps_b, torch.full_like(steps_b, i + 1))
            if trajectory:
                if cfg.targeted:
                    traj["acc"].append(pooled_counts(pred, labels, None, valid_rows))
                    traj["sr"].append(pooled_counts(pred, target_labels, mask, valid_rows))
                else:
                    traj["acc"].append(pooled_counts(pred, labels, mask, valid_rows))
                    traj["sr"].append(torch.zeros(2, device=dev))
                traj["l2"].append(torch.linalg.norm((snap - color0).reshape(B, -1), dim=1))
            else:
                done = done | success
            t += 1
            mm = cfg.adam_b1 * mm + (1 - cfg.adam_b1) * g
            vv = cfg.adam_b2 * vv + (1 - cfg.adam_b2) * g * g
            mhat = mm / (1 - cfg.adam_b1**t)
            vhat = vv / (1 - cfg.adam_b2**t)
            w = w - lr * mhat / (torch.sqrt(vhat) + cfg.adam_eps)
            if cfg.lr_halve_every > 0 and i > 0 and (i + 1) % cfg.lr_halve_every == 0:
                mm, vv, t, lr = torch.zeros_like(mm), torch.zeros_like(vv), 0, lr * 0.5
        i += 1

    with torch.no_grad():
        adv = with_color(snap)
        l2 = torch.linalg.norm((snap - color0).reshape(B, -1), dim=1)
        # batch metrics from each sample's exit prediction, as B=1 runs
        # would report them; the success rate over the mask, or every
        # point without one
        counts = result_counts(
            pred_snap, labels, targeted=cfg.targeted, target=cfg.target, mask=mask,
            sr_mask=mask if mask is not None else torch.ones_like(labels, dtype=torch.bool))
        acc, sr = pooled_rate(counts)
    result = AttackResult(adv, torch.tensor(i, dtype=torch.int32), acc, sr, l2,
                          pred_snap, steps_b, counts)
    if trajectory:
        return result, {"acc": trajectory_rates(traj["acc"], ranks_sum),
                        "sr": trajectory_rates(traj["sr"], ranks_sum),
                        "l2": torch.stack(traj["l2"])}
    return result
