"""DeepFool: the minimal-perturbation attack that steps across the nearest
linearised class boundary (port of ``pointsecguard_tpu/attacks/deepfool.py``;
Moosavi-Dezfooli et al. 2016, the ares registry's ``deepfool``).

One forward an iteration, then one ``torch.autograd.grad`` per class with
the graph retained: the gradient of a class's batch-summed logit is each
sample's own, because an evaluation-mode forward treats the samples
independently (BatchNorm reads its running statistics). The JAX engine
vmaps one VJP over the classes; the port's kernels are bound as
``autograd.Function``s that ``torch.func`` cannot enter, so the K
backwards run one after another. The loop reads ``done.all()`` once an
iteration, where JAX's ``while_loop`` exits when every sample is across.

It needs one decision per shape (outputs [B, 1, K]): the classification
task. It is untargeted by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pointsecguard_tpu_torch.attacks.common import AttackResult, finish_attack_result


@dataclasses.dataclass(frozen=True)
class DeepFoolConfig:
    """ares' upstream defaults are 100 iterations and overshoot 0.02."""

    iters: int = 50
    overshoot: float = 0.02
    distance: str = "l_2"  # "l_2" | "l_inf"
    channels: tuple[int, int] = (0, 3)
    clip: tuple[float, float] | None = None


def check_one_decision(points: torch.Tensor, labels: torch.Tensor, what: str) -> None:
    if points.dim() != 3 or labels.dim() != 2 or labels.shape[1] != 1:
        raise ValueError(
            f"{what} needs one decision per shape (outputs [B,1,K], labels [B,1]); "
            "per-point semseg outputs have no single decision")


def deepfool_attack(
    outputs_fn: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg: DeepFoolConfig,
    *,
    mask: torch.Tensor | None = None,
) -> AttackResult:
    """Step each sample across its nearest linearised boundary until its
    prediction leaves its label, at most ``cfg.iters`` times; a sample
    across stops moving. ``outputs_fn`` gives [B, 1, K]; ``labels`` is
    [B, 1]. ``mask`` must be None (the engines' common signature)."""
    if mask is not None:
        raise ValueError("deepfool is untargeted; mask is not supported")
    if cfg.distance not in ("l_2", "l_inf"):
        raise ValueError(f"unknown distance {cfg.distance!r}")
    check_one_decision(points, labels, "deepfool")
    lo, hi = cfg.channels
    points = points.detach()
    color0 = points[..., lo:hi]
    B = points.shape[0]
    y = labels[:, 0].long()
    rows = torch.arange(B, device=points.device)
    eps = 1e-4  # the boundary-crossing nudge of the reference algorithm

    def adv_of(color):
        return torch.cat([points[..., :lo], color, points[..., hi:]], dim=-1)

    def project(color):
        return color if cfg.clip is None else torch.clamp(color, cfg.clip[0], cfg.clip[1])

    r_tot = torch.zeros_like(color0)
    done = torch.zeros(B, dtype=torch.bool, device=points.device)
    steps = 0
    while steps < cfg.iters and not bool(done.all()):
        leaf = project(color0 + (1.0 + cfg.overshoot) * r_tot).requires_grad_(True)
        logits = outputs_fn(adv_of(leaf))[:, 0, :]  # [B, K]
        K = logits.shape[1]
        grads = torch.stack([
            torch.autograd.grad(logits[:, k].sum(), leaf, retain_graph=k < K - 1)[0]
            for k in range(K)])  # [K, B, n, c]
        with torch.no_grad():
            logits = logits.detach()
            done = done | (torch.argmax(logits, dim=1) != y)
            f_diff = logits - logits[rows, y][:, None]  # [B, K]
            g_diff = grads.transpose(0, 1) - grads[y, rows][:, None]  # [B, K, n, c]
            if cfg.distance == "l_2":
                g_norm = torch.sqrt(torch.sum(g_diff**2, dim=(2, 3)) + 1e-12)
            else:
                g_norm = torch.sum(torch.abs(g_diff), dim=(2, 3)) + 1e-12
            ratio = torch.abs(f_diff) / g_norm  # the distance to each boundary
            ratio[rows, y] = torch.inf  # not the own class
            k_star = torch.argmin(ratio, dim=1)
            f_k, gn_k, g_k = f_diff[rows, k_star], g_norm[rows, k_star], g_diff[rows, k_star]
            if cfg.distance == "l_2":
                step = ((torch.abs(f_k) + eps) / gn_k**2)[:, None, None] * g_k
            else:
                step = ((torch.abs(f_k) + eps) / gn_k)[:, None, None] * torch.sign(g_k)
            # a sample already across keeps its perturbation
            r_tot = torch.where(done[:, None, None], r_tot, r_tot + step)
        steps += 1
    color_adv = project(color0 + (1.0 + cfg.overshoot) * r_tot)
    return finish_attack_result(outputs_fn, adv_of(color_adv), points, labels, steps,
                                channels=cfg.channels)
