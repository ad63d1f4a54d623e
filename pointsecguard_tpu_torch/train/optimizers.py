"""Optimizer and loss extras from the ResGCN subtree (port of
``pointsecguard_tpu/train/optimizers.py``).

`ResGCN/utils/optim.py` (RAdam, AdamW) and `ResGCN/utils/loss.py`
(`SmoothCrossEntropy` label smoothing), `ResGCN/utils/metrics.py` (PSNR,
AverageMeter). The JAX package builds its optimizers on optax; here they
are ``torch.optim`` optimizers that take the same steps:

- ``radam`` is ``RAdam``, written to ``optax.scale_by_radam``'s rule, not
  ``torch.optim.RAdam``'s, which differs from it twice: torch divides by
  ``sqrt(v) + eps`` before the bias correction where optax divides by
  ``sqrt(v̂) + eps``, and torch rectifies when ρₜ > 5 where optax does
  when ρₜ ≥ 5.
- ``adamw`` is ``torch.optim.AdamW``: decay times the learning rate taken
  off the parameter, then Adam's step, which is optax's chain of
  ``scale_by_adam``, ``add_decayed_weights`` and the learning rate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# optax.scale_by_radam's threshold: ρₜ at or above it takes the rectified step
RADAM_THRESHOLD = 5.0


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as ``optax.radam`` computes it: with ρ∞ = 2/(1−β₂) − 1
    and ρₜ = ρ∞ − 2t·β₂ᵗ/(1−β₂ᵗ), the update is −lr·r·m̂/(√v̂ + eps) with
    r = √((ρₜ−4)(ρₜ−2)ρ∞ / ((ρ∞−4)(ρ∞−2)ρₜ)) when ρₜ ≥ ``RADAM_THRESHOLD``, else
    −lr·m̂ (the bias-corrected momentum alone)."""

    def __init__(self, params, lr: float = 1e-3, betas: tuple = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps})

    @staticmethod
    def _scalars(step: int, dtype: torch.dtype, b1: float, b2: float) -> tuple:
        """(1 − β₁ᵗ, 1 − β₂ᵗ, ρₜ, r) computed in ``dtype`` and in optax's
        order: in float32 ρₜ loses digits to the cancellation in 1 − β₂ᵗ
        (ρ₁ = 0.974 for 1), and optax's float32 step takes them so. Each is
        exact in ``dtype``, so a Python float carries it into the tensor
        arithmetic unchanged (r is NaN while ρₜ < 4, where it is not read)."""
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        t = torch.tensor(float(step), dtype=dtype)
        b2t = torch.pow(torch.tensor(b2, dtype=dtype), t)
        ro = ro_inf - 2 * step * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        b1t = torch.pow(torch.tensor(b1, dtype=dtype), t)
        return float(1 - b1t), float(1 - b2t), float(ro), float(r)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            scalars = {}  # (step, dtype) → _scalars
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                g = p.grad
                # optax's update_moment: (1 − b)·g + b·m
                mu = state["mu"].mul_(b1).add_((1.0 - b1) * g)
                nu = state["nu"].mul_(b2).add_((1.0 - b2) * (g * g))
                key = (state["step"], p.dtype)
                if key not in scalars:
                    scalars[key] = self._scalars(*key, b1, b2)
                c1, c2, ro, r = scalars[key]
                mu_hat = mu / c1
                if ro >= RADAM_THRESHOLD:
                    update = r * mu_hat / (torch.sqrt(nu / c2) + group["eps"])
                else:
                    update = mu_hat
                p.sub_(group["lr"] * update)
        return loss


def radam(params, learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> RAdam:
    """Rectified Adam (`optim.py:6-90` capability), optax's rule."""
    return RAdam(params, lr=learning_rate, betas=(b1, b2), eps=eps)


def adamw(params, learning_rate: float = 1e-3, weight_decay: float = 1e-2,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.optim.AdamW:
    """Decoupled-weight-decay Adam (`optim.py:150-207` capability)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                         smoothing: float = 0.2, num_classes: int | None = None
                         ) -> torch.Tensor:
    """Label-smoothed CE (`ResGCN/utils/loss.py:5-24` semantics):
    target = (1−s)·one_hot + s/(C−1)·(1−one_hot)."""
    C = num_classes or logits.shape[-1]
    one_hot = F.one_hot(labels.long(), C).to(logits.dtype)
    target = one_hot * (1.0 - smoothing) + (1.0 - one_hot) * smoothing / (C - 1)
    lp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(target * lp, dim=-1))


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio (`ResGCN/utils/metrics.py` PSNR)."""
    mse = torch.mean((x - y) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


class AverageMeter:
    """Running average tracker (`ResGCN/utils/metrics.py:8-25`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
