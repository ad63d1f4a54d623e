"""Score-based black-box attacks: NES, SPSA and NAttack (port of
``pointsecguard_tpu/attacks/blackbox.py:44-365``).

The fork's vendored ares names ``nes`` / ``spsa`` / ``nattack`` in its
registry (`benchmark/utils.py:4,8-20`) but ships no implementation; the
JAX package completes them, and this is its port.

- No gradient ever flows through the model: every loss query runs under
  ``torch.no_grad()`` (the true score-based threat model).
- Per-cloud loss queries: each cloud's perturbation direction is weighted
  by its own loss difference.
- The loops are eager, one model forward a query, one query at a time:
  NES and SPSA make 2 · ``samples`` forwards an iteration (antithetic
  pairs), NAttack ``samples``; the population is never stacked into one
  batch.
- Randomness comes from ``generator`` (a ``torch.Generator``, which cannot
  give ``jax.random``'s bits), or from ``noise(it, s)``, a hook that gives
  the draw of query pair (population member) ``s`` of iteration ``it``:
  NES a standard normal of the colours' shape, SPSA a float32 Rademacher,
  NAttack a standard normal. The tests feed JAX's own draws through it.

All three share the PGD engine's perturbation domain and metric
conventions (``attacks/pgd.py``): channel slice, optional clip box,
optional mask, ``AttackResult`` outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pointsecguard_tpu_torch.attacks.common import (
    AttackResult,
    finish_attack_result,
    hinge_logit_loss,
    per_point_ce,
)

Noise = Callable[[int, int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class NESConfig:
    """NES (natural evolution strategies): antithetic Gaussian loss queries
    estimate the gradient, then PGD sign steps (Ilyas et al. 2018 alg. 1)."""

    eps: float
    alpha: float
    iters: int
    samples: int = 16  # antithetic PAIRS per iteration (2·samples queries)
    sigma: float = 0.01  # Gaussian search radius
    loss: str = "ce"  # "ce" | "hinge" (PGDConfig's semantics)
    targeted: bool = False
    target: int = -1
    num_classes: int = 13
    channels: tuple[int, int] = (3, 6)
    clip: tuple[float, float] | None = (0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class SPSAConfig:
    """SPSA: antithetic Rademacher loss queries estimate the gradient,
    averaged over the sample budget, stepped with Adam inside the ε-ball
    (Uesato et al. 2018 §3.2)."""

    eps: float
    alpha: float  # Adam learning rate
    iters: int
    samples: int = 16  # antithetic pairs per iteration
    delta: float = 0.01  # finite-difference radius
    loss: str = "ce"
    targeted: bool = False
    target: int = -1
    num_classes: int = 13
    channels: tuple[int, int] = (3, 6)
    clip: tuple[float, float] | None = (0.0, 1.0)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class NAttackConfig:
    """NAttack (Li et al. 2019): a Gaussian N(μ, σ²I) over a latent
    perturbation, mapped through tanh into the clip box; each iteration
    scores a population with loss queries, z-scores the losses and takes an
    NES step on μ. CE by default: the ares hinge is flat wherever the model
    is confidently right, so a population that crosses no boundary would
    z-score to zero and μ would never move."""

    eps: float
    alpha: float = 0.008  # μ learning rate (the paper's η)
    iters: int = 100
    samples: int = 16  # population size per iteration (the paper's b)
    sigma: float = 0.1  # sampling std
    loss: str = "ce"
    targeted: bool = False
    target: int = -1
    num_classes: int = 13
    channels: tuple[int, int] = (3, 6)
    clip: tuple[float, float] | None = (0.0, 1.0)


def _query_setup(points, labels, cfg, mask, outputs_fn):
    """The perturbation domain the three share: (color0, m, adv_of,
    per_cloud_loss, direction)."""
    lo, hi = cfg.channels
    color0 = points[..., lo:hi]
    m = None if mask is None else mask.to(points.dtype)[..., None]
    ys = torch.full_like(labels, cfg.target) if cfg.targeted else labels
    direction = -1.0 if cfg.targeted else 1.0

    def adv_of(color):
        color = color if m is None else m * color + (1 - m) * color0
        return torch.cat([points[..., :lo], color, points[..., hi:]], dim=-1)

    def per_cloud_loss(color):
        """[B] loss values of one query, never differentiated."""
        with torch.no_grad():
            outputs = outputs_fn(adv_of(color))
            if cfg.loss == "ce":
                ce = per_point_ce(outputs, ys)  # [B, N]
                if m is not None:
                    w = m[..., 0]
                    return torch.sum(ce * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0)
                return torch.mean(ce, dim=1)
            if cfg.loss == "hinge":
                point_mask = mask if (cfg.targeted and mask is not None) else None
                return hinge_logit_loss(outputs, ys, cfg.num_classes, point_mask=point_mask)
            raise ValueError(cfg.loss)

    return color0, m, adv_of, per_cloud_loss, direction


def _draws(name, generator, noise, sample):
    """``noise`` itself, or a hook drawing from ``generator``."""
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError(f"{name} requires a generator or noise=")
    return lambda it, s: sample(generator)


def _score_attack(outputs_fn, points, labels, cfg, *, draw, fd_radius, step_fn, opt,
                  mask) -> AttackResult:
    """NES / SPSA: antithetic per-cloud loss queries → gradient estimate →
    optimiser step → projection (JAX `blackbox.py:125-185`)."""
    points = points.detach()
    color0, m, adv_of, per_cloud_loss, direction = _query_setup(
        points, labels, cfg, mask, outputs_fn)

    def grad_estimate(color, it):
        g = torch.zeros_like(color)
        for s in range(cfg.samples):
            u = draw(it, s).to(color.device)
            lp = per_cloud_loss(color + fd_radius * u)  # [B]
            lm = per_cloud_loss(color - fd_radius * u)
            g = g + (lp - lm)[:, None, None].to(color.dtype) * u
        return g / (2.0 * cfg.samples * fd_radius)

    def project(color):
        out = color0 + torch.clamp(color - color0, -cfg.eps, cfg.eps)
        if cfg.clip is not None:
            out = torch.clamp(out, cfg.clip[0], cfg.clip[1])
        if m is not None:
            out = m * out + (1 - m) * color0
        return out

    color = color0
    with torch.no_grad():
        for it in range(cfg.iters):
            step, opt = step_fn(grad_estimate(color, it), opt, it)
            color = project(color + direction * step)
    return finish_attack_result(
        outputs_fn, adv_of(color), points, labels, cfg.iters, channels=cfg.channels,
        targeted=cfg.targeted, target=cfg.target, mask=mask)


def nes_attack(
    outputs_fn: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg: NESConfig,
    *,
    mask: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise: Noise | None = None,
) -> AttackResult:
    """NES: Gaussian antithetic gradient estimate + PGD sign steps."""
    lo, hi = cfg.channels
    shape, dtype = points.shape[:-1] + (hi - lo,), points.dtype
    draw = _draws("nes_attack", generator, noise, lambda g: torch.randn(
        shape, generator=g, device=g.device, dtype=dtype))
    return _score_attack(
        outputs_fn, points, labels, cfg, draw=draw, fd_radius=cfg.sigma,
        step_fn=lambda g, opt, it: (cfg.alpha * torch.sign(g), opt), opt=None, mask=mask)


def spsa_attack(
    outputs_fn: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg: SPSAConfig,
    *,
    mask: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise: Noise | None = None,
) -> AttackResult:
    """SPSA: Rademacher antithetic gradient estimate + Adam steps (the
    bias corrections in float32, as the JAX step takes them)."""
    lo, hi = cfg.channels
    shape = points.shape[:-1] + (hi - lo,)
    draw = _draws("spsa_attack", generator, noise, lambda g: (
        2 * torch.randint(0, 2, shape, generator=g, device=g.device) - 1).to(torch.float32))
    b1 = torch.tensor(cfg.adam_b1, dtype=torch.float32)
    b2 = torch.tensor(cfg.adam_b2, dtype=torch.float32)

    def step_fn(g, opt, it):
        mu, nu = opt
        t = torch.tensor(it + 1, dtype=torch.float32)
        mu = cfg.adam_b1 * mu + (1 - cfg.adam_b1) * g
        nu = cfg.adam_b2 * nu + (1 - cfg.adam_b2) * g * g
        mu_hat = mu / (1 - b1**t).to(mu.device)
        nu_hat = nu / (1 - b2**t).to(nu.device)
        return cfg.alpha * mu_hat / (torch.sqrt(nu_hat) + cfg.adam_eps), (mu, nu)

    color0 = points[..., lo:hi]
    return _score_attack(
        outputs_fn, points, labels, cfg, draw=draw, fd_radius=cfg.delta, step_fn=step_fn,
        opt=(torch.zeros_like(color0), torch.zeros_like(color0)), mask=mask)


def nattack(
    outputs_fn: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg: NAttackConfig,
    *,
    mask: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise: Noise | None = None,
) -> AttackResult:
    """NAttack (JAX `blackbox.py:282-365`). Latent map: with a clip box the
    candidates are proj_ε(lo + (hi − lo)·(tanh(z) + 1)/2) and μ starts at
    the clean colours' preimage; with ``clip=None`` the latent is the
    perturbation itself, candidates color0 + proj_ε(z), and μ starts at 0.
    The population's draws are kept for the step (``samples`` tensors of
    the colours' shape), not redrawn."""
    points = points.detach()
    lo_ch, hi_ch = cfg.channels
    shape, dtype = points.shape[:-1] + (hi_ch - lo_ch,), points.dtype
    draw = _draws("nattack", generator, noise, lambda g: torch.randn(
        shape, generator=g, device=g.device, dtype=dtype))
    color0, m, adv_of, per_cloud_loss, direction = _query_setup(
        points, labels, cfg, mask, outputs_fn)
    lo, hi = cfg.clip if cfg.clip is not None else (None, None)

    def g(z):
        """Latent → candidate colour inside the ε-ball (and clip box)."""
        if cfg.clip is not None:
            x = lo + (hi - lo) * 0.5 * (torch.tanh(z) + 1.0)
            eta = torch.clamp(x - color0, -cfg.eps, cfg.eps)
            return torch.clamp(color0 + eta, lo, hi)
        return color0 + torch.clamp(z, -cfg.eps, cfg.eps)

    with torch.no_grad():
        if cfg.clip is not None:
            unit = torch.clamp((color0 - lo) / (hi - lo), 1e-6, 1 - 1e-6)
            mu = torch.atanh(2.0 * unit - 1.0)
        else:
            mu = torch.zeros_like(color0)
        for it in range(cfg.iters):
            es = [draw(it, s).to(mu.device) for s in range(cfg.samples)]
            fs = torch.stack([per_cloud_loss(g(mu + cfg.sigma * e)) for e in es])  # [S, B]
            f_std = torch.std(fs, dim=0, correction=0) + 1e-7
            f_hat = (fs - torch.mean(fs, dim=0)) / f_std  # z-scored (paper alg. 1)
            grad_mu = torch.zeros_like(mu)
            for fh, e in zip(f_hat, es):
                grad_mu = grad_mu + fh[:, None, None] * e
            mu = mu + direction * (cfg.alpha / (cfg.samples * cfg.sigma)) * grad_mu
    return finish_attack_result(
        outputs_fn, adv_of(g(mu)), points, labels, cfg.iters, channels=cfg.channels,
        targeted=cfg.targeted, target=cfg.target, mask=mask)
