"""Decision-based black-box attacks: Boundary and Evolutionary (port of
``pointsecguard_tpu/attacks/decision.py:55-301``; Brendel et al. 2018,
Dong et al. 2019, the ares registry's ``boundary`` and ``evolutionary``).

The adversary sees the argmax prediction and nothing else: ``is_adv``
reads no logit, loss or gradient. Each iteration makes one decision query
per sample, the batch queried together. The starting points follow ares'
``gen_starting_points``: untargeted, the first of ``init_tries`` uniform
draws that is adversarial (the search is bounded, where ares loops
forever; a sample that finds none keeps its clean input and is left out
of every update); targeted, seeds the model already predicts as the
target, passed as ``start=`` (``AttackBenchmark`` harvests them).

Draws: ``noise(kind, i)`` gives them (``"init"``: the ``i``-th random
search draw, uniform in the box or in ±``init_scale`` around the clean
input; ``"step"``: the ``i``-th iteration's standard normal), so that the
CPU tests can feed ``jax.random``'s; else they come from ``generator``,
drawn for the global batch of which a data-parallel rank keeps its rows
(``utils.runtime.batch_draw``).
Both attacks run a fixed number of iterations, as the JAX loops do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pointsecguard_tpu_torch.attacks.common import AttackResult, finish_attack_result
from pointsecguard_tpu_torch.attacks.deepfool import check_one_decision
from pointsecguard_tpu_torch.utils.runtime import batch_draw

Noise = Callable[[str, int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BoundaryConfig:
    """Brendel et al. 2018. The spherical (orthogonal) step targets a 50 %
    acceptance rate and the source (contraction) step 25 %, by
    Robbins-Monro updates of the log step sizes after every query."""

    iters: int = 200
    init_tries: int = 20  # uniform random-search draws for the start point
    spherical_step: float = 0.1
    source_step: float = 0.1
    adapt_rate: float = 0.1  # κ in step *= exp(κ·(accept − target))
    targeted: bool = False  # decision = (pred == target) instead of != y
    target: int = -1
    channels: tuple[int, int] = (0, 3)
    clip: tuple[float, float] | None = None
    init_scale: float = 1.0  # unclipped domains: init ~ x0 + U(−s, s)


@dataclasses.dataclass(frozen=True)
class EvolutionaryConfig:
    """Dong et al. 2019: (1+1)-ES with a diagonal covariance and a bias
    toward the original input; σ and μ follow the 1/5-success rule."""

    iters: int = 200
    init_tries: int = 20
    sigma: float = 0.3  # mutation norm, relative to the current distance
    mu: float = 0.1  # initial bias toward the original
    adapt_rate: float = 0.1  # κ in (μ, σ) *= exp(κ·(p_succ − 1/5))
    cov_rate: float = 0.05  # c_c: diagonal-covariance adaptation rate
    succ_ema: float = 0.1  # c_p: success-probability EMA rate
    targeted: bool = False
    target: int = -1
    channels: tuple[int, int] = (0, 3)
    clip: tuple[float, float] | None = None
    init_scale: float = 1.0


def _draws(cfg, color0: torch.Tensor, noise: Noise | None,
           generator: torch.Generator | None) -> Noise:
    """``noise`` itself, or the same draws from ``generator``."""
    if noise is not None:
        return lambda kind, i: noise(kind, i).to(color0)
    if generator is None:
        raise ValueError(f"{type(cfg).__name__} needs a generator or noise=")
    lo, hi = cfg.clip if cfg.clip is not None else (-cfg.init_scale, cfg.init_scale)

    def draw(kind, i):
        sample = torch.rand if kind == "init" else torch.randn
        u = batch_draw(lambda full: sample(full, generator=generator, device=generator.device),
                       color0.shape).to(color0)
        if kind == "init":
            u = lo + (hi - lo) * u
            return u if cfg.clip is not None else color0 + u
        return u

    return draw


def _decision_setup(outputs_fn, points, labels, cfg, mask, start, draw):
    """Shape checks, the argmax-only oracle, the box and the starting
    points (``start`` seeds where they are adversarial, then the bounded
    uniform search): (color0, adv_of, is_adv, clip_box, found, start)."""
    if mask is not None:
        raise ValueError(f"{type(cfg).__name__} drives the full shape; mask is not "
                         "supported (use targeted=/target= for the targeted goal)")
    check_one_decision(points, labels, "decision-based attacks")
    lo, hi = cfg.channels
    color0 = points[..., lo:hi]
    y = labels[:, 0]

    def adv_of(color):
        return torch.cat([points[..., :lo], color, points[..., hi:]], dim=-1)

    @torch.no_grad()
    def is_adv(color):
        """[B] bool: the only thing the adversary observes."""
        pred = torch.argmax(outputs_fn(adv_of(color))[:, 0, :], dim=-1)
        return pred == cfg.target if cfg.targeted else pred != y

    def clip_box(color):
        return color if cfg.clip is None else torch.clamp(color, cfg.clip[0], cfg.clip[1])

    if start is not None:
        seed = start[..., lo:hi] if start.shape == points.shape else start
        found = is_adv(seed)
        cur = torch.where(found[:, None, None], seed, color0)
    else:
        found = torch.zeros(len(color0), dtype=torch.bool, device=color0.device)
        cur = color0
    for t in range(cfg.init_tries):
        d = draw("init", t)
        ok = is_adv(d) & ~found
        cur = torch.where(ok[:, None, None], d, cur)
        found = found | ok
    return color0, adv_of, is_adv, clip_box, found, cur


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x**2, dim=(1, 2)) + 1e-20)  # [B]


def _finish(outputs_fn, adv_of, color_adv, points, labels, cfg) -> AttackResult:
    return finish_attack_result(
        outputs_fn, adv_of(color_adv), points, labels, cfg.iters, channels=cfg.channels,
        targeted=cfg.targeted, target=cfg.target,
        mask=torch.ones_like(labels, dtype=torch.bool) if cfg.targeted else None)


@torch.no_grad()
def boundary_attack(
    outputs_fn: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg: BoundaryConfig,
    *,
    mask: torch.Tensor | None = None,
    start: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise: Noise | None = None,
) -> AttackResult:
    """Walk along the decision boundary toward the original input: an
    orthogonal step on the sphere around it, then a contraction toward it;
    a candidate is taken only if it stays adversarial. ``start`` seeds
    adversarial starting points (full [B, N, C] inputs or the channel
    slice)."""
    points = points.detach()
    draw = _draws(cfg, points[..., slice(*cfg.channels)], noise, generator)
    color0, adv_of, is_adv, clip_box, found, adv = _decision_setup(
        outputs_fn, points, labels, cfg, mask, start, draw)
    B = len(color0)
    # the per-sample step sizes are float32 whatever the points' dtype, as
    # in the JAX loop (its weakly typed carry takes the float32 of the
    # acceptance flag)
    sph = torch.full((B,), cfg.spherical_step, dtype=torch.float32, device=color0.device)
    src = torch.full_like(sph, cfg.source_step)
    for i in range(cfg.iters):
        d = color0 - adv  # toward the original
        dist = _norm(d)
        eta = draw("step", i)
        # orthogonal to d, scaled to the spherical step
        proj = torch.sum(eta * d, dim=(1, 2)) / (dist**2 + 1e-20)
        eta = eta - proj[:, None, None] * d
        eta = eta * (sph * dist / _norm(eta))[:, None, None]
        cand = adv + eta
        # back onto the sphere of radius dist around the original
        cand = color0 - (color0 - cand) * (dist / _norm(color0 - cand))[:, None, None]
        cand = clip_box(cand + src[:, None, None] * (color0 - cand))
        ok = is_adv(cand) & found
        adv = torch.where(ok[:, None, None], cand, adv)
        okf = ok.float()
        sph = sph * torch.exp(cfg.adapt_rate * (okf - 0.5))
        src = src * torch.exp(cfg.adapt_rate * (okf - 0.25))
    return _finish(outputs_fn, adv_of, adv, points, labels, cfg)


@torch.no_grad()
def evolutionary_attack(
    outputs_fn: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg: EvolutionaryConfig,
    *,
    mask: torch.Tensor | None = None,
    start: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise: Noise | None = None,
) -> AttackResult:
    """(1+1)-ES on the perturbation: a Gaussian mutation under a learned
    diagonal covariance plus a bias toward the original; a candidate is
    taken only if it is closer and still adversarial."""
    points = points.detach()
    draw = _draws(cfg, points[..., slice(*cfg.channels)], noise, generator)
    color0, adv_of, is_adv, clip_box, found, adv = _decision_setup(
        outputs_fn, points, labels, cfg, mask, start, draw)
    B = len(color0)
    # E‖sqrt(cov)·n‖ ≈ √D for a mean-1 diagonal: σ is then the mutation's
    # norm relative to the current distance, whatever D
    sqrt_d = torch.sqrt(torch.tensor(float(color0[0].numel()), dtype=color0.dtype))
    cov = torch.ones_like(color0)
    # μ, σ and the success rate in float32, as in the JAX loop (see
    # boundary_attack)
    mu = torch.full((B,), cfg.mu, dtype=torch.float32, device=color0.device)
    sig = torch.full_like(mu, cfg.sigma)
    p = torch.full_like(mu, 0.2)
    for i in range(cfg.iters):
        dist = _norm(color0 - adv)
        n = draw("step", i)
        z = (sig * dist)[:, None, None] * torch.sqrt(cov) * n / sqrt_d.to(color0.device)
        cand = clip_box(adv + z + mu[:, None, None] * (color0 - adv))
        ok = is_adv(cand) & (_norm(color0 - cand) < dist) & found
        okf = ok.float()
        adv = torch.where(ok[:, None, None], cand, adv)
        # success EMA → the 1/5 rule on (μ, σ) at a fixed ratio
        p = (1 - cfg.succ_ema) * p + cfg.succ_ema * okf
        factor = torch.exp(cfg.adapt_rate * (p - 0.2))
        mu = mu * factor
        sig = sig * factor
        # diagonal CMA: a successful mutation's coordinates grow their
        # variance; renormalised to mean 1
        cov_new = (1 - cfg.cov_rate) * cov + cfg.cov_rate * n**2
        cov_new = cov_new / torch.mean(cov_new, dim=(1, 2), keepdim=True)
        cov = torch.where(ok[:, None, None], cov_new, cov)
    return _finish(outputs_fn, adv_of, adv, points, labels, cfg)
