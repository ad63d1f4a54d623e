"""The ares attack benchmark layer (port of
``pointsecguard_tpu/attacks/benchmark.py``): the registry, batched attack
evaluation with ares' five result arrays, minimal-distortion binary
search, the C&W coefficient search, per-iteration curves and the worst case over several attacks
(`RandLA-Net/ares/ares/benchmark/{attack,distortion,iteration}.py`).

Every harness takes a per-batch closure factory, ``make_outputs_fn(points)
→ outputs_fn``, not one closure for the whole dataset: the factory builds
the batch's plan once (PointNet++: the geometry, FPS and bottom-k kernels;
RandLA-Net: the kNN pyramid) and every forward of the batch reuses it,
however many queries the attack makes. NES at ``samples=16, iters=10``
makes 322 forwards a batch; rebuilding per query would launch the
geometry's kernels 322 times, not once. The results are the same, because
xyz never moves under a colour attack.

Randomness (PGD's random start, the score-based draws) comes from one
``torch.Generator`` that advances over the batches, where the JAX harness
splits its key once per batch. The single-batch harnesses replay the same
draws for every probe (the generator's state is restored before each),
as the JAX ones pass the same key to every probe.

``deepfool``, ``boundary`` and ``evolutionary`` take one decision per
shape (outputs [B, 1, K], ``--task cls``). DeepFool is untargeted by
construction; the decision attacks take goals ``'ut'`` and ``'t'``, the
targeted one seeded with an example the model already predicts as the
target (``AttackBenchmark`` harvests it from the batches before the first
attack, as ares scans its dataset).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable

import numpy as np
import torch

from pointsecguard_tpu_torch.attacks.blackbox import (
    NAttackConfig,
    NESConfig,
    SPSAConfig,
    nattack,
    nes_attack,
    spsa_attack,
)
from pointsecguard_tpu_torch.attacks.common import make_target_labels, pooled_rate
from pointsecguard_tpu_torch.attacks.cw import CWConfig, cw_color_attack
from pointsecguard_tpu_torch.attacks.decision import (
    BoundaryConfig,
    EvolutionaryConfig,
    boundary_attack,
    evolutionary_attack,
)
from pointsecguard_tpu_torch.attacks.deepfool import DeepFoolConfig, deepfool_attack
from pointsecguard_tpu_torch.attacks.pgd import PGDConfig, pgd_color_attack
from pointsecguard_tpu_torch.parallel.mesh import RankContext
from pointsecguard_tpu_torch.parallel.spmd_ops import gather_rows, sum_rows

MakeOutputs = Callable[[torch.Tensor], Callable[[torch.Tensor], torch.Tensor]]

# the ares registry (`benchmark/utils.py:8-20`)
ATTACKS: dict[str, type] = {
    "fgsm": PGDConfig,  # single step, α = ε, no random init
    "bim": PGDConfig,  # iterative, no random init
    "pgd": PGDConfig,  # iterative with a random start
    "mim": PGDConfig,  # BIM + L1-normalised gradient momentum
    "cw": CWConfig,
    "deepfool": DeepFoolConfig,  # white-box nearest-boundary crossing
    "nes": NESConfig,  # score-based, Gaussian antithetic queries
    "spsa": SPSAConfig,  # score-based, Rademacher antithetic queries
    "nattack": NAttackConfig,  # score-based distribution learning
    "boundary": BoundaryConfig,  # decision-based boundary walk
    "evolutionary": EvolutionaryConfig,  # decision-based (1+1)-ES
}
# deepfool crosses the nearest boundary: goal 'ut' only. A targeted drive
# scored untargeted ('tm') means nothing to a decision predicate
UNTARGETED_ONLY = frozenset({"deepfool"})
DECISION_ATTACKS = frozenset({"boundary", "evolutionary"})


def _generator(points: torch.Tensor, generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator(
        device=points.device).manual_seed(0)


def run_registered_attack(
    outputs_fn: Callable,
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg,
    *,
    mask: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    noise=None,
    start: torch.Tensor | None = None,
):
    """Dispatch a registry config to its engine (ares dispatches through
    its Attack base class, `attack/base.py`). ``noise`` reaches the
    score-based and decision engines; ``start``, the decision attacks'
    seeds, is refused by every other engine."""
    if start is not None and not isinstance(cfg, (BoundaryConfig, EvolutionaryConfig)):
        raise ValueError(f"start= is a decision-attack seed; {type(cfg).__name__} "
                         "does not take one")
    if isinstance(cfg, CWConfig):
        return cw_color_attack(outputs_fn, points, labels, cfg, mask=mask)
    if isinstance(cfg, DeepFoolConfig):
        return deepfool_attack(outputs_fn, points, labels, cfg, mask=mask)
    if isinstance(cfg, (BoundaryConfig, EvolutionaryConfig)):
        fn = boundary_attack if isinstance(cfg, BoundaryConfig) else evolutionary_attack
        return fn(outputs_fn, points, labels, cfg, mask=mask, start=start,
                  generator=None if noise is not None else _generator(points, generator),
                  noise=noise)
    for cls, fn in ((NESConfig, nes_attack), (SPSAConfig, spsa_attack),
                    (NAttackConfig, nattack)):
        if isinstance(cfg, cls):
            return fn(outputs_fn, points, labels, cfg, mask=mask,
                      generator=None if noise is not None else _generator(points, generator),
                      noise=noise)
    if cfg.rand_init_eps > 0:
        generator = _generator(points, generator)
    return pgd_color_attack(outputs_fn, points, labels, cfg, mask=mask, generator=generator)


def _rates(res, ctx: RankContext | None) -> tuple[float, float]:
    """The attack's accuracy and success rate over the whole batch: its
    (hits, points) counts summed over the ranks (``res.acc`` and
    ``res.success_rate`` in one process)."""
    acc, sr = pooled_rate(sum_rows(res.counts, ctx)).tolist()
    return acc, sr


def _whole(t: torch.Tensor, ctx: RankContext | None) -> np.ndarray:
    """The ranks' rows of ``t`` as the whole batch, on the host."""
    return gather_rows(t, ctx).cpu().numpy()


def _replace_if_field(cfg, **updates):
    """``dataclasses.replace`` restricted to the fields ``cfg`` declares."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: v for k, v in updates.items() if k in fields})


class _Replay:
    """Restore ``generator``'s state before every call: each probe sees the
    same draws."""

    def __init__(self, generator):
        self.generator = generator
        self.state = None if generator is None else generator.get_state()

    def __call__(self):
        if self.generator is not None:
            self.generator.set_state(self.state)
        return self.generator


def distortion_binsearch(
    make_outputs_fn: MakeOutputs,
    points: torch.Tensor,
    labels: torch.Tensor,
    base_cfg,
    *,
    success_acc: float = 1.0 / 13.0,
    init_lo: float = 0.0,
    init_hi: float | None = None,
    search_steps: int = 5,
    binsearch_steps: int = 10,
    mask: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    success_criterion: str = "auto",
    ctx: RankContext | None = None,
) -> tuple[float, dict]:
    """Minimal ε at which the attack succeeds, by exponential search then
    bisection (`distortion.py` protocol), for the ε-bounded configs
    (fgsm / bim / pgd / mim / nes / spsa / nattack). C&W, DeepFool and the
    decision attacks have no ε: they minimise distortion themselves, so
    they run once and report the achieved per-sample distortion where they
    succeeded (``details["optimized"]``; the scalar is the mean successful
    distortion, inf if none).

    Success = adversarial accuracy < ``success_acc`` (untargeted) or success
    rate > 0.9 (targeted); ``success_criterion="acc"`` forces the accuracy
    test for a targeted drive scored untargeted (goal 'tm'). α scales with
    ε (α = ε·α₀/ε₀). Returns (epsilon, details), details recording every
    probe. ``ctx``: this rank's rows of the batch (module docstring).
    """
    if success_criterion not in ("auto", "acc", "sr"):
        raise ValueError(f"unknown success_criterion {success_criterion!r}")
    outputs_fn = make_outputs_fn(points)
    replay = _Replay(generator)
    if not hasattr(base_cfg, "eps"):
        targeted = getattr(base_cfg, "targeted", False)
        if targeted and not isinstance(base_cfg, (BoundaryConfig, EvolutionaryConfig)):
            raise ValueError(
                "targeted C&W has no per-sample success signal here; use "
                "AttackBenchmark (--mode attack)")
        res = run_registered_attack(outputs_fn, points, labels, base_cfg, mask=mask,
                                    generator=replay())
        lab = _whole(labels, ctx)
        with torch.no_grad():
            clean_pred = _whole(torch.argmax(outputs_fn(points), dim=-1), ctx)
        batch_axes = tuple(range(1, lab.ndim))
        adv_pred = _whole(res.adv_pred, ctx)
        clean_acc = (clean_pred == lab).mean(axis=batch_axes)
        if targeted:
            tgt = base_cfg.target
            eligible = (clean_pred != tgt).all(axis=batch_axes)
            succ = eligible & (adv_pred == tgt).all(axis=batch_axes)
        else:
            # samples the clean model already "breaks" would count at ~zero
            # distortion: only the eligible ones are scored (on the
            # classifiers, exactly the clean-correct ones)
            eligible = clean_acc >= success_acc
            succ = eligible & ((adv_pred == lab).mean(axis=batch_axes) < success_acc)
        dists = _whole(res.l2_dist, ctx)
        details = {"optimized": True, "dist": dists.tolist(), "success": succ.tolist(),
                   "eligible": eligible.tolist(), "clean_acc": clean_acc.tolist()}
        return (float(dists[succ].mean()) if succ.any() else float("inf")), details
    alpha_ratio = base_cfg.alpha / base_cfg.eps
    details: dict = {"probes": []}
    use_sr = success_criterion == "sr" or (success_criterion == "auto" and base_cfg.targeted)

    def succeeded(eps: float) -> bool:
        cfg = dataclasses.replace(base_cfg, eps=float(eps), alpha=float(eps) * alpha_ratio)
        res = run_registered_attack(outputs_fn, points, labels, cfg, mask=mask,
                                    generator=replay())
        acc, sr = _rates(res, ctx)
        ok = sr > 0.9 if use_sr else acc < success_acc
        details["probes"].append({"eps": float(eps), "acc": acc, "sr": sr, "success": ok})
        return ok

    hi = init_hi if init_hi is not None else base_cfg.eps
    lo = init_lo
    found = succeeded(hi)  # exponential search for an upper bracket
    for _ in range(search_steps):
        if found:
            break
        lo, hi = hi, hi * 2.0
        found = succeeded(hi)
    if not found:
        return float("inf"), details
    for _ in range(binsearch_steps):
        mid = 0.5 * (lo + hi)
        if succeeded(mid):
            hi = mid
        else:
            lo = mid
    details["epsilon"] = hi
    return hi, details


def cw_coefficient_binsearch(
    make_outputs_fn: MakeOutputs,
    points: torch.Tensor,
    labels: torch.Tensor,
    base_cfg: CWConfig,
    *,
    mask: torch.Tensor | None = None,
    success_sr: float = 0.9,
    search_steps: int = 5,
    binsearch_steps: int = 6,
    coeff_fields: tuple[str, ...] = ("smooth_coeff", "l2_coeff"),
    ctx: RankContext | None = None,
) -> tuple[float, dict]:
    """Largest distortion-penalty coefficient c at which a targeted C&W run
    reaches a success rate above ``success_sr`` (JAX
    `attacks/benchmark.py:212-285`): the C&W analogue of the distortion
    search (`distortion.py:8-370` searches ε; C&W's budget knob is the c
    that multiplies the smooth + L2 penalty, `NU_target_test_semseg.py:181`).

    c is the value of ``coeff_fields[0]``; a probe at c scales every field
    of ``coeff_fields`` by the same factor c / c0, c0 the budget's own, so
    that their ratio holds. (JAX sets every field to c, so ``l2_coeff``
    loses its own value wherever it differs from the first.) The search
    probes down from c0 by quarters (success gets easier as the penalty
    shrinks; c = 0 is unbounded distortion), then bisects in log space.

    Returns (c_threshold, details): the largest probed c that succeeded;
    c0 if the budget itself succeeds, 0 if only c = 0 does, nan if none.
    ``details["probes"]`` records each probe's c, sr, acc, mean L2 and mean
    exit step (rounded as JAX's), over the whole batch on ``ctx``'s ranks."""
    c0 = float(getattr(base_cfg, coeff_fields[0]))
    if c0 <= 0:
        raise ValueError(f"{coeff_fields[0]} = {c0}: no coefficient to scale")
    base = {f: float(getattr(base_cfg, f)) for f in coeff_fields}
    outputs_fn = make_outputs_fn(points)
    details: dict = {"probes": []}

    def probe(c: float) -> bool:
        # c · (v / c0): exactly c for every field equal to c0
        cfg = _replace_if_field(base_cfg, **{f: c * (v / c0) for f, v in base.items()})
        res = cw_color_attack(outputs_fn, points, labels, cfg, mask=mask)
        acc, sr = _rates(res, ctx)
        details["probes"].append({
            "c": float(c), "sr": round(sr, 4), "acc": round(acc, 4),
            "l2_mean": round(float(gather_rows(res.l2_dist, ctx).mean()), 3),
            "steps_mean": round(float(gather_rows(res.steps_b, ctx).float().mean()), 1)})
        return sr > success_sr

    def done(c: float) -> tuple[float, dict]:
        details["c_threshold"] = c
        return c, details

    if probe(c0):
        return done(c0)  # the budget already succeeds
    hi_fail = lo = c0
    for _ in range(search_steps):
        hi_fail, lo = lo, lo / 4.0
        if probe(lo):
            break
    else:
        return done(0.0 if probe(0.0) else float("nan"))
    for _ in range(binsearch_steps):  # log-space bisection on [lo (success), hi_fail]
        mid = math.exp(0.5 * (math.log(lo) + math.log(hi_fail)))
        if probe(mid):
            lo = mid
        else:
            hi_fail = mid
    return done(lo)


def iteration_curve(
    make_outputs_fn: MakeOutputs,
    points: torch.Tensor,
    labels: torch.Tensor,
    cfg,
    *,
    mask: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    num_probes: int = 10,
    ctx: RankContext | None = None,
) -> list[dict]:
    """Accuracy / success rate / mean L2 after k iterations for k along the
    budget (`iteration.py` protocol: the attack re-runs for every probe).
    Any iteration-bounded config (C&W counts ``steps`` and is rejected);
    ``ctx`` as in ``distortion_binsearch``."""
    if not hasattr(cfg, "iters"):
        raise ValueError(f"{type(cfg).__name__} has no iteration budget to sweep")
    outputs_fn = make_outputs_fn(points)
    replay = _Replay(generator)
    probes = []
    step = max(cfg.iters // num_probes, 1)
    for iters in range(step, cfg.iters + 1, step):
        sub = _replace_if_field(cfg, iters=iters, early_exit_sr=0.0)
        res = run_registered_attack(outputs_fn, points, labels, sub, mask=mask,
                                    generator=replay())
        acc, sr = _rates(res, ctx)
        probes.append({"iters": iters, "acc": acc, "sr": sr,
                       "l2": float(torch.mean(gather_rows(res.l2_dist, ctx)))})
    return probes


def load_attack(attack_name: str, init_kwargs: dict):
    """A registry config by name, keeping only the kwargs the config
    declares (ares filters by the attack class's ``__init__`` signature,
    `benchmark/utils.py:23-38`)."""
    cls = ATTACKS[attack_name]
    fields = {f.name for f in dataclasses.fields(cls)}
    cfg = cls(**{k: v for k, v in init_kwargs.items() if k in fields})
    if attack_name == "fgsm":
        cfg = dataclasses.replace(cfg, iters=1, alpha=cfg.eps, rand_init_eps=0.0)
    elif attack_name == "bim":
        cfg = dataclasses.replace(cfg, rand_init_eps=0.0, momentum=0.0)
    elif attack_name == "mim" and cfg.momentum == 0.0:
        # MIM = BIM + gradient momentum at Dong et al.'s decay 1.0
        cfg = dataclasses.replace(cfg, rand_init_eps=0.0, momentum=1.0)
    elif attack_name == "pgd" and cfg.rand_init_eps == 0.0:
        # PGD = BIM + a uniform start in the ε-ball (ares `pgd.py`)
        cfg = dataclasses.replace(cfg, rand_init_eps=cfg.eps)
    return cfg


def worst_case_run(
    attack_names,
    make_outputs_fn: MakeOutputs,
    batches,
    *,
    goal: str = "ut",
    distance_metric: str = "l_2",
    origin: int | None = None,
    target: int | None = None,
    generator: torch.Generator | None = None,
    logger: logging.Logger | None = None,
    ctx: RankContext | None = None,
    **kwargs,
):
    """AutoAttack-style worst case (Croce & Hein 2020): run several registry
    attacks over the same batches; a point counts as broken if any attack
    breaks it, and a sample's distortion is the least among its successful
    attacks. Every attack starts from the same generator state.

    Returns ``(robust_acc, per_attack, combined)``: ``per_attack`` maps
    each name to its summary, ``combined`` holds the union arrays
    (``total``, ``succ``, ``dist``); on ``ctx``'s ranks, of the whole
    batches (``AttackBenchmark.run`` gathers them)."""
    batches = list(batches)
    replay = _Replay(generator)
    per_attack: dict = {}
    union_succ = totals = min_dist = None
    for name in attack_names:
        bench = AttackBenchmark(name, make_outputs_fn, goal=goal,
                                distance_metric=distance_metric, origin=origin,
                                target=target, ctx=ctx, **kwargs)
        acc, acc_adv, total, succ, dist = bench.run(batches, generator=replay())
        succ_rate = succ.sum() / max(total.sum(), 1)
        per_attack[name] = {"acc": float(acc.mean()), "adv_acc": float(acc_adv.mean()),
                            "succ_rate": float(succ_rate), "dist_mean": float(dist.mean())}
        if logger is not None:
            logger.info("%-12s adv_acc=%.4f succ=%.4f dist=%.4f",
                        name, acc_adv.mean(), succ_rate, dist.mean())
        sample_succ = succ.reshape(len(dist), -1).any(axis=1)
        if union_succ is None:
            union_succ, totals = succ.copy(), total
            min_dist = np.where(sample_succ, dist, np.inf)
        else:
            union_succ |= succ
            min_dist = np.where(sample_succ, np.minimum(min_dist, dist), min_dist)
    robust_acc = 1.0 - union_succ.sum() / max(totals.sum(), 1)
    if logger is not None:
        logger.info("WORST-CASE robust_acc=%.4f (union of %s)",
                    robust_acc, ",".join(attack_names))
    return float(robust_acc), per_attack, {"total": totals, "succ": union_succ,
                                           "dist": min_dist}


class AttackBenchmark:
    """Run a registered attack over a dataset and report ares' five result
    arrays (`benchmark/attack.py:52-115`): per-point clean correctness,
    adversarial correctness, eligibility ("total") and success, and
    per-block distortion.

    Goals follow ares (`attack.py:128-135`): ``'ut'`` / ``'tm'`` count a
    point iff its clean prediction is right, success = the adversarial
    prediction differs from the label; ``'t'`` counts a point iff its clean
    prediction is not the target, success = the adversarial prediction is
    the target. ``'tm'`` drives the attack with the target labels and the
    targeted direction as ``'t'`` does (`bim.py:80-82,144`); only its
    scoring is untargeted. Points are scored one by one, the reference's
    segmentation accounting (`NB_nontarget_test_semseg.py:210-214`). On
    ``ctx``'s ranks every batch holds the rank's rows, and the arrays are
    gathered into the whole batch's, in order, on every rank.
    """

    def __init__(
        self,
        attack_name: str,
        make_outputs_fn: MakeOutputs,
        *,
        goal: str = "ut",
        distance_metric: str = "l_2",
        origin: int | None = None,
        target: int | None = None,
        ctx: RankContext | None = None,
        **kwargs,
    ):
        if goal not in ("ut", "tm", "t"):
            raise ValueError(f"unknown goal {goal!r}")
        if goal != "ut" and attack_name in UNTARGETED_ONLY:
            raise ValueError(f"{attack_name} is untargeted by construction; only goal "
                             f"'ut' is supported (got {goal!r})")
        if goal == "tm" and attack_name in DECISION_ATTACKS:
            raise ValueError(f"{attack_name} queries a decision predicate — a targeted "
                             "drive scored untargeted ('tm') is meaningless; use goal "
                             "'ut' or 't'")
        if distance_metric not in ("l_2", "l_inf"):
            raise ValueError(f"unknown distance metric {distance_metric!r}")
        if goal == "t" and target is None:
            raise ValueError("targeted goal needs target=")
        if goal == "t" and origin is None and attack_name not in DECISION_ATTACKS:
            # a decision attack drives the whole shape: no origin mask
            raise ValueError("targeted goal needs origin= and target=")
        if goal == "tm" and target is None:
            raise ValueError("goal 'tm' needs target=")
        kwargs.setdefault("targeted", goal in ("t", "tm"))
        if target is not None:
            kwargs.setdefault("target", target)
        self.attack_name = attack_name
        self.cfg = load_attack(attack_name, kwargs)
        self.make_outputs_fn = make_outputs_fn
        self.goal = goal
        self.distance_metric = distance_metric
        self.origin, self.target = origin, target
        self.ctx = ctx
        # targeted decision attacks: one example the model predicts as the
        # target seeds every sample's start (`gen_starting_points`'s
        # per-label cache, `benchmark/utils.py:72-84`)
        self._start_example: torch.Tensor | None = None

    def _harvest_start(self, points, clean_pred):
        """Keep the first example of the whole batch predicted as the
        target; that example broadcast over the rank's rows, or None before
        one is seen."""
        if self._start_example is None:
            whole = gather_rows(points, self.ctx)
            hits = (gather_rows(clean_pred, self.ctx) == self.target)
            hits = hits.reshape(len(whole), -1).any(dim=1)
            if bool(hits.any()):
                self._start_example = whole[int(torch.argmax(hits.int()))].clone()
        if self._start_example is None:
            return None
        return self._start_example.to(points.device).expand(len(points), -1, -1)

    def run(self, batches, logger: logging.Logger | None = None, *,
            generator: torch.Generator | None = None):
        """Attack every (points [B, N, C], labels [B, N]) batch; return the
        five concatenated numpy arrays in ares' order (acc, acc_adv,
        total, succ, dist)."""
        acc, acc_adv, total, succ, dist = [], [], [], [], []
        seeded = self.goal == "t" and self.attack_name in DECISION_ATTACKS
        if seeded and self._start_example is None:
            # the seed first, as ares scans its dataset before attacking:
            # otherwise batches before the first hit would run unseeded
            batches = list(batches)
            for points, _ in batches:
                with torch.no_grad():
                    self._harvest_start(points, torch.argmax(
                        self.make_outputs_fn(points)(points), dim=-1))
                if self._start_example is not None:
                    break
        for points, labels in batches:
            outputs_fn = self.make_outputs_fn(points)
            with torch.no_grad():
                clean_pred = torch.argmax(outputs_fn(points), dim=-1)
            start = None
            if seeded:
                # the targeted predicate lives in the config: no mask
                ys_attack, mask = labels, None
                start = self._harvest_start(points, clean_pred)
            elif self.goal == "t":
                ys_attack, mask = make_target_labels(labels, self.origin, self.target)
            elif self.goal == "tm":
                # the full target vector, no origin mask (`bim.py:144`)
                ys_attack, mask = torch.full_like(labels, self.target), None
            else:
                ys_attack, mask = labels, None
            generator = _generator(points, generator)
            res = run_registered_attack(outputs_fn, points, ys_attack, self.cfg, mask=mask,
                                        generator=generator, start=start)
            lab, clean, adv = (_whole(t, self.ctx).ravel()
                               for t in (labels, clean_pred, res.adv_pred))
            accs = clean == lab
            accs_adv = adv == lab
            if self.goal == "t":
                totals = clean != self.target
                succs = totals & (adv == self.target)
            else:
                totals = accs
                succs = totals & ~accs_adv
            diff = _whole(res.points_adv - points, self.ctx)
            diff = diff.reshape(len(diff), -1)
            if self.distance_metric == "l_2":
                dists = np.linalg.norm(diff, axis=1)
            else:
                dists = np.max(np.abs(diff), axis=1)
            for out, x in zip((acc, acc_adv, total, succ, dist),
                              (accs, accs_adv, totals, succs, dists)):
                out.append(x)
            if logger is not None:
                logger.info("acc={:3f}, adv_acc={:3f}, succ={:3f}, dist_mean={:3f}".format(
                    accs.mean(), accs_adv.mean(), succs.sum() / max(totals.sum(), 1),
                    dists.mean()))
        return tuple(map(np.concatenate, (acc, acc_adv, total, succ, dist)))
