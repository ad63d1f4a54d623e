"""The port's DeepFool and decision-based attacks (Boundary, Evolutionary)
against the JAX package, on the CPU, in float64 on both sides
(``jax.enable_x64``).

A small classifier over whole shapes ([B, N, 6] → [B, 1, K]) stands in for
the model. DeepFool is deterministic; the decision attacks take their
draws by argument: each test regenerates ``jax.random``'s from the same key
and ``split`` sequence as the JAX engines (`decision.py:138-157,191-196`)
and hands them over through ``noise=``. After 12 iterations the
adversarial points agree within 1e-10, with the same predictions, success
rate and step count. The two packages' float64 arithmetic differs by an
ulp here and there (≤ 6e-16 after 10 iterations), and each iteration's
acceptance is a comparison (adversarial, and for Evolutionary closer than
before) that an ulp can tip: over 30 iterations one clipped Evolutionary
walk takes a candidate that JAX's rejects, so there the bound is 1e-6. The registry and
``AttackBenchmark`` then run all three through the port's harness: the
targeted decision goal is seeded from an example the model predicts as
the target, harvested before the first attack, as the JAX harness does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.attacks import benchmark as jbench
from pointsecguard_tpu.attacks import decision as jdecision
from pointsecguard_tpu.attacks import deepfool as jdeepfool
from pointsecguard_tpu_torch.attacks import benchmark as tbench
from pointsecguard_tpu_torch.attacks import decision as tdecision
from pointsecguard_tpu_torch.attacks import deepfool as tdeepfool

K = 5
_RNG = np.random.default_rng(0)
_W1 = _RNG.standard_normal((6, 16))
_W2 = _RNG.standard_normal((16, K))


def _jax_model(p):
    h = jnp.tanh(p @ _W1.astype(p.dtype))
    return (jnp.mean(h, axis=1) @ _W2.astype(p.dtype))[:, None, :]


def _torch_model(p):
    h = torch.tanh(p @ torch.from_numpy(_W1).to(p.dtype))
    return (torch.mean(h, dim=1) @ torch.from_numpy(_W2).to(p.dtype))[:, None, :]


def _inputs(B=4, N=32, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.5, (B, N, 6))
    labels = np.argmax(np.asarray(_torch_model(torch.from_numpy(pts)))[:, 0], -1)
    return pts, labels[:, None].astype(np.int64)


@pytest.mark.parametrize("distance,clip", [("l_2", None), ("l_inf", None), ("l_2", (-1.0, 1.0))])
def test_deepfool_matches_jax(distance, clip):
    cfg = jdeepfool.DeepFoolConfig(iters=20, distance=distance, clip=clip)
    pts, labels = _inputs()
    with jax.enable_x64(True):
        want = jax.tree_util.tree_map(np.asarray, jdeepfool.deepfool_attack(
            _jax_model, jnp.asarray(pts), jnp.asarray(labels), cfg))
    got = tdeepfool.deepfool_attack(_torch_model, torch.from_numpy(pts),
                                    torch.from_numpy(labels),
                                    tdeepfool.DeepFoolConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(got.points_adv.numpy(), want.points_adv, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got.adv_pred.numpy(), want.adv_pred)
    np.testing.assert_allclose(got.l2_dist.numpy(), want.l2_dist, rtol=1e-10)
    assert int(got.steps) == int(want.steps) < cfg.iters  # the all-done exit
    assert float(got.acc) == float(want.acc) == 0.0


def _decision_draws(key, cfg, color0):
    """The JAX engines' draws: ``key, ki = split(key)``; the init search's
    ``split(ki, init_tries)`` uniform draws; then per iteration ``key, kn =
    split(key)`` and one standard normal."""
    key, ki = jax.random.split(key)
    init = []
    for k in jax.random.split(ki, cfg.init_tries):
        if cfg.clip is not None:
            init.append(np.asarray(jax.random.uniform(k, color0.shape, minval=cfg.clip[0],
                                                      maxval=cfg.clip[1])))
        else:
            init.append(color0 + np.asarray(jax.random.uniform(
                k, color0.shape, minval=-cfg.init_scale, maxval=cfg.init_scale)))
    step = []
    for _ in range(cfg.iters):
        key, kn = jax.random.split(key)
        step.append(np.asarray(jax.random.normal(kn, color0.shape)))
    return {"init": init, "step": step}


_DECISION = {
    "boundary": (jdecision.BoundaryConfig, jdecision.boundary_attack,
                 tdecision.BoundaryConfig, tdecision.boundary_attack),
    "evolutionary": (jdecision.EvolutionaryConfig, jdecision.evolutionary_attack,
                     tdecision.EvolutionaryConfig, tdecision.evolutionary_attack),
}


@pytest.mark.parametrize("case", ["untargeted", "targeted_start", "clipped"])
@pytest.mark.parametrize("name", sorted(_DECISION))
def test_decision_attacks_match_jax_on_its_draws(name, case):
    jcfg_cls, jengine, tcfg_cls, tengine = _DECISION[name]
    kw = {"iters": 30, "init_tries": 6}
    if case == "targeted_start":
        kw.update(targeted=True, target=2)
    if case == "clipped":
        kw.update(clip=(-1.5, 1.5))
    cfg = jcfg_cls(**kw)
    pts, labels = _inputs()
    start = None
    if case == "targeted_start":
        # seeds: shapes the model predicts as the target
        cand = np.random.default_rng(4).normal(0, 1.0, (64, 32, 6))
        preds = np.asarray(_torch_model(torch.from_numpy(cand)))[:, 0].argmax(-1)
        assert (preds == 2).any()
        start = np.broadcast_to(cand[np.argmax(preds == 2)], pts.shape).copy()
    key = jax.random.PRNGKey(3)
    for iters, atol in ((12, 1e-10), (30, 1e-6)):
        cfg = dataclasses.replace(cfg, iters=iters)
        with jax.enable_x64(True):
            want = jax.tree_util.tree_map(np.asarray, jengine(
                _jax_model, jnp.asarray(pts), jnp.asarray(labels), cfg, key=key,
                start=None if start is None else jnp.asarray(start)))
            draws = _decision_draws(key, cfg, pts[..., :3])
        got = tengine(_torch_model, torch.from_numpy(pts), torch.from_numpy(labels),
                      tcfg_cls(**dataclasses.asdict(cfg)),
                      start=None if start is None else torch.from_numpy(start),
                      noise=lambda kind, i: torch.from_numpy(draws[kind][i].copy()))
        assert got.points_adv.dtype == torch.float64
        np.testing.assert_allclose(got.points_adv.numpy(), want.points_adv, rtol=0, atol=atol)
        np.testing.assert_array_equal(got.adv_pred.numpy(), want.adv_pred)
        np.testing.assert_allclose(got.l2_dist.numpy(), want.l2_dist, rtol=atol)
        assert float(got.success_rate) == pytest.approx(float(want.success_rate), abs=1e-6)
        assert int(got.steps) == int(want.steps) == cfg.iters
    # only xyz moved, and the walk made progress from its start
    np.testing.assert_array_equal(got.points_adv.numpy()[..., 3:], pts[..., 3:])
    assert (got.l2_dist.numpy() > 0).any()


def test_decision_oracle_reads_the_argmax_only():
    """A model whose outputs are replaced by a one-hot of their argmax
    gives the same walk: nothing but the decision reaches the attack."""
    pts, labels = _inputs()
    cfg = tdecision.BoundaryConfig(iters=10, init_tries=4)

    def one_hot(p):
        out = _torch_model(p)
        return torch.nn.functional.one_hot(out.argmax(-1), K).to(out)

    runs = [tdecision.boundary_attack(f, torch.from_numpy(pts), torch.from_numpy(labels), cfg,
                                      generator=torch.Generator().manual_seed(1))
            for f in (_torch_model, one_hot)]
    np.testing.assert_array_equal(runs[0].points_adv.numpy(), runs[1].points_adv.numpy())


def test_registry_holds_all_eleven():
    assert set(tbench.ATTACKS) == set(jbench.ATTACKS)
    assert tbench.UNTARGETED_ONLY == jbench.UNTARGETED_ONLY
    assert tbench.DECISION_ATTACKS == jbench.DECISION_ATTACKS
    with pytest.raises(ValueError, match="start= is a decision-attack seed"):
        tbench.run_registered_attack(_torch_model, torch.zeros(1, 4, 6),
                                     torch.zeros(1, 1, dtype=torch.long),
                                     tbench.load_attack("deepfool", {}),
                                     start=torch.zeros(1, 4, 6))
    with pytest.raises(ValueError, match="untargeted by construction"):
        tbench.AttackBenchmark("deepfool", lambda p: _torch_model, goal="t", target=1,
                               origin=0)
    with pytest.raises(ValueError, match="meaningless"):
        tbench.AttackBenchmark("boundary", lambda p: _torch_model, goal="tm", target=1)


def test_attack_benchmark_deepfool_matches_jax():
    """ares' five arrays of a deterministic engine equal JAX's."""
    pts, labels = _inputs(B=6)
    kwargs = {"iters": 10, "channels": (0, 3), "clip": None}
    with jax.enable_x64(True):
        want = jbench.AttackBenchmark("deepfool", _jax_model, **kwargs).run(
            [(jnp.asarray(pts[:3]), jnp.asarray(labels[:3])),
             (jnp.asarray(pts[3:]), jnp.asarray(labels[3:]))])
    got = tbench.AttackBenchmark("deepfool", lambda p: _torch_model, **kwargs).run(
        [(torch.from_numpy(pts[:3]), torch.from_numpy(labels[:3])),
         (torch.from_numpy(pts[3:]), torch.from_numpy(labels[3:]))])
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-10)


def test_attack_benchmark_seeds_the_targeted_decision_goal():
    """Goal 't': the seed comes from the second batch (the first holds no
    example predicted as the target) and reaches the first batch too. The
    seed lends its xyz only, so the shapes share their other channels
    here: the seed is then adversarial for every shape."""
    pts, _ = _inputs(B=6)
    pts[..., 3:] = pts[:1, :, 3:]
    preds = np.argmax(np.asarray(_torch_model(torch.from_numpy(pts)))[:, 0], -1)
    labels = preds[:, None]
    target = int(preds[4])
    order = np.argsort(preds == target, kind="stable")  # hits last
    pts, labels = pts[order], labels[order]
    bench = tbench.AttackBenchmark("boundary", lambda p: _torch_model, goal="t", target=target,
                                   iters=5, init_tries=2)
    seen = []
    real = tbench.run_registered_attack

    def spy(*a, start=None, **kw):
        seen.append(start)
        return real(*a, start=start, **kw)

    batches = [(torch.from_numpy(pts[:3]), torch.from_numpy(labels[:3])),
               (torch.from_numpy(pts[3:]), torch.from_numpy(labels[3:]))]
    import unittest.mock as mock

    with mock.patch.object(tbench, "run_registered_attack", spy):
        acc, acc_adv, total, succ, dist = bench.run(batches,
                                                    generator=torch.Generator().manual_seed(0))
    assert all(s is not None for s in seen)
    first_hit = int(np.argmax(labels[:, 0] == target))
    torch.testing.assert_close(seen[0][0], torch.from_numpy(pts[first_hit]))
    assert total.sum() == (labels[:, 0] != target).sum()
    assert succ[total].all()  # a seeded start is adversarial from the first query
