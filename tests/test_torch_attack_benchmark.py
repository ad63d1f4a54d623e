"""The port's ares benchmark layer (``attacks/benchmark.py``) against the
JAX package's, on the CPU, on a small differentiable model: the registry's
configs, the distortion binary search's probe sequence and minimal ε, the
iteration curve, the worst case over several attacks, and
``AttackBenchmark``'s goal gates and five result arrays. The JAX harnesses
take one closure, the port's a per-batch closure factory."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.attacks import benchmark as jbench
from pointsecguard_tpu_torch.attacks import benchmark as tbench

_RNG = np.random.default_rng(0)
_W1 = _RNG.standard_normal((9, 16)).astype(np.float32)
_W2 = _RNG.standard_normal((16, 13)).astype(np.float32)


def _jax_model(p):
    return jnp.tanh(p @ _W1) @ _W2


def _torch_model(p):
    return torch.tanh(p @ torch.from_numpy(_W1).to(p.dtype)) @ torch.from_numpy(_W2).to(p.dtype)


def _make(points):  # the port's per-batch factory: this model has no plan
    return _torch_model


def _batches(n=2, B=3, N=64, seed=1):
    """Numpy batches whose clean predictions are the labels on most points
    and whose origin class 11 covers a quarter of each cloud."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts = rng.random((B, N, 9)).astype(np.float32)
        labels = np.asarray(jnp.argmax(_jax_model(pts), -1)).astype(np.int32)
        labels[:, : N // 8] = 11
        out.append((pts, labels))
    return out


def _t(batches):
    return [(torch.from_numpy(p), torch.from_numpy(y).long()) for p, y in batches]


def _j(batches):
    return [(jnp.asarray(p), jnp.asarray(y)) for p, y in batches]


_KWARGS = {"eps": 0.2, "alpha": 0.04, "iters": 6, "steps": 7, "samples": 5, "delta": 0.02,
           "sigma": 0.03, "momentum": 0.7, "overshoot": 0.5, "session": object()}


@pytest.mark.parametrize("name", sorted(tbench.ATTACKS))
def test_load_attack_gives_the_jax_fields(name):
    """The same fields as JAX's config from the same kwargs (unknown ones
    dropped, fgsm / bim / mim / pgd's own rewrites)."""
    want = dataclasses.asdict(jbench.load_attack(name, dict(_KWARGS)))
    got = dataclasses.asdict(tbench.load_attack(name, dict(_KWARGS)))
    assert got == want
    assert type(tbench.load_attack(name, {"eps": 0.1, "alpha": 0.1, "iters": 1})).__name__ \
        == jbench.ATTACKS[name].__name__


def test_registry_names_and_the_three_refused():
    """All eleven names; the three one-decision attacks, once refused, take
    their configs and refuse only the goals JAX refuses."""
    assert set(tbench.ATTACKS) == set(jbench.ATTACKS) == {
        "fgsm", "bim", "pgd", "mim", "cw", "nes", "spsa", "nattack", "deepfool", "boundary",
        "evolutionary"}
    assert dataclasses.asdict(tbench.load_attack("mim", {"eps": 0.1, "alpha": 0.02,
                                                         "iters": 5}))["momentum"] == 1.0
    for name in ("deepfool", "boundary", "evolutionary"):
        assert type(tbench.load_attack(name, {})).__name__ == jbench.ATTACKS[name].__name__
        with pytest.raises(ValueError, match="goal"):
            tbench.AttackBenchmark(name, _make, goal="tm", target=1)


def test_distortion_binsearch_probes_match_jax():
    """bim: the same probes (ε, success), accuracies and minimal ε."""
    (pts, labels), = _batches(1)
    jcfg = jbench.load_attack("bim", {"eps": 0.02, "alpha": 0.01, "iters": 5})
    tcfg = tbench.load_attack("bim", {"eps": 0.02, "alpha": 0.01, "iters": 5})
    jeps, jdet = jbench.distortion_binsearch(jax.jit(_jax_model), jnp.asarray(pts),
                                             jnp.asarray(labels), jcfg, success_acc=0.3,
                                             binsearch_steps=6)
    teps, tdet = tbench.distortion_binsearch(_make, torch.from_numpy(pts),
                                             torch.from_numpy(labels).long(), tcfg,
                                             success_acc=0.3, binsearch_steps=6)
    assert [(p["eps"], p["success"]) for p in tdet["probes"]] == \
        [(p["eps"], p["success"]) for p in jdet["probes"]]
    assert len(tdet["probes"]) > 3 and any(p["success"] for p in tdet["probes"])
    assert not all(p["success"] for p in tdet["probes"])
    np.testing.assert_allclose([p["acc"] for p in tdet["probes"]],
                               [p["acc"] for p in jdet["probes"]], atol=1e-6)
    assert teps == jeps == tdet["epsilon"]


def test_distortion_binsearch_replays_the_draws_for_every_probe():
    """pgd's random start: every probe starts from the generator's state at
    the call, so two probes at one ε agree, as JAX's probes share a key."""
    (pts, labels), = _batches(1)
    cfg = tbench.load_attack("pgd", {"eps": 0.05, "alpha": 0.01, "iters": 3})
    gen = torch.Generator().manual_seed(4)
    _, det = tbench.distortion_binsearch(_make, torch.from_numpy(pts),
                                         torch.from_numpy(labels).long(), cfg,
                                         success_acc=0.0, init_hi=0.05, search_steps=0,
                                         generator=gen)
    again = tbench.run_registered_attack(
        _torch_model, torch.from_numpy(pts), torch.from_numpy(labels).long(), cfg,
        generator=torch.Generator().manual_seed(4))
    assert det["probes"][0]["acc"] == float(again.acc)


def test_distortion_cw_reports_the_achieved_distortion():
    """C&W minimises its own distortion: one run, the per-sample L2 where it
    succeeded, the mean of those as the scalar; targeted C&W refused."""
    (pts, labels), = _batches(1)
    cfg = tbench.load_attack("cw", {"steps": 20, "lr": 0.05})
    eps, det = tbench.distortion_binsearch(_make, torch.from_numpy(pts),
                                           torch.from_numpy(labels).long(), cfg,
                                           success_acc=0.5)
    assert det["optimized"] and len(det["dist"]) == 3
    succ = np.array(det["success"])
    assert succ.any()
    assert (succ <= np.array(det["eligible"])).all()
    assert eps == pytest.approx(float(np.array(det["dist"])[succ].mean()))
    with pytest.raises(ValueError, match="targeted C&W"):
        tbench.distortion_binsearch(_make, torch.from_numpy(pts),
                                    torch.from_numpy(labels).long(),
                                    dataclasses.replace(cfg, targeted=True, target=7))


@pytest.mark.parametrize("name", ["bim", "mim"])
def test_iteration_curve_matches_jax(name):
    (pts, labels), = _batches(1)
    kw = {"eps": 0.1, "alpha": 0.02, "iters": 10}
    want = jbench.iteration_curve(jax.jit(_jax_model), jnp.asarray(pts), jnp.asarray(labels),
                                  jbench.load_attack(name, kw))
    got = tbench.iteration_curve(_make, torch.from_numpy(pts), torch.from_numpy(labels).long(),
                                 tbench.load_attack(name, kw))
    assert [r["iters"] for r in got] == [r["iters"] for r in want] == list(range(1, 11))
    for g, w in zip(got, want):
        assert g["acc"] == pytest.approx(w["acc"], abs=1e-6)
        assert g["sr"] == w["sr"] == 0.0
        assert g["l2"] == pytest.approx(w["l2"], rel=1e-5)
    assert got[-1]["l2"] > got[0]["l2"]  # the budget moves the colours further
    with pytest.raises(ValueError, match="no iteration budget"):
        tbench.iteration_curve(_make, torch.from_numpy(pts), torch.from_numpy(labels).long(),
                               tbench.load_attack("cw", {}))


def test_worst_case_union_and_min_distance_match_jax():
    batches = _batches(2)
    kw = {"eps": 0.08, "alpha": 0.02, "iters": 4}
    names = ["fgsm", "bim", "mim"]
    jrob, jper, jcomb = jbench.worst_case_run(names, jax.jit(_jax_model), _j(batches), **kw)
    trob, tper, tcomb = tbench.worst_case_run(names, _make, _t(batches), **kw)
    assert trob == pytest.approx(jrob, abs=1e-12)
    for name in names:
        for key in ("acc", "adv_acc", "succ_rate"):
            assert tper[name][key] == pytest.approx(jper[name][key], abs=1e-12), (name, key)
        assert tper[name]["dist_mean"] == pytest.approx(jper[name]["dist_mean"], rel=1e-5)
    np.testing.assert_array_equal(tcomb["total"], jcomb["total"])
    np.testing.assert_array_equal(tcomb["succ"], jcomb["succ"])
    np.testing.assert_allclose(tcomb["dist"], jcomb["dist"], rtol=1e-5)
    # the union beats every single attack, the minimum undercuts every one
    assert trob <= min(1.0 - tper[n]["succ_rate"] for n in names) + 1e-12
    assert 0.0 < trob < 1.0


@pytest.mark.parametrize("goal", ["ut", "tm", "t"])
def test_attack_benchmark_arrays_match_jax(goal):
    """bim over two batches: acc, acc_adv, total, succ equal; dist within
    float32 reassociation."""
    batches = _batches(2)
    kw = {"eps": 0.3, "alpha": 0.05, "iters": 6}
    if goal != "ut":
        kw.update(target=7, ce_reduction="mean")
    if goal == "t":
        kw["origin"] = 11
    for metric in ("l_2", "l_inf"):
        want = jbench.AttackBenchmark("bim", jax.jit(_jax_model), goal=goal,
                                      distance_metric=metric, **kw).run(_j(batches))
        got = tbench.AttackBenchmark("bim", _make, goal=goal, distance_metric=metric,
                                     **kw).run(_t(batches))
        for g, w, what in zip(got, want, ("acc", "acc_adv", "total", "succ", "dist")):
            assert g.shape == w.shape, what
            if what == "dist":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w, err_msg=what)
        assert got[3].any()  # the attack succeeds somewhere


@pytest.mark.parametrize("kwargs,match", [
    ({"goal": "xx"}, "unknown goal"),
    ({"distance_metric": "l_1"}, "unknown distance metric"),
    ({"goal": "t"}, "targeted goal needs target="),
    ({"goal": "t", "target": 7}, "targeted goal needs origin= and target="),
    ({"goal": "tm"}, "goal 'tm' needs target="),
])
def test_attack_benchmark_goal_gates_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        jbench.AttackBenchmark("bim", _jax_model, **kwargs)
    with pytest.raises(ValueError, match=match):
        tbench.AttackBenchmark("bim", _make, **kwargs)


def test_attack_benchmark_runs_nes_from_its_generator():
    """The score-based engines run through the harness; one generator
    advances over the batches, and the same seed repeats the arrays."""
    batches = _t(_batches(2))
    bench = tbench.AttackBenchmark("nes", _make, eps=0.3, alpha=0.05, iters=3, samples=4,
                                   sigma=0.05)
    runs = [bench.run(batches, generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    acc, acc_adv, total, succ, dist = runs[0]
    assert acc_adv.mean() < acc.mean() and (dist > 0).all()
    np.testing.assert_array_equal(succ, total & ~acc_adv)


def _binsearch_runs(monkeypatch, smooth, l2):
    """(JAX's, the port's) cw_coefficient_binsearch on one batch of the
    small model (targeted C&W, class 11 → 7, only class-11 points move;
    success above a rate of 0.2, which this model reaches on them), each
    with the coefficients its C&W probes ran at."""
    from pointsecguard_tpu.attacks import make_target_labels as jax_target_labels
    from pointsecguard_tpu.attacks.cw import CWConfig as JaxCW
    from pointsecguard_tpu_torch.attacks.cw import CWConfig

    pts, labels = _batches(1)[0]
    kw = dict(steps=60, lr=0.1, smooth_coeff=smooth, l2_coeff=l2, smooth_k=5, targeted=True,
              target=7)
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jbench), ("port", tbench)):
        engine = mod.cw_color_attack

        def recording(*a, _engine=engine, _seen=seen[name], **k):
            _seen.append((a[3].smooth_coeff, a[3].l2_coeff))
            return _engine(*a, **k)

        monkeypatch.setattr(mod, "cw_color_attack", recording)
    # in float64 on both sides: the probes near the threshold sit within
    # float32 rounding of the success rate's steps
    with jax.enable_x64(True):
        jlabels = jnp.asarray(labels, jnp.int64)
        _, jmask = jax_target_labels(jlabels, 11, 7)
        want = jbench.cw_coefficient_binsearch(
            _jax_model, jnp.asarray(pts, jnp.float64), jlabels, JaxCW(**kw), mask=jmask,
            success_sr=0.2)
    tl = torch.from_numpy(labels).long()
    got = tbench.cw_coefficient_binsearch(_make, torch.from_numpy(pts).double(), tl,
                                          CWConfig(**kw), mask=tl == 11, success_sr=0.2)
    return want, got, seen


def test_cw_coefficient_binsearch_matches_jax_on_equal_coefficients(monkeypatch):
    """smooth_coeff == l2_coeff: JAX's probe sequence (c, success rate,
    accuracy, mean L2), its threshold and its coefficients. The budget
    c = 10 fails, the search finds a finite c below it."""
    (cj, dj), (ct, dt), seen = _binsearch_runs(monkeypatch, 10.0, 10.0)
    assert ct == cj and 0 < ct < 10
    assert [p["c"] for p in dt["probes"]] == [p["c"] for p in dj["probes"]]
    for p, q in zip(dt["probes"], dj["probes"]):
        assert (p["sr"], p["acc"]) == (q["sr"], q["acc"])
        # rounded to 3 decimals on both sides: one unit apart at most
        assert abs(p["l2_mean"] - q["l2_mean"]) <= 1e-3 + 1e-12
    assert dt["probes"][0]["sr"] <= 0.2 and max(p["sr"] for p in dt["probes"]) > 0.2
    assert seen["port"] == seen["jax"] == [(p["c"], p["c"]) for p in dj["probes"]]


def test_cw_coefficient_binsearch_keeps_the_coefficients_ratio(monkeypatch):
    """smooth_coeff = 4 · l2_coeff: every port probe scales both by c / c0
    (their ratio stays 4), where JAX sets both to c (its ``l2_coeff`` loses
    its own value: ROADMAP Queue 3)."""
    _, (ct, dt), seen = _binsearch_runs(monkeypatch, 10.0, 2.5)
    cs = [p["c"] for p in dt["probes"]]
    assert seen["port"] == [(c, c * 0.25) for c in cs]
    assert len(seen["jax"]) > 1 and all(s == l2 for s, l2 in seen["jax"])
    assert cs[0] == 10.0 and len(cs) > 1
    with pytest.raises(ValueError, match="no coefficient to scale"):
        tbench.cw_coefficient_binsearch(_make, torch.zeros(1, 4, 9), torch.zeros(1, 4).long(),
                                        tbench.CWConfig(smooth_coeff=0.0))
