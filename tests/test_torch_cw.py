"""Parity of the port's C&W engine (NU / tar_NU) with the JAX package, on
the CPU.

The model is a small deterministic per-point network given to both
packages. Colours come from a palette whose tanh round trip rounds the
same in both packages (and is exact for the "torch" flavour's
atanh → tanh): at step 0 the smooth term's self pair and the ares L2-norm
direction are made of that rounding alone, and Adam's per-coordinate
normalisation turns a rounding-level difference there into a full lr
step. On this palette the engines agree to float reassociation, so the
colours are held at atol 1e-4 after 20–30 steps, with equal exit steps
and predictions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu import attacks as jattacks
from pointsecguard_tpu.attacks import common as jcommon
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch.attacks import common as tcommon
from pointsecguard_tpu_torch.ops import cuda as tcuda

_rng = np.random.default_rng(0)
W1 = _rng.standard_normal((9, 16)).astype(np.float32)
W2 = _rng.standard_normal((16, 13)).astype(np.float32)
BOUND = 1.0 - 1e-6


def jax_model(p):
    return jnp.tanh(p @ W1) @ W2


def torch_model(p):
    return torch.tanh(p @ torch.from_numpy(W1)) @ torch.from_numpy(W2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _round_trips(np_, lib, c):
    """Both flavours' initial colour of c: 0.5 + 0.5·tanh(atanh(x)) and
    the ares one with x scaled by the tanh bound."""
    x = lib.clip((c - 0.5) / 0.5, -BOUND, BOUND) if np_ else torch.clamp(
        (c - 0.5) / 0.5, -BOUND, BOUND)
    out = []
    for y in (x, x * BOUND):
        w = 0.5 * lib.log((1 + y) / (1 - y))
        out.append(0.5 + 0.5 * lib.tanh(w))
    return out


@pytest.fixture(scope="module")
def palette():
    grid = (np.arange(1, 256) / 256).astype(np.float32)
    j_torch, j_ares = (np.asarray(a) for a in jax.jit(
        lambda c: _round_trips(True, jnp, c))(grid))
    t_torch, t_ares = (a.numpy() for a in _round_trips(False, torch, torch.from_numpy(grid)))
    ok = (j_torch == grid) & (t_torch == grid) & (j_ares == t_ares)
    assert ok.sum() > 100
    return grid[ok]


def _clouds(palette, B=3, N=64, seed=1):
    """B clouds whose first quarter carries label 11 (the origin class of
    the targeted cases); cloud 2 has none, so a targeted mask is empty
    there."""
    r = np.random.default_rng(seed)
    pts = r.random((B, N, 9)).astype(np.float32)
    pts[..., 3:6] = r.choice(palette, size=(B, N, 3))
    labels = np.asarray(jnp.argmax(jax_model(pts), -1)).astype(np.int32)
    labels[:, : N // 4] = 11
    labels[2] = np.where(labels[2] == 11, 0, labels[2])
    return pts, labels


CASES = {
    "pointnet2-nu": ("pointnet2", "nu", dict(steps=30, lr=0.05, success_acc=0.5), False),
    "pointnet2-nu-masked": ("pointnet2", "nu", dict(steps=30, lr=0.05, success_acc=0.5), True),
    "pointnet2-tar_nu": ("pointnet2", "tar_nu",
                         dict(steps=30, lr=0.05, target=7, lr_halve_every=7,
                              success_sr=0.5), True),
    "randla-nu": ("randla", "nu", dict(steps=30, lr=0.05, success_acc=0.5), False),
    "randla-tar_nu": ("randla", "tar_nu",
                      dict(steps=20, lr=0.05, target=7, lr_halve_every=7,
                           success_sr=0.5), True),
}


def _torch_run(cfg, pts, labels, mask):
    return tattacks.cw_color_attack(
        torch_model, torch.from_numpy(pts), torch.from_numpy(labels).long(), cfg,
        mask=None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("case", list(CASES))
def test_cw_matches_jax(palette, case):
    family, attack, overrides, masked = CASES[case]
    pts, labels = _clouds(palette)
    jcfg = jattacks.attack_preset(family, attack, **overrides)
    tcfg = tattacks.attack_preset(family, attack, **overrides)
    mask = None
    if masked:  # targeted: the origin points; untargeted: the valid points
        mask = labels == 11 if jcfg.targeted else labels != 11
    want = jax.jit(lambda p, y, m: jattacks.cw_color_attack(
        jax_model, p, y, jcfg, mask=m))(pts, labels, mask)
    got = _torch_run(tcfg, pts, labels, mask)
    moved = np.abs(np.asarray(want.points_adv) - pts).max()
    assert moved > 0.1  # the attack really moved the colours
    np.testing.assert_allclose(got.points_adv.numpy(), np.asarray(want.points_adv),
                               atol=1e-4)
    np.testing.assert_array_equal(got.steps_b.numpy(), np.asarray(want.steps_b))
    assert int(got.steps) == int(want.steps)
    np.testing.assert_array_equal(got.adv_pred.numpy(), np.asarray(want.adv_pred))
    np.testing.assert_allclose(got.l2_dist.numpy(), np.asarray(want.l2_dist), atol=1e-4)
    np.testing.assert_allclose(float(got.acc), float(want.acc), atol=1e-6)
    np.testing.assert_allclose(float(got.success_rate), float(want.success_rate),
                               atol=1e-6)
    if jcfg.targeted:  # the empty-mask cloud is done from the start
        assert int(got.steps_b[2]) == 0
        np.testing.assert_array_equal(got.points_adv[2].numpy(), pts[2])


@pytest.mark.parametrize("case", ["pointnet2-nu", "randla-tar_nu"])
def test_cw_batch_equals_its_single_cloud_runs(palette, case):
    family, attack, overrides, masked = CASES[case]
    pts, labels = _clouds(palette)
    cfg = tattacks.attack_preset(family, attack, **overrides)
    mask = (labels == 11) if masked else None
    batch = _torch_run(cfg, pts, labels, mask)
    assert len(set(batch.steps_b.tolist())) > 1 or cfg.targeted
    for b in range(len(pts)):
        one = _torch_run(cfg, pts[b : b + 1], labels[b : b + 1],
                         None if mask is None else mask[b : b + 1])
        np.testing.assert_allclose(batch.points_adv[b].numpy(), one.points_adv[0].numpy(),
                                   atol=1e-6)
        assert int(batch.steps_b[b]) == int(one.steps_b[0])
        if int(one.steps) > 0:  # alone, an empty-mask cloud runs no step and
            # has no prediction (as in the JAX engine); in a batch it keeps
            # the first step's
            np.testing.assert_array_equal(batch.adv_pred[b].numpy(),
                                          one.adv_pred[0].numpy())


def test_cw_steps_is_the_iterations_executed(palette):
    pts, labels = _clouds(palette)
    cfg = tattacks.attack_preset("pointnet2", "nu", steps=30, lr=0.05, success_acc=0.5)
    res = _torch_run(cfg, pts, labels, None)
    assert int(res.steps) == int(res.steps_b.max()) < 30
    capped = _torch_run(dataclasses.replace(cfg, steps=3), pts, labels, None)
    assert int(capped.steps) == 3 and capped.steps_b.tolist() == [3, 3, 3]


@pytest.mark.parametrize("attack", ["nu", "tar_nu"])
@pytest.mark.parametrize("family", ["pointnet2", "randla", "resgcn"])
def test_presets_equal_the_jax_package(family, attack):
    got = dataclasses.asdict(tattacks.attack_preset(family, attack))
    want = dataclasses.asdict(jattacks.attack_preset(family, attack))
    assert got == want
    assert isinstance(tattacks.attack_preset(family, attack, target=7), tattacks.CWConfig)


@pytest.mark.parametrize("kind", ["clean", "moved"])
def test_color_smoothness_matches_jax_with_ties(kind):
    """Colours on a 1/8 grid with duplicated points: exact ties among the
    k nearest, which both sides break to the first occurrence. "clean"
    evaluates at the reference colours themselves (every self pair at
    distance 0), "moved" 0.05 away from them."""
    r = np.random.default_rng(4)
    ref = np.round(r.random((2, 96, 3)) * 8).astype(np.float32) / 8
    ref[:, 48:80] = ref[:, :32]
    adv = ref.copy()
    if kind == "moved":
        adv = adv + np.float32(0.05) * np.sign(r.standard_normal(adv.shape)).astype(np.float32)
    for k in (10, 5):
        want_v, want_g = jax.jit(jax.value_and_grad(
            lambda a: jnp.sum(jcommon.color_smoothness(a, ref, k) * jnp.array([1.0, 2.0]))))(adv)
        a = torch.from_numpy(adv).requires_grad_(True)
        v = tcommon.color_smoothness(a, torch.from_numpy(ref), k)
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(
            jcommon.color_smoothness(adv, ref, k)), rtol=1e-6)
        (g,) = torch.autograd.grad(torch.sum(v * torch.tensor([1.0, 2.0])), a)
        np.testing.assert_allclose(float(torch.sum(v.detach() * torch.tensor([1.0, 2.0]))),
                                   float(want_v), rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), atol=1e-5)


def test_color_smoothness_gives_ref_no_gradient_and_launches_nothing_on_cpu():
    tcuda.reset_launch_counts()
    r = np.random.default_rng(5)
    adv = torch.from_numpy(r.random((1, 32, 3)).astype(np.float32)).requires_grad_(True)
    ref = torch.from_numpy(r.random((1, 32, 3)).astype(np.float32)).requires_grad_(True)
    ga, gr = torch.autograd.grad(tcommon.color_smoothness(adv, ref, 10).sum(), (adv, ref))
    assert torch.isfinite(ga).all() and torch.count_nonzero(gr) == 0
    assert tcuda.launch_counts()["bottom_k"] == 0


@pytest.mark.parametrize("kappa", [0.0, 0.3])
def test_cw_f_terms_match_jax(kappa):
    r = np.random.default_rng(6)
    out = r.standard_normal((2, 40, 13)).astype(np.float32) * 3
    labels = r.integers(0, 13, (2, 40)).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.cw_f_prob(torch.from_numpy(out), torch.from_numpy(labels), kappa, 13).numpy(),
        np.asarray(jcommon.cw_f_prob(out, labels, kappa, 13)), atol=1e-6)
    np.testing.assert_allclose(
        tcommon.cw_f_targeted(torch.from_numpy(out), 7, kappa, 13).numpy(),
        np.asarray(jcommon.cw_f_targeted(out, 7, kappa, 13)), atol=1e-6)
