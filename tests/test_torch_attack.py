"""Parity of the port's PGD attack engine with the JAX package, on the CPU.

The trained PointNet++ fixture (weights carried across from the committed
flax msgpack) must reproduce the committed NB / tar_NB metrics within
tests/test_trained_regression.py's tolerances; the engine itself is held
against the JAX engine on a small differentiable model.
"""

import dataclasses
import json
import os
import tempfile

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu import attacks as jattacks
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks, make_synthetic_rooms
from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, build_geometry
from pointsecguard_tpu_torch.utils.convert import from_jax_variables

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend. This module holds the
    suite's longest CPU work (64 full-width forward + backward passes of
    the trained fixture, memory-bound elementwise ops), so it takes four
    threads where the other port modules take two (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trained_metrics():
    """tools/make_trained_fixture.fixture_metrics, run through the port:
    8 blocks of 128 points of the synthetic Area-5 room, NB preset and
    tar_NB (floor → table) at 50 iterations."""
    with open(os.path.join(FIXDIR, "trained_pointnet2.msgpack"), "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    flat = {k: np.asarray(v) for k, v in flatten_dict(raw, sep="/").items()}
    model = PointNet2SemSegSSG()
    model.load_state_dict(from_jax_variables(flat))
    model.eval().requires_grad_(False)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_rooms(tmp, points_per_room=6000, seed=0)
        rooms = RoomSet.load(tmp, "test", 5)
    feats, labs, _, _ = WholeSceneBlocks(rooms, block_points=128).room_blocks(
        0, np.random.default_rng(0))
    feats = torch.from_numpy(feats[:8])
    labs = torch.from_numpy(labs[:8]).long()
    geo = build_geometry(feats[..., :3])

    def outputs_fn(p):
        return model(p, geometry=geo)[0]

    with torch.no_grad():
        clean = (outputs_fn(feats).argmax(-1) == labs).float().mean().item()
    nb = tattacks.pgd_color_attack(
        outputs_fn, feats, labs, tattacks.attack_preset("pointnet2", "nb"))
    ys, mask = tattacks.make_target_labels(labs, 1, 7)
    tnb = tattacks.pgd_color_attack(
        outputs_fn, feats, ys,
        tattacks.attack_preset("pointnet2", "tar_nb", target=7, iters=50),
        mask=mask)
    return {
        "clean_acc": clean,
        "nb_adv_acc": nb.acc.item(),
        "nb_l2_mean": nb.l2_dist.mean().item(),
        "tar_nb_success_rate": tnb.success_rate.item(),
    }


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIXDIR, "trained_pointnet2.json")) as f:
        return json.load(f)["expected"]


# tolerances of tests/test_trained_regression.py::test_metrics_match_committed
def test_trained_clean_acc(trained_metrics, expected):
    assert abs(trained_metrics["clean_acc"] - expected["clean_acc"]) < 0.02


def test_trained_nb_adv_acc(trained_metrics, expected):
    assert abs(trained_metrics["nb_adv_acc"] - expected["nb_adv_acc"]) < 0.03


def test_trained_nb_l2_mean(trained_metrics, expected):
    assert (abs(trained_metrics["nb_l2_mean"] - expected["nb_l2_mean"])
            < 0.05 * max(expected["nb_l2_mean"], 1e-6))


def test_trained_tar_nb_success_rate(trained_metrics, expected):
    assert (abs(trained_metrics["tar_nb_success_rate"]
                - expected["tar_nb_success_rate"]) < 0.05)


# --- the engine against the JAX engine on a small differentiable model ---

_RNG = np.random.default_rng(0)
_W1 = _RNG.standard_normal((9, 16)).astype(np.float32)
_W2 = _RNG.standard_normal((16, 13)).astype(np.float32)


def _jax_model(p):
    return jnp.tanh(p @ _W1) @ _W2


def _torch_model(p):
    return torch.tanh(p @ torch.from_numpy(_W1)) @ torch.from_numpy(_W2)


def _inputs(B=3, N=64):
    rng = np.random.default_rng(1)
    pts = rng.random((B, N, 9)).astype(np.float32)
    labels = rng.integers(0, 13, (B, N)).astype(np.int32)
    labels[:, : N // 4] = 11  # origin points for the targeted cases
    labels[2] = np.where(labels[2] == 11, 0, labels[2])  # a cloud with none
    return pts, labels


_CASES = {
    "nb": ("pointnet2", "nb", {}),
    "tar_nb": ("pointnet2", "tar_nb", {"target": 7, "iters": 12}),
    "resgcn_nb": ("resgcn", "nb", {"iters": 8}),
    # ares TBIM without its random start (the generators differ): hinge
    # loss, L2 steps, per-sample early exit
    "randla_tar_nb": ("randla", "tar_nb", {"target": 7, "rand_init_eps": 0.0,
                                           "early_exit_sr": 0.2, "eps": 3.0,
                                           "alpha": 0.5}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_pgd_engine_matches_jax(case):
    family, attack, overrides = _CASES[case]
    pts, labels = _inputs()
    jcfg = jattacks.attack_preset(family, attack, **overrides)
    tcfg = tattacks.attack_preset(family, attack, **overrides)
    mask = None
    if jcfg.targeted:
        _, mask = jattacks.make_target_labels(jnp.asarray(labels), 11, 7)
        mask = np.array(mask)
    want = jax.jit(lambda p, y, m: jattacks.pgd_color_attack(
        _jax_model, p, y, jcfg, mask=m))(pts, labels, mask)
    got = tattacks.pgd_color_attack(
        _torch_model, torch.from_numpy(pts), torch.from_numpy(labels).long(),
        tcfg, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.points_adv.numpy(), np.asarray(want.points_adv),
                               atol=1e-5)
    np.testing.assert_array_equal(got.steps_b.numpy(), np.asarray(want.steps_b))
    assert int(got.steps) == int(want.steps)
    np.testing.assert_allclose(got.l2_dist.numpy(), np.asarray(want.l2_dist),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.adv_pred.numpy(), np.asarray(want.adv_pred))
    assert got.acc.item() == pytest.approx(float(want.acc), abs=1e-6)
    assert got.success_rate.item() == pytest.approx(float(want.success_rate), abs=1e-6)


def test_batched_attack_equals_single_samples():
    pts, labels = _inputs()
    cfg = tattacks.attack_preset("randla", "tar_nb", target=7, rand_init_eps=0.0,
                                 early_exit_sr=0.2, eps=3.0, alpha=0.5)
    p, y = torch.from_numpy(pts), torch.from_numpy(labels).long()
    _, mask = tattacks.make_target_labels(y, 11, 7)
    batched = tattacks.pgd_color_attack(_torch_model, p, y, cfg, mask=mask)
    for b in range(p.shape[0]):
        one = tattacks.pgd_color_attack(_torch_model, p[b : b + 1], y[b : b + 1],
                                        cfg, mask=mask[b : b + 1])
        torch.testing.assert_close(one.points_adv[0], batched.points_adv[b])
        assert int(one.steps_b[0]) == int(batched.steps_b[b])
    # the clouds exit at different steps (7, 20) and the origin-free one at 0
    assert batched.steps_b.tolist() == [7, 20, 0]


def test_pgd_presets_match_jax():
    for family in ("pointnet2", "randla", "resgcn"):
        for attack in ("nb", "tar_nb"):
            want = dataclasses.asdict(jattacks.attack_preset(family, attack))
            got = dataclasses.asdict(tattacks.attack_preset(family, attack))
            assert got == {k: want[k] for k in got}, (family, attack)
            # the one JAX field the port leaves out (MIM) is off in every preset
            assert set(want) - set(got) == {"momentum"} and want["momentum"] == 0.0


def test_ce_and_target_labels_match_jax():
    rng = np.random.default_rng(2)
    out = rng.standard_normal((2, 20, 13)).astype(np.float32)
    labels = rng.integers(0, 13, (2, 20)).astype(np.int32)
    from pointsecguard_tpu.attacks.common import per_point_ce

    np.testing.assert_allclose(
        tattacks.per_point_ce(torch.from_numpy(out), torch.from_numpy(labels)).numpy(),
        np.asarray(per_point_ce(out, labels)), rtol=1e-6)
    jy, jm = jattacks.make_target_labels(jnp.asarray(labels), 3, 5)
    ty, tm = tattacks.make_target_labels(torch.from_numpy(labels), 3, 5)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
