"""The trajectory mode (``--log_steps``) of the port's PGD and C&W engines
against the JAX engines' ``trajectory=True``, on the CPU.

Per-step accuracy, success rate and per-cloud L2 at batch 1 on the trained
PointNet++ SSG fixture (128-point blocks) and on a small differentiable
model; the final adversary with and without the trajectory; and the one
intended difference: the JAX trajectory's accuracy and success rate are a
mean of per-cloud means over every row, a caller's padded copies
included, where the port pools the points of the real rows."""

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
from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxSSG
from pointsecguard_tpu.models import build_geometry as jax_build_geometry
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks, make_synthetic_rooms
from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, build_geometry
from pointsecguard_tpu_torch.utils.convert import from_jax_variables

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _palette():
    """Colours in (0, 1) whose tanh round trips (the "torch" flavour's
    0.5 + 0.5·tanh(atanh(2c − 1)) and the ares one with the 1 − 1e-6 bound)
    round alike in both packages: at C&W's step 0 the smooth term's self
    pair and the ares L2 direction are made of that rounding alone, and Adam
    turns a rounding-level difference into a full lr step
    (tests/test_torch_cw.py)."""
    bound = 1.0 - 1e-6
    grid = (np.arange(1, 256) / 256).astype(np.float32)

    def trips(lib, c):
        x = lib.clip((c - 0.5) / 0.5, -bound, bound)
        return [0.5 + 0.5 * lib.tanh(0.5 * lib.log((1 + y) / (1 - y))) for y in (x, x * bound)]

    j = [np.asarray(a) for a in jax.jit(lambda c: trips(jnp, c))(grid)]
    t = [a.numpy() for a in trips(torch, torch.from_numpy(grid))]
    ok = (j[0] == grid) & (t[0] == grid) & (j[1] == t[1])
    assert ok.sum() > 100
    return grid[ok]


def _on_palette(colors, palette):
    """Each colour moved to its nearest palette entry."""
    return palette[np.abs(colors[..., None] - palette).argmin(-1)]


def _check_traj(got, want, steps, l2_rtol=1e-5):
    """acc and sr within 1e-5 (they count the same predictions); l2 within
    1e-5 plus ``l2_rtol`` of itself (float32 norms of reassociated sums)."""
    for key in ("acc", "sr", "l2"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.shape[0] == steps, key
        np.testing.assert_allclose(g, w, rtol=l2_rtol if key == "l2" else 0, atol=1e-5,
                                   err_msg=key)


# --- the trained PointNet++ SSG fixture at batch 1 -----------------------------

@pytest.fixture(scope="module")
def ssg():
    """Both packages' SSG on the trained fixture's weights, and two
    128-point blocks of the synthetic Area-5 room (as tests/test_torch_
    attack.py takes them)."""
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
    return {"jax": (JaxSSG(), raw), "port": model, "pts": feats[:2], "labels": labs[:2]}


_SSG_CASES = {
    "nb": ("nb", {}),
    "tar_nb": ("tar_nb", {"target": 7, "iters": 10}),
    "nu": ("nu", {"steps": 8}),
    "tar_nu": ("tar_nu", {"target": 7, "steps": 8}),
}


@pytest.mark.parametrize("case", sorted(_SSG_CASES))
def test_ssg_trajectory_matches_jax_at_batch_one(ssg, case):
    attack, overrides = _SSG_CASES[case]
    jmodel, variables = ssg["jax"]
    pts, labels = ssg["pts"][1:2].copy(), ssg["labels"][1:2].astype(np.int32)
    if attack.endswith("nu"):
        pts[..., 3:6] = _on_palette(pts[..., 3:6], _palette())
    jcfg = jattacks.attack_preset("pointnet2", attack, **overrides)
    tcfg = tattacks.attack_preset("pointnet2", attack, **overrides)
    mask = labels == 1 if jcfg.targeted else None  # floor → table
    if mask is not None:
        assert 0 < mask.sum() < mask.size
    jengine = (jattacks.pgd_color_attack if attack.endswith("nb")
               else jattacks.cw_color_attack)
    tengine = (tattacks.pgd_color_attack if attack.endswith("nb")
               else tattacks.cw_color_attack)

    def jrun(p, y, m):
        geo = jax_build_geometry(p[..., :3])
        return jengine(lambda q: jmodel.apply(variables, q, geometry=geo)[0], p, y, jcfg,
                       mask=m, trajectory=True)

    jres, jtraj = jax.jit(jrun)(jnp.asarray(pts), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    x = torch.from_numpy(pts)
    geo = build_geometry(x[..., :3])
    res, traj = tengine(lambda q: ssg["port"](q, geometry=geo)[0], x,
                        torch.from_numpy(labels).long(), tcfg,
                        mask=None if mask is None else torch.from_numpy(mask),
                        trajectory=True)
    pgd = attack.endswith("nb")
    # C&W: the net's input gradient matches JAX's to rtol 1e-3
    # (tests/test_torch_pointnet2.py), and Adam's per-coordinate
    # normalisation carries that into every step; sign steps do not
    _check_traj(traj, jtraj, jcfg.iters if pgd else jcfg.steps,
                l2_rtol=1e-5 if pgd else 1e-3)
    assert int(res.steps) == int(jres.steps) == (jcfg.iters if pgd else jcfg.steps)
    if pgd:  # C&W's colours drift apart where a gradient coordinate is ~0
        np.testing.assert_allclose(res.points_adv.numpy(), np.asarray(jres.points_adv),
                                   rtol=0, atol=1e-5)


def test_trajectory_leaves_a_fixed_length_attack_unchanged(ssg):
    """NB has no early exit, so the adversary with the trajectory equals the
    one without, and its last L2 is the result's."""
    x = torch.from_numpy(ssg["pts"])
    y = torch.from_numpy(ssg["labels"]).long()
    geo = build_geometry(x[..., :3])
    fn = lambda q: ssg["port"](q, geometry=geo)[0]
    cfg = tattacks.attack_preset("pointnet2", "nb")
    plain = tattacks.pgd_color_attack(fn, x, y, cfg)
    res, traj = tattacks.pgd_color_attack(fn, x, y, cfg, trajectory=True)
    assert torch.equal(res.points_adv, plain.points_adv)
    assert torch.equal(res.adv_pred, plain.adv_pred)
    torch.testing.assert_close(traj["l2"][-1], plain.l2_dist)


# --- the engines on a small differentiable model ------------------------------

_RNG = np.random.default_rng(0)
_W1 = _RNG.standard_normal((9, 16)).astype(np.float32)
_W2 = _RNG.standard_normal((16, 13)).astype(np.float32)


def _jax_model(p):
    return jnp.tanh(p @ _W1) @ _W2


def _torch_model(p):
    return torch.tanh(p @ torch.from_numpy(_W1)) @ torch.from_numpy(_W2)


def _inputs(B=3, N=64, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.random((B, N, 9)).astype(np.float32)
    pts[..., 3:6] = _on_palette(pts[..., 3:6], _palette())
    labels = np.asarray(jnp.argmax(_jax_model(pts), -1)).astype(np.int32)
    labels[:, : N // 4] = 11
    return pts, labels


_SMALL_CASES = {
    # ares TBIM without its random start: the trajectory turns its early
    # exit at success rate 0.2 off
    "randla_tar_nb": ("randla", "tar_nb", {"target": 7, "rand_init_eps": 0.0,
                                           "early_exit_sr": 0.2, "eps": 3.0, "alpha": 0.5}),
    "resgcn_nb": ("resgcn", "nb", {"iters": 8}),
    "randla_nu": ("randla", "nu", {"steps": 12, "lr": 0.05, "success_acc": 0.5}),
    "pointnet2_tar_nu": ("pointnet2", "tar_nu", {"target": 7, "steps": 12, "lr": 0.05,
                                                 "lr_halve_every": 5, "success_sr": 0.5}),
}


@pytest.mark.parametrize("case", sorted(_SMALL_CASES))
def test_engine_trajectory_matches_jax_at_batch_one(case):
    family, attack, overrides = _SMALL_CASES[case]
    pts, labels = (a[:1] for a in _inputs())
    jcfg = jattacks.attack_preset(family, attack, **overrides)
    tcfg = tattacks.attack_preset(family, attack, **overrides)
    mask = labels == 11 if jcfg.targeted else None
    pgd = attack.endswith("nb")
    jengine = jattacks.pgd_color_attack if pgd else jattacks.cw_color_attack
    tengine = tattacks.pgd_color_attack if pgd else tattacks.cw_color_attack
    jres, jtraj = jax.jit(lambda p, y, m: jengine(_jax_model, p, y, jcfg, mask=m,
                                                  trajectory=True))(
        jnp.asarray(pts), jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    res, traj = tengine(_torch_model, torch.from_numpy(pts), torch.from_numpy(labels).long(),
                        tcfg, mask=None if mask is None else torch.from_numpy(mask),
                        trajectory=True)
    steps = jcfg.iters if pgd else jcfg.steps
    _check_traj(traj, jtraj, steps)
    np.testing.assert_array_equal(res.steps_b.numpy(), np.asarray(jres.steps_b))
    np.testing.assert_allclose(res.points_adv.numpy(), np.asarray(jres.points_adv), atol=1e-5)


def test_trajectory_turns_early_exit_off():
    pts, labels = _inputs()
    cfg = tattacks.attack_preset("randla", "tar_nb", target=7, rand_init_eps=0.0,
                                 early_exit_sr=0.2, eps=3.0, alpha=0.5)
    p, y = torch.from_numpy(pts), torch.from_numpy(labels).long()
    mask = y == 11
    early = tattacks.pgd_color_attack(_torch_model, p, y, cfg, mask=mask)
    assert int(early.steps_b.min()) < cfg.iters  # the exit fires without a trajectory
    res, traj = tattacks.pgd_color_attack(_torch_model, p, y, cfg, mask=mask, trajectory=True)
    assert res.steps_b.tolist() == [cfg.iters] * 3 and traj["acc"].shape == (cfg.iters,)
    cw = tattacks.attack_preset("pointnet2", "nu", steps=15, lr=0.05, success_acc=0.9)
    assert int(tattacks.cw_color_attack(_torch_model, p, y, cw).steps) < 15
    res, traj = tattacks.cw_color_attack(_torch_model, p, y, cw, trajectory=True)
    assert int(res.steps) == 15 and traj["l2"].shape == (15, 3)


def test_pooled_trajectory_differs_from_the_jax_mean_of_means():
    """A targeted batch with unequal origin masks and a padded last row (a
    copy of row 1, as the block CLI pads a room's tail): JAX averages
    per-cloud success rates over all three rows; the port pools the origin
    points of the two real rows, which equals the count over per-cloud
    runs at batch 1 (ROADMAP Queue 3)."""
    pts, labels = _inputs(B=2, N=64, seed=3)
    labels[1, : 64 // 4 + 24] = 11  # row 1: 40 origin points, row 0: 16
    pts = np.concatenate([pts, pts[1:]])
    labels = np.concatenate([labels, labels[1:]])
    cfg_kw = dict(target=7, iters=6)
    jcfg = jattacks.attack_preset("pointnet2", "tar_nb", **cfg_kw)
    tcfg = tattacks.attack_preset("pointnet2", "tar_nb", **cfg_kw)
    mask = labels == 11
    _, jtraj = jax.jit(lambda p, y, m: jattacks.pgd_color_attack(
        _jax_model, p, y, jcfg, mask=m, trajectory=True))(
        jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(mask))
    p, y, m = torch.from_numpy(pts), torch.from_numpy(labels).long(), torch.from_numpy(mask)
    _, traj = tattacks.pgd_color_attack(_torch_model, p, y, tcfg, mask=m, trajectory=True,
                                        valid_rows=2)
    # the pooled count from each real row alone
    hits, origin, correct = np.zeros(6), 0, np.zeros(6)
    for b in range(2):
        _, one = tattacks.pgd_color_attack(_torch_model, p[b : b + 1], y[b : b + 1], tcfg,
                                           mask=m[b : b + 1], trajectory=True)
        n = int(mask[b].sum())
        hits += one["sr"].numpy() * n
        correct += one["acc"].numpy() * 64
        origin += n
    np.testing.assert_allclose(traj["sr"].numpy(), hits / origin, atol=1e-6)
    np.testing.assert_allclose(traj["acc"].numpy(), correct / 128, atol=1e-6)
    # JAX's mean of means over the three rows, the padded one included
    per_row = []
    for b in range(3):
        _, one = tattacks.pgd_color_attack(_torch_model, p[b : b + 1], y[b : b + 1], tcfg,
                                           mask=m[b : b + 1], trajectory=True)
        per_row.append(one["sr"].numpy())
    np.testing.assert_allclose(np.asarray(jtraj["sr"]), np.mean(per_row, axis=0), atol=1e-5)
    assert np.abs(np.asarray(jtraj["sr"]) - traj["sr"].numpy()).max() > 1e-3
    # without the valid-row count the port pools every row, padding included
    _, all_rows = tattacks.pgd_color_attack(_torch_model, p, y, tcfg, mask=m, trajectory=True)
    assert not torch.allclose(all_rows["sr"], traj["sr"])
