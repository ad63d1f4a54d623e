"""The port's score-based attacks (NES, SPSA, NAttack) and MIM against the
JAX package, on the CPU.

``jax.random``'s bits cannot be drawn by torch, so each test regenerates
JAX's draws from the same ``PRNGKey`` and the same ``split`` sequence as
``_score_attack`` (`blackbox.py:151,169`) and ``nattack`` (`:327,332`) and
feeds them to the port through ``noise=``. NES steps on the sign of an
estimated gradient, a sum of draws weighted by differences of two nearby
losses, whose rounding differs between XLA and torch: the parity runs in
float64 on both sides (``jax.enable_x64``), where no element is exempted.
SPSA (Adam) and NAttack then agree to 1e-10; the sign steps of NES and MIM
exactly. MIM is also held in float32 on the small model and on the
trained PointNet++ SSG fixture, as PGD's parity tests hold NB."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu import attacks as jattacks
from pointsecguard_tpu.attacks import blackbox as jblackbox
from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxSSG
from pointsecguard_tpu.models import build_geometry as jax_build_geometry
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch.attacks import blackbox as tblackbox
from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks, make_synthetic_rooms
from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, build_geometry
from pointsecguard_tpu_torch.utils.convert import from_jax_variables

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")

_RNG = np.random.default_rng(0)
_W1 = _RNG.standard_normal((9, 16))
_W2 = _RNG.standard_normal((16, 13))


def _jax_model(p):
    return jnp.tanh(p @ _W1.astype(p.dtype)) @ _W2.astype(p.dtype)


def _torch_model(p):
    return torch.tanh(p @ torch.from_numpy(_W1).to(p.dtype)) @ torch.from_numpy(_W2).to(p.dtype)


def _inputs(dtype, B=3, N=64, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.random((B, N, 9)).astype(dtype)
    labels = np.argmax(np.tanh(pts @ _W1) @ _W2, -1).astype(np.int32)
    labels[:, : N // 4] = 11  # the origin points of the targeted cases
    return pts, labels


def _regenerate(key, cfg, shape, kind):
    """JAX's draws of every query pair (population member): per iteration
    ``key, k = split(key)``, ``keys = split(k, samples)``, one draw a key."""
    draws = []
    for _ in range(cfg.iters):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, cfg.samples)
        if kind == "rademacher":
            draws.append([np.asarray(jax.random.rademacher(s, shape, dtype=jnp.float32))
                          for s in keys])
        else:
            draws.append([np.asarray(jax.random.normal(s, shape)) for s in keys])
    return draws


_CASES = {
    "nes": ("nes", {}),
    "nes_targeted_mask": ("nes", {"targeted": True, "target": 7, "eps": 0.6}),
    "nes_hinge_no_clip": ("nes", {"loss": "hinge", "clip": None}),
    "spsa": ("spsa", {}),
    "spsa_targeted_mask": ("spsa", {"targeted": True, "target": 7}),
    "nattack": ("nattack", {}),
    "nattack_targeted_mask": ("nattack", {"targeted": True, "target": 7}),
    "nattack_no_clip": ("nattack", {"clip": None}),
}
_ENGINES = {
    "nes": (jblackbox.NESConfig, jblackbox.nes_attack, tblackbox.nes_attack, "normal",
            {"eps": 0.2, "alpha": 0.05, "iters": 4, "samples": 4, "sigma": 0.01}),
    "spsa": (jblackbox.SPSAConfig, jblackbox.spsa_attack, tblackbox.spsa_attack, "rademacher",
             {"eps": 0.2, "alpha": 0.05, "iters": 4, "samples": 4, "delta": 0.01}),
    "nattack": (jblackbox.NAttackConfig, jblackbox.nattack, tblackbox.nattack, "normal",
                {"eps": 0.2, "alpha": 0.05, "iters": 4, "samples": 4, "sigma": 0.1}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_score_attacks_match_jax_on_its_draws(case):
    """float64 on both sides: adversarial colours within 1e-10, the same
    predictions, accuracy and success rate; no element exempted."""
    name, overrides = _CASES[case]
    cfg_cls, jengine, tengine, kind, base = _ENGINES[name]
    cfg = cfg_cls(**{**base, **overrides})
    pts, labels = _inputs(np.float64)
    mask = labels == 11 if cfg.targeted else None
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        jres = jax.jit(lambda p, y, m, k: jengine(_jax_model, p, y, cfg, mask=m, key=k))(
            jnp.asarray(pts), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), key)
        draws = _regenerate(key, cfg, pts.shape[:-1] + (3,), kind)
        jres = jax.tree_util.tree_map(np.asarray, jres)
    res = tengine(_torch_model, torch.from_numpy(pts), torch.from_numpy(labels).long(), cfg,
                  mask=None if mask is None else torch.from_numpy(mask),
                  noise=lambda it, s: torch.tensor(draws[it][s]))
    assert res.points_adv.dtype == torch.float64
    np.testing.assert_allclose(res.points_adv.numpy(), jres.points_adv, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(res.adv_pred.numpy(), jres.adv_pred)
    # the same predictions; the float32 means of both packages round apart
    assert float(res.acc) == pytest.approx(float(jres.acc), abs=1e-6)
    assert float(res.success_rate) == pytest.approx(float(jres.success_rate), abs=1e-6)
    np.testing.assert_allclose(res.l2_dist.numpy(), jres.l2_dist, rtol=1e-9)
    assert int(res.steps) == int(jres.steps) == cfg.iters
    moved = np.abs(res.points_adv.numpy() - pts).max()
    assert moved > 0
    if mask is not None:  # the masked points alone move
        np.testing.assert_array_equal(res.points_adv.numpy()[~mask], pts[~mask])


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_no_query_differentiates_the_model(name):
    """A closure that raises under grad mode: every query (and the final
    forward) runs under ``torch.no_grad()``. With the generator the attack
    still moves the colours, inside the ε-ball and the clip box, xyz
    untouched, and a second run from the same seed repeats the first."""
    cfg_cls, _, tengine, _, base = _ENGINES[name]
    cfg = cfg_cls(**base)
    pts, labels = (torch.from_numpy(a) for a in _inputs(np.float32))

    def opaque(p):
        if torch.is_grad_enabled():
            raise AssertionError("a query ran with grad mode on")
        return _torch_model(p)

    runs = [tengine(opaque, pts, labels.long(), cfg,
                    generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0].points_adv, runs[1].points_adv)
    delta = runs[0].points_adv[..., 3:6] - pts[..., 3:6]
    assert 0 < float(delta.abs().max()) <= cfg.eps + 1e-6
    assert float(runs[0].points_adv[..., 3:6].min()) >= 0.0
    assert float(runs[0].points_adv[..., 3:6].max()) <= 1.0
    assert torch.equal(runs[0].points_adv[..., :3], pts[..., :3])
    with pytest.raises(ValueError, match="generator or noise"):
        tengine(opaque, pts, labels.long(), cfg)


_MIM_CASES = {
    "linf": {"eps": 0.2, "alpha": 0.03, "iters": 8, "momentum": 1.0},
    "linf_decay": {"eps": 0.2, "alpha": 0.03, "iters": 8, "momentum": 0.5},
    "l2_hinge": {"eps": 3.0, "alpha": 0.5, "iters": 8, "momentum": 1.0, "loss": "hinge",
                 "step_norm": "l2"},
    "targeted_mask": {"eps": 0.3, "alpha": 0.05, "iters": 8, "momentum": 1.0,
                      "targeted": True, "target": 7, "ce_reduction": "mean"},
}


@pytest.mark.parametrize("case", sorted(_MIM_CASES))
def test_mim_matches_jax(case):
    """MIM's accumulator on the small model, float32 on both sides, at
    PGD's parity tolerance (tests/test_torch_trajectory.py)."""
    kw = _MIM_CASES[case]
    pts, labels = _inputs(np.float32)
    mask = labels == 11 if kw.get("targeted") else None
    jcfg, tcfg = jattacks.PGDConfig(**kw), tattacks.PGDConfig(**kw)
    jres = jax.jit(lambda p, y, m: jattacks.pgd_color_attack(_jax_model, p, y, jcfg, mask=m))(
        jnp.asarray(pts), jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    res = tattacks.pgd_color_attack(_torch_model, torch.from_numpy(pts),
                                    torch.from_numpy(labels).long(), tcfg,
                                    mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(res.points_adv.numpy(), np.asarray(jres.points_adv), atol=1e-5)
    np.testing.assert_array_equal(res.steps_b.numpy(), np.asarray(jres.steps_b))
    bim = tattacks.pgd_color_attack(_torch_model, torch.from_numpy(pts),
                                    torch.from_numpy(labels).long(),
                                    tattacks.PGDConfig(**{**kw, "momentum": 0.0}),
                                    mask=None if mask is None else torch.from_numpy(mask))
    assert not torch.equal(bim.points_adv, res.points_adv)  # the momentum is used


def test_mim_equals_bim_on_constant_gradient():
    """JAX tests/test_attacks.py:691 on its own surrogate (logits linear in
    the colour) and batch: the MIM accumulator keeps the raw gradient's
    sign, so the trajectories are identical, in both packages."""
    W = jax.random.normal(jax.random.PRNGKey(42), (3, 13))
    pts = np.random.RandomState(1).rand(2, 64, 9).astype(np.float32)
    labels = np.asarray(jnp.argmax(jnp.asarray(pts)[..., 3:6] @ W, axis=-1))
    Wt = torch.from_numpy(np.asarray(W))
    lin = lambda p: p[..., 3:6] @ Wt
    p, y = torch.from_numpy(pts), torch.from_numpy(labels).long()
    bim = tattacks.pgd_color_attack(lin, p, y, tattacks.PGDConfig(eps=0.3, alpha=0.05, iters=8))
    mim = tattacks.pgd_color_attack(lin, p, y, tattacks.PGDConfig(eps=0.3, alpha=0.05, iters=8,
                                                                  momentum=1.0))
    assert torch.equal(bim.points_adv, mim.points_adv)
    jmim = jattacks.pgd_color_attack(lambda q: q[..., 3:6] @ W, jnp.asarray(pts),
                                     jnp.asarray(labels),
                                     jattacks.PGDConfig(eps=0.3, alpha=0.05, iters=8, momentum=1.0))
    np.testing.assert_allclose(mim.points_adv.numpy(), np.asarray(jmim.points_adv), atol=1e-6)


def test_mim_on_the_trained_ssg_matches_jax():
    """MIM (the registry's decay 1.0) on the trained PointNet++ SSG fixture,
    two 128-point blocks, the geometry built once."""
    with open(os.path.join(FIXDIR, "trained_pointnet2.msgpack"), "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    model = PointNet2SemSegSSG()
    model.load_state_dict(from_jax_variables(
        {k: np.asarray(v) for k, v in flatten_dict(raw, sep="/").items()}))
    model.eval().requires_grad_(False)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_rooms(tmp, points_per_room=6000, seed=0)
        rooms = RoomSet.load(tmp, "test", 5)
    feats, labs, _, _ = WholeSceneBlocks(rooms, block_points=128).room_blocks(
        0, np.random.default_rng(0))
    pts, labels = feats[:2], labs[:2].astype(np.int32)
    cfg_kw = {"eps": 0.1, "alpha": 0.05, "iters": 10, "momentum": 1.0}
    jmodel = JaxSSG()

    def jrun(p, y):
        geo = jax_build_geometry(p[..., :3])
        return jattacks.pgd_color_attack(lambda q: jmodel.apply(raw, q, geometry=geo)[0],
                                         p, y, jattacks.PGDConfig(**cfg_kw))

    jres = jax.jit(jrun)(jnp.asarray(pts), jnp.asarray(labels))
    x = torch.from_numpy(pts)
    geo = build_geometry(x[..., :3])
    res = tattacks.pgd_color_attack(lambda q: model(q, geometry=geo)[0], x,
                                    torch.from_numpy(labels).long(),
                                    tattacks.PGDConfig(**cfg_kw))
    np.testing.assert_allclose(res.points_adv.numpy(), np.asarray(jres.points_adv), atol=1e-5)
    np.testing.assert_array_equal(res.adv_pred.numpy(), np.asarray(jres.adv_pred))
