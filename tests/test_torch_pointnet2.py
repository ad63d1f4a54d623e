"""Parity of the port's PointNet++ SSG with the JAX package, on the CPU.

Weights cross from flax variables through ``utils/convert.py``; the
geometry plans must be equal, and log-probabilities match the committed
``model_logits.npz`` fixture to 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxSSG
from pointsecguard_tpu.models import build_geometry as jax_build_geometry
from pointsecguard_tpu.models.common import BatchNorm as JaxBatchNorm
from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, build_geometry
from pointsecguard_tpu_torch.models.common import BatchNorm
from pointsecguard_tpu_torch.utils.convert import (
    from_jax_variables,
    to_jax_variables,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "model_logits.npz")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fix():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def jax_flat(fix):
    """Flat flax variables of PointNet2SemSegSSG at PRNGKey(7), as in
    tests/test_fixtures.py."""
    v = jax.jit(JaxSSG().init)(jax.random.PRNGKey(7), jnp.asarray(fix["points"]))
    return {k: np.asarray(x) for k, x in flatten_dict(v, sep="/").items()}


def test_fixture_logits_match(fix, jax_flat):
    model = PointNet2SemSegSSG()
    model.load_state_dict(from_jax_variables(jax_flat))
    model.eval()
    with torch.no_grad():
        logp, l4 = model(torch.from_numpy(fix["points"]))
    assert l4.shape == (1, 16, 512)
    np.testing.assert_allclose(logp.numpy(), fix["pointnet2_logp"], atol=1e-4)


def test_convert_round_trip_is_lossless(jax_flat):
    assert len(jax_flat) == 134
    back = to_jax_variables(from_jax_variables(jax_flat))
    assert set(back) == set(jax_flat)
    for k, v in jax_flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_convert_rejects_missing_and_unknown_leaves(jax_flat):
    missing = dict(jax_flat)
    missing.pop("batch_stats/SetAbstraction_2/PointMLP_0/PointConv_1/BatchNorm_0/var")
    with pytest.raises(ValueError, match="missing"):
        from_jax_variables(missing)
    extra = dict(jax_flat)
    extra["params/SetAbstraction_0/PointMLP_0/PointConv_3/Dense_0/bias"] = np.zeros(4)
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax_variables(extra)
    with pytest.raises(KeyError):
        from_jax_variables({"params/Conv_0/kernel": np.zeros((2, 2))})


def test_full_width_state_size():
    sd = PointNet2SemSegSSG().state_dict()
    # parameters plus BatchNorm running statistics of pointnet2_sem_seg.py
    assert sum(t.numel() for t in sd.values()) == 975_949


@pytest.mark.parametrize("kind", ["fixture", "block"])
def test_build_geometry_matches_jax(fix, kind):
    if kind == "fixture":  # 64 points against 1024 centres: FPS wraps
        xyz = fix["points"][..., :3]
    else:  # a padded block: exact duplicate points
        xyz = np.random.default_rng(3).random((2, 300, 3)).astype(np.float32)
        xyz[:, 200:] = xyz[:, :100]
    want = jax.jit(jax_build_geometry)(jnp.asarray(xyz))
    got = build_geometry(torch.from_numpy(np.ascontiguousarray(xyz)))
    for li in range(4):
        for j in range(2):  # SA: centres, groups
            np.testing.assert_array_equal(
                got["sa"][li][j].numpy(), np.asarray(want["sa"][li][j]))
        np.testing.assert_array_equal(  # FP: 3-NN indices
            got["fp"][li][0].numpy(), np.asarray(want["fp"][li][0]))
        np.testing.assert_allclose(
            got["fp"][li][1].numpy(), np.asarray(want["fp"][li][1]), rtol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_matches_jax(train):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    mean, var = rng.random(6).astype(np.float32), 1 + rng.random(6).astype(np.float32)
    scale, bias = rng.random(6).astype(np.float32), rng.random(6).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    y_j, upd = JaxBatchNorm().apply(variables, x, use_running_average=not train,
                                    momentum=0.8, mutable=["batch_stats"])
    bn = BatchNorm(6)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        (("scale", scale), ("bias", bias), ("mean", mean), ("var", var))})
    bn.train(train)
    y_t = bn(torch.from_numpy(x), momentum=0.8)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    stats = upd["batch_stats"] if train else variables["batch_stats"]
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats["var"]), rtol=1e-6)


def test_group_max_splits_gradient_over_ties_like_jax():
    # the groups hold exact duplicates (repeat-first fill, FPS wrap)
    x = np.array([[[0.0, 1.0, 1.0], [0.5, 0.5, 0.2], [2.0, -1.0, 2.0]]], np.float32)
    g_jax = np.asarray(jax.grad(lambda v: jnp.sum(jnp.max(v, axis=2)))(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (g_t,) = torch.autograd.grad(torch.amax(xt, dim=2).sum(), xt)
    np.testing.assert_array_equal(g_t.numpy(), g_jax)
    np.testing.assert_array_equal(g_t.numpy()[0, 0], [0.0, 0.5, 0.5])


def test_input_gradient_matches_jax(fix, jax_flat):
    """The colour gradient the attack steps on, through the whole net."""
    pts = fix["points"]
    labels = np.random.default_rng(0).integers(0, 13, pts.shape[:2])
    from pointsecguard_tpu.attacks.common import per_point_ce as jax_ce
    from pointsecguard_tpu_torch.attacks.common import per_point_ce

    model = JaxSSG()
    variables = unflatten_dict(jax_flat, sep="/")

    def jax_loss(color):
        p = jnp.asarray(pts).at[..., 3:6].set(color)
        geo = jax_build_geometry(p[..., :3])
        out = model.apply(variables, p, geometry=geo)[0]
        return jnp.sum(jax_ce(out, jnp.asarray(labels))) / pts.shape[1]

    g_jax = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(pts[..., 3:6])))

    port = PointNet2SemSegSSG()
    port.load_state_dict(from_jax_variables(jax_flat))
    port.eval().requires_grad_(False)
    p = torch.from_numpy(pts)
    geo = build_geometry(p[..., :3])
    color = p[..., 3:6].clone().requires_grad_(True)
    out = port(torch.cat([p[..., :3], color, p[..., 6:]], -1), geometry=geo)[0]
    loss = per_point_ce(out, torch.from_numpy(labels)).sum() / pts.shape[1]
    (g_t,) = torch.autograd.grad(loss, color)
    np.testing.assert_allclose(g_t.numpy(), g_jax, rtol=1e-3, atol=1e-7)
