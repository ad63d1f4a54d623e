"""Parity of the port's PointNet++ MSG with the JAX package, on the CPU.

Weights cross from flax variables through ``utils/convert.py`` (the
logits fixture has no MSG entry, so the live JAX model at PRNGKey(7) is
the reference): the geometry plan equal, ``group_relative`` in MSG's
channel order equal, logits to 1e-4, the input gradient at the SSG
test's tolerances, and one train step against ``make_train_step`` at
``tests/test_torch_train.py``'s.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu.models import PointNet2SemSegMSG as JaxMSG
from pointsecguard_tpu.models import weighted_nll_loss as jax_weighted_nll_loss
from pointsecguard_tpu.models.pointnet2 import build_geometry_msg as jax_build_geometry_msg
from pointsecguard_tpu.ops.grouping import group_relative as jax_group_relative
from pointsecguard_tpu.train.trainer import TrainState as JaxTrainState
from pointsecguard_tpu.train.trainer import make_optimizer as jax_make_optimizer
from pointsecguard_tpu.train.trainer import make_train_step as jax_make_train_step
from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models import (
    PointNet2SemSegMSG,
    build_geometry,
    build_geometry_msg,
    weighted_nll_loss,
)
from pointsecguard_tpu_torch.train.trainer import POINTNET2_MSG, TrainState, make_train_step
from pointsecguard_tpu_torch.utils.convert import (
    pointnet2_msg_from_jax_variables,
    pointnet2_msg_to_jax_variables,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "model_logits.npz")
BN_MOMENTUM = 0.1
LR = 0.003


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


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def jax_flat(fix):
    """Flat flax variables of PointNet2SemSegMSG at PRNGKey(7)."""
    return _flat(jax.jit(JaxMSG().init)(jax.random.PRNGKey(7), jnp.asarray(fix["points"])))


def _port(flat):
    model = PointNet2SemSegMSG()
    model.load_state_dict(pointnet2_msg_from_jax_variables(flat))
    return model


def _block(n, seed=3):
    """[1, n, 9] points of a padded block: the last third repeats the
    first (exact duplicates, as WholeSceneBlocks pads)."""
    pts = np.random.default_rng(seed).random((1, n, 9)).astype(np.float32)
    pts[:, 2 * n // 3:] = pts[:, : n - 2 * n // 3]
    return pts


@pytest.mark.parametrize("kind", ["fixture", "block"])
def test_logits_match_jax(fix, jax_flat, kind):
    """The fixture's 64 points (FPS wraps at every level up to 16
    centres) and a 1200-point block (no wrap at level 1)."""
    pts = fix["points"] if kind == "fixture" else _block(1200)
    want = np.asarray(jax.jit(JaxMSG().apply)(unflatten_dict(jax_flat, sep="/"),
                                              jnp.asarray(pts))[0])
    model = _port(jax_flat).eval()
    with torch.no_grad():
        logp, l4 = model(torch.from_numpy(pts))
    assert l4.shape == (1, 16, 1024)
    np.testing.assert_allclose(logp.numpy(), want, atol=1e-4)


def test_convert_round_trip_is_lossless(jax_flat):
    assert len(jax_flat) == 206
    back = pointnet2_msg_to_jax_variables(pointnet2_msg_from_jax_variables(jax_flat))
    assert set(back) == set(jax_flat)
    for k, v in jax_flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_convert_rejects_missing_and_unknown_leaves(jax_flat):
    missing = dict(jax_flat)
    missing.pop("batch_stats/SetAbstractionMSG_2/PointMLP_1/PointConv_1/BatchNorm_0/var")
    with pytest.raises(ValueError, match="missing"):
        pointnet2_msg_from_jax_variables(missing)
    extra = dict(jax_flat)
    extra["params/SetAbstractionMSG_0/PointMLP_2/PointConv_0/Dense_0/bias"] = np.zeros(4)
    with pytest.raises(ValueError, match="unconsumed"):
        pointnet2_msg_from_jax_variables(extra)
    ssg_named = {k.replace("SetAbstractionMSG", "SetAbstraction"): v
                 for k, v in jax_flat.items()}
    with pytest.raises(ValueError, match="missing"):
        pointnet2_msg_from_jax_variables(ssg_named)


def test_full_width_state_size():
    sd = PointNet2SemSegMSG().state_dict()
    # parameters plus BatchNorm running statistics of pointnet2_sem_seg_msg.py
    assert sum(t.numel() for t in sd.values()) == 1_895_253
    assert len(sd) == 206


@pytest.mark.parametrize("kind", ["fixture", "block"])
def test_build_geometry_msg_matches_jax(fix, kind):
    if kind == "fixture":  # 64 points against 1024 centres: FPS wraps
        xyz = fix["points"][..., :3]
    else:  # a padded block: exact duplicate points
        xyz = np.random.default_rng(3).random((2, 300, 3)).astype(np.float32)
        xyz[:, 200:] = xyz[:, :100]
    want = jax.jit(jax_build_geometry_msg)(jnp.asarray(xyz))
    got = build_geometry_msg(torch.from_numpy(np.ascontiguousarray(xyz)))
    for li in range(4):
        np.testing.assert_array_equal(  # centres
            got["sa"][li][0].numpy(), np.asarray(want["sa"][li][0]))
        assert len(got["sa"][li][1]) == 2
        for r in range(2):  # one group index set per radius (k = 16, 32)
            np.testing.assert_array_equal(
                got["sa"][li][1][r].numpy(), np.asarray(want["sa"][li][1][r]))
        np.testing.assert_array_equal(  # FP: 3-NN indices
            got["fp"][li][0].numpy(), np.asarray(want["fp"][li][0]))
        np.testing.assert_allclose(
            got["fp"][li][1].numpy(), np.asarray(want["fp"][li][1]), rtol=1e-5)


@pytest.mark.parametrize("feats", [True, False], ids=["feats", "xyz only"])
def test_group_relative_feats_first_matches_jax(feats):
    """MSG's [feats | rel-xyz] order, npoint > N included (FPS wraps)."""
    rng = np.random.default_rng(4)
    xyz = rng.random((2, 20, 3)).astype(np.float32)
    f = rng.random((2, 20, 5)).astype(np.float32) if feats else None
    idx = rng.integers(0, 20, (2, 32, 6)).astype(np.int32)
    centers = rng.random((2, 32, 3)).astype(np.float32)
    want = np.asarray(jax_group_relative(
        jnp.asarray(xyz), None if f is None else jnp.asarray(f), jnp.asarray(idx),
        jnp.asarray(centers), feats_first=True))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = ops.group_relative(t(xyz), t(f), t(idx), t(centers), feats_first=True).numpy()
    np.testing.assert_array_equal(got, want)
    if feats:  # the same channels as SSG's order, the halves swapped
        ssg = ops.group_relative(t(xyz), t(f), t(idx), t(centers)).numpy()
        np.testing.assert_array_equal(got, np.concatenate([ssg[..., 3:], ssg[..., :3]], -1))


def test_training_geometry_draws_as_ssg_does():
    """Four starts of [B] a batch from the generator, one per level, the
    same draws as SSG's: so the centres are SSG's own, and the dropout
    mask drawn next is too."""
    xyz = torch.from_numpy(np.random.default_rng(1).random((3, 2048, 3)).astype(np.float32))
    g_msg, g_ssg = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    msg = build_geometry_msg(xyz, generator=g_msg)
    ssg = build_geometry(xyz, generator=g_ssg)
    for li in range(4):
        assert torch.equal(msg["sa"][li][0], ssg["sa"][li][0])
    assert torch.equal(torch.rand(4, generator=g_msg), torch.rand(4, generator=g_ssg))
    starts = [torch.full((3,), 7, dtype=torch.int32)] * 4
    fixed = build_geometry_msg(xyz, start_idx=starts)
    assert torch.equal(fixed["sa"][0][0][:, 0], xyz[:, 7])


def test_input_gradient_matches_jax(fix, jax_flat):
    """The colour gradient the attack steps on, through the whole net on
    the hoisted geometry (`tests/test_torch_pointnet2.py`'s tolerances)."""
    pts = fix["points"]
    labels = np.random.default_rng(0).integers(0, 13, pts.shape[:2])
    from pointsecguard_tpu.attacks.common import per_point_ce as jax_ce
    from pointsecguard_tpu_torch.attacks.common import per_point_ce

    model = JaxMSG()
    variables = unflatten_dict(jax_flat, sep="/")

    def jax_loss(color):
        p = jnp.asarray(pts).at[..., 3:6].set(color)
        geo = jax_build_geometry_msg(p[..., :3])
        out = model.apply(variables, p, geometry=geo)[0]
        return jnp.sum(jax_ce(out, jnp.asarray(labels))) / pts.shape[1]

    g_jax = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(pts[..., 3:6])))

    port = _port(jax_flat).eval().requires_grad_(False)
    p = torch.from_numpy(pts)
    geo = build_geometry_msg(p[..., :3])
    color = p[..., 3:6].clone().requires_grad_(True)
    out = port(torch.cat([p[..., :3], color, p[..., 6:]], -1), geometry=geo)[0]
    loss = per_point_ce(out, torch.from_numpy(labels)).sum() / pts.shape[1]
    (g_t,) = torch.autograd.grad(loss, color)
    assert np.abs(g_jax).max() > 0
    np.testing.assert_allclose(g_t.numpy(), g_jax, rtol=1e-3, atol=1e-7)


# --- one train step ------------------------------------------------------------
#
# As tests/test_torch_train.py holds SSG's step: the JAX step from its parts
# without a ``sample`` rng (FPS from index 0), its dropout mask read off the
# ``Dropout`` module, the port's step on the same weights, batch, starts and
# mask; gradients held three ways against a float64 evaluation. The whole
# step is JAX's ``make_train_step`` itself, on a model whose geometry is
# pinned to FPS from index 0 (the step's ``sample`` rng would draw the
# starts) and with the rng whose ``dropout`` key gave the mask.

B, P = 2, 1024


class _PinnedGeometryMSG(JaxMSG):
    """The JAX MSG model on ``build_geometry_msg`` (FPS from index 0):
    the same variables, no ``sample`` draw."""

    def __call__(self, points, *, train=False, momentum=0.9):
        return super().__call__(points, train=train, momentum=momentum,
                                geometry=jax_build_geometry_msg(points[..., :3]))


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, make_synthetic_rooms

    root = str(tmp_path_factory.mktemp("rooms"))
    make_synthetic_rooms(root, points_per_room=20000, seed=0)
    rooms = RoomSet.load(root, "train", 5)
    sampler = S3DISBlockSampler(rooms, num_point=P, min_points=P // 2)
    pts, labels = next(iter(sampler.batches(np.random.default_rng(0), B)))
    return pts, labels, rooms.label_weights.astype(np.float32)


@pytest.fixture(scope="module")
def jax_step(step_inputs):
    pts, labels, weights = step_inputs
    model = JaxMSG()
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(pts))

    def compute(params):
        (logp, _), mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(pts), train=True, momentum=1.0 - BN_MOMENTUM,
            rngs={"dropout": jax.random.PRNGKey(5)},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout),
        )
        loss = jax_weighted_nll_loss(logp, jnp.asarray(labels), jnp.asarray(weights))
        dropped = mutated["intermediates"]["Dropout_0"]["__call__"][0]
        return loss, (mutated["batch_stats"], dropped)

    (loss, (stats, dropped)), grads = jax.jit(
        jax.value_and_grad(compute, has_aux=True))(variables["params"])
    flat_vars = {**_flat({"params": variables["params"]}),
                 **_flat({"batch_stats": variables["batch_stats"]})}
    tx = jax_make_optimizer()
    state = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(_PinnedGeometryMSG(), tx, jax_weighted_nll_loss)
    # the step donates the state: the variables above are read before it
    new, step_loss, _ = step(state, jnp.asarray(pts), jnp.asarray(labels),
                             jnp.asarray(weights), LR, BN_MOMENTUM, jax.random.PRNGKey(5))
    return {"variables": flat_vars, "loss": float(loss), "grads": _flat({"params": grads}),
            "stats": _flat({"batch_stats": stats}), "mask": np.asarray(dropped) != 0,
            "step_loss": float(step_loss), "new_params": _flat({"params": new.params}),
            "new_stats": _flat({"batch_stats": new.batch_stats})}


@pytest.fixture(scope="module")
def port_step(step_inputs, jax_step):
    pts, labels, weights = step_inputs
    model = _port(jax_step["variables"])
    state = TrainState(model)
    step = make_train_step(model, weighted_nll_loss, family=POINTNET2_MSG)
    loss = step(state, torch.from_numpy(pts), torch.from_numpy(labels),
                torch.from_numpy(weights), LR, BN_MOMENTUM,
                start_idx=[torch.zeros(B, dtype=torch.int32)] * 4,
                dropout_mask=torch.from_numpy(jax_step["mask"]))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return {"loss": loss.item(), "model": model,
            "grads": pointnet2_msg_to_jax_variables(grads)}


@pytest.fixture(scope="module")
def float64_grads(step_inputs, jax_step):
    pts, labels, weights = step_inputs
    model = _port(jax_step["variables"]).double().train()
    geo = build_geometry_msg(torch.from_numpy(pts)[..., :3])
    geo = {"sa": tuple((c.double(), i) for c, i in geo["sa"]),
           "fp": tuple((i, w.double()) for i, w in geo["fp"])}
    logp, _ = model(torch.from_numpy(pts).double(), geometry=geo,
                    momentum=1.0 - BN_MOMENTUM,
                    dropout_mask=torch.from_numpy(jax_step["mask"]))
    loss = weighted_nll_loss(logp, torch.from_numpy(labels),
                             torch.from_numpy(weights).double())
    loss.backward()
    return loss.item(), pointnet2_msg_to_jax_variables(
        {k: p.grad for k, p in model.named_parameters()})


def _noise_only(path):
    """Dense biases under a BatchNorm: the true gradient is 0."""
    return path.endswith("Dense_0/bias") and "PointConv" in path


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_step_loss_matches_jax(jax_step, port_step, float64_grads):
    assert jax_step["step_loss"] == pytest.approx(jax_step["loss"], rel=1e-6)
    assert port_step["loss"] == pytest.approx(jax_step["loss"], rel=2e-5)
    assert port_step["loss"] == pytest.approx(float64_grads[0], rel=2e-6)


def test_step_gradients_match_jax(jax_step, port_step, float64_grads):
    """``tests/test_torch_train.py``'s three-way hold, per leaf and over
    all leaves together."""
    _, g64 = float64_grads
    assert set(port_step["grads"]) == set(jax_step["grads"]) == set(g64)
    leaves = [p for p in sorted(g64) if not _noise_only(p)]
    assert len(leaves) == 104  # 206 leaves − 68 statistics − 34 noise-only biases
    for path in leaves:
        got, want, exact = port_step["grads"][path], jax_step["grads"][path], g64[path]
        jax_off, port_off = _rel_l2(want, exact), _rel_l2(got, exact)
        assert port_off < 0.02 and port_off < jax_off + 2e-3, (path, port_off, jax_off)
        assert _rel_l2(got, want) < min(1.5 * jax_off + 2e-3, 0.08), (path, jax_off)
    whole = lambda g: np.concatenate([g[p].ravel() for p in leaves])  # noqa: E731
    assert _rel_l2(whole(port_step["grads"]), whole(jax_step["grads"])) < 0.05
    assert _rel_l2(whole(port_step["grads"]), whole(g64)) < 0.01
    for path in set(g64) - set(leaves):  # noise on both sides, and small
        scale = max(np.abs(jax_step["grads"][k]).max() for k in leaves)
        assert np.abs(port_step["grads"][path]).max() < 1e-4 * scale, path
        assert np.abs(jax_step["grads"][path]).max() < 1e-4 * scale, path


def test_step_batch_statistics_match_jax(jax_step, port_step):
    got = pointnet2_msg_to_jax_variables(
        {k: v for k, v in port_step["model"].state_dict().items()
         if k.endswith((".mean", ".var"))})
    assert set(got) == set(jax_step["stats"]) == set(jax_step["new_stats"])
    for path, want in jax_step["stats"].items():
        np.testing.assert_allclose(got[path], want, rtol=2e-3, atol=2e-4, err_msg=path)
        np.testing.assert_allclose(got[path], jax_step["new_stats"][path], rtol=2e-3,
                                   atol=2e-4, err_msg=path)  # make_train_step's own
        assert not np.array_equal(want, jax_step["variables"][path])  # they moved


def test_whole_step_matches_jax_where_the_gradient_is_clear_of_noise(jax_step, port_step):
    """``make_train_step``'s parameters against the port's whole step: the
    first Adam update is ±lr wherever |g| is a fifth of its leaf's largest
    entry or more, on both sides alike."""
    got = pointnet2_msg_to_jax_variables(
        {k: v for k, v in port_step["model"].state_dict().items()
         if not k.endswith((".mean", ".var"))})
    compared = 0
    for path, w in jax_step["new_params"].items():
        if _noise_only(path):
            continue
        g = jax_step["grads"][path]
        clear = np.abs(g) > 0.2 * np.abs(g).max()
        compared += int(clear.sum())
        np.testing.assert_allclose(got[path][clear], w[clear], rtol=0, atol=1e-5,
                                   err_msg=path)
        moved = np.abs(got[path] - jax_step["variables"][path])[clear]
        np.testing.assert_allclose(moved, LR, rtol=1e-3)
    assert compared > 10_000
