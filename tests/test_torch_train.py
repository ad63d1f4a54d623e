"""Parity of the port's trainer with the JAX package, on the CPU.

Adam turns a gradient at rounding level into a full lr step, so the step
is held against JAX in two parts: loss, gradients and BatchNorm
statistics from the same weights, batch, FPS starts and dropout mask; and
the optimizer alone, fed identical gradients across an lr change. Updated
parameters of a whole step are compared only where |g| is clear of the
noise.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxSSG
from pointsecguard_tpu.models import weighted_nll_loss as jax_weighted_nll_loss
from pointsecguard_tpu.models.common import PointMLP as JaxPointMLP
from pointsecguard_tpu.ops import farthest_point_sample as jax_fps
from pointsecguard_tpu.train import schedules as jax_schedules
from pointsecguard_tpu.train.trainer import TrainState as JaxTrainState
from pointsecguard_tpu.train.trainer import make_optimizer as jax_make_optimizer
from pointsecguard_tpu.train.trainer import make_train_step as jax_make_train_step
from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models import (
    PointNet2SemSegSSG,
    build_geometry,
    init_parameters,
    weighted_nll_loss,
)
from pointsecguard_tpu_torch.models.common import PointConv
from pointsecguard_tpu_torch.train import schedules
from pointsecguard_tpu_torch.train.trainer import (
    TrainState,
    adam_update,
    make_train_step,
)
from pointsecguard_tpu_torch.utils.convert import from_jax_variables, to_jax_variables

BN_MOMENTUM = 0.1  # torch's; both models take the keep fraction 1 − m
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


@pytest.mark.parametrize("epoch", [0, 9, 10, 25, 39, 40, 200])
def test_schedules_equal_jax(epoch):
    assert schedules.pointnet2_lr(epoch) == jax_schedules.pointnet2_lr(epoch)
    assert (schedules.pointnet2_lr(epoch, base=0.003)
            == jax_schedules.pointnet2_lr(epoch, base=0.003))
    assert (schedules.pointnet2_bn_momentum(epoch)
            == jax_schedules.pointnet2_bn_momentum(epoch))


def test_weighted_nll_loss_matches_jax():
    rng = np.random.default_rng(0)
    logp = np.log(rng.dirichlet(np.ones(13), (3, 50))).astype(np.float32)
    labels = rng.integers(0, 13, (3, 50))
    w = (0.5 + rng.random(13)).astype(np.float32)
    want = float(jax_weighted_nll_loss(jnp.asarray(logp), jnp.asarray(labels),
                                       jnp.asarray(w)))
    got = weighted_nll_loss(torch.from_numpy(logp), torch.from_numpy(labels),
                            torch.from_numpy(w)).item()
    assert got == pytest.approx(want, rel=1e-6)  # the same float32 sums


def test_generator_wins_over_start_idx_like_the_jax_key():
    xyz = np.random.default_rng(0).random((3, 40, 3)).astype(np.float32)
    start = np.array([5, 6, 7], np.int32)
    # JAX: the key decides the start, whatever start_idx says
    key = jax.random.PRNGKey(0)
    with_both = jax_fps(jnp.asarray(xyz), 4, start_idx=jnp.asarray(start), key=key)
    key_only = jax_fps(jnp.asarray(xyz), 4, key=key)
    np.testing.assert_array_equal(np.asarray(with_both), np.asarray(key_only))
    # the port: the generator decides it
    t = torch.from_numpy(xyz)
    drawn = torch.randint(0, 40, (3,), generator=torch.Generator().manual_seed(1),
                          dtype=torch.int32)
    got = ops.farthest_point_sample(t, 4, start_idx=torch.from_numpy(start),
                                    generator=torch.Generator().manual_seed(1))
    assert got[:, 0].tolist() == drawn.tolist() != start.tolist()
    only_start = ops.farthest_point_sample(t, 4, start_idx=torch.from_numpy(start))
    assert only_start[:, 0].tolist() == start.tolist()
    assert ops.farthest_point_sample(t, 4)[:, 0].tolist() == [0, 0, 0]


def test_training_geometry_draws_one_start_per_cloud_and_level():
    xyz = torch.from_numpy(np.random.default_rng(1).random((4, 2048, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    geo = build_geometry(xyz, generator=gen)
    ref = torch.Generator().manual_seed(5)
    cur = xyz
    for li, n in enumerate((2048, 1024, 256, 64)):
        start = torch.randint(0, n, (4,), generator=ref, dtype=torch.int32)
        centres = geo["sa"][li][0]
        np.testing.assert_array_equal(
            centres[:, 0].numpy(), cur[torch.arange(4), start.long()].numpy())
        cur = centres
    fixed = [torch.full((4,), 3, dtype=torch.int32)] * 4
    geo_fixed = build_geometry(xyz, start_idx=fixed)
    np.testing.assert_array_equal(geo_fixed["sa"][0][0][:, 0].numpy(), xyz[:, 3].numpy())
    assert not torch.equal(geo_fixed["sa"][0][0], build_geometry(xyz)["sa"][0][0])


def test_init_parameters_is_flax_lecun_normal():
    """Zero biases and truncated-normal kernels of variance 1 / fan_in,
    as ``model.init`` gives them (not ``nn.Linear``'s uniform)."""
    pts = jnp.zeros((1, 32, 9), jnp.float32)
    flat = flatten_dict(jax.jit(JaxSSG().init)(jax.random.PRNGKey(0), pts), sep="/")
    model = PointNet2SemSegSSG()
    init_parameters(model, torch.Generator().manual_seed(0))
    port = to_jax_variables(model.state_dict())
    assert set(port) == set(flat)
    for path, want in flat.items():
        got, want = port[path], np.asarray(want)
        assert got.shape == want.shape
        if path.endswith("/kernel"):
            fan_in = want.shape[0]
            bound = 2.0 / 0.87962566103423978 / math.sqrt(fan_in)
            assert np.abs(got).max() <= bound * (1 + 1e-6)
            assert np.abs(want).max() <= bound * (1 + 1e-6)
            if want.size >= 4096:  # a sample large enough for 5 % on the std
                assert got.std() == pytest.approx(math.sqrt(1.0 / fan_in), rel=0.05)
                assert got.std() == pytest.approx(want.std(), rel=0.05)
                assert abs(got.mean()) < 3 * got.std() / math.sqrt(got.size) + 1e-9
        else:  # biases 0, scales 1, means 0, variances 1
            np.testing.assert_array_equal(got, want)
    again = PointNet2SemSegSSG()
    init_parameters(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


# --- part 1: loss, gradients and BatchNorm statistics of one step -------------
#
# The random-initialised network in training mode is ill-conditioned: its 28
# BatchNorms divide by batch deviations, and the JAX package sums the batch
# statistics of up to 65536 rows in plain float32 order. Measured on these
# inputs, the JAX log-probabilities sit 4e-3 from a float64 evaluation and
# its gradient 3 % (relative L2), while the port's float32 step sits 1e-4
# and 0.4 % from the same float64 evaluation. So the gradient is held three
# ways: the port as close to float64 as JAX is, the port within JAX's own
# float64 distance of JAX, and an absolute cap on both.

B, P = 2, 1024


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    """Two sampler blocks of a synthetic room (structured colours and
    labels; 1024 points, so that the first FPS level does not wrap)."""
    from pointsecguard_tpu_torch.data import (
        RoomSet,
        S3DISBlockSampler,
        make_synthetic_rooms,
    )

    root = str(tmp_path_factory.mktemp("rooms"))
    make_synthetic_rooms(root, points_per_room=20000, seed=0)
    rooms = RoomSet.load(root, "train", 5)
    sampler = S3DISBlockSampler(rooms, num_point=P, min_points=P // 2)
    pts, labels = next(iter(sampler.batches(np.random.default_rng(0), B)))
    return pts, labels, rooms.label_weights.astype(np.float32)


def _flat(tree, top):
    return {k: np.asarray(v) for k, v in flatten_dict({top: tree}, sep="/").items()}


@pytest.fixture(scope="module")
def jax_step(step_inputs):
    """The JAX step from its parts, without a ``sample`` rng (FPS start
    0): loss, gradients, new batch statistics and the dropout mask read
    off the ``Dropout`` module's output (where its input is 0 the mask
    does not matter)."""
    pts, labels, weights = step_inputs
    model = JaxSSG()
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
    return {
        "variables": {**_flat(variables["params"], "params"),
                      **_flat(variables["batch_stats"], "batch_stats")},
        "loss": float(loss), "grads": _flat(grads, "params"),
        "stats": _flat(stats, "batch_stats"), "mask": np.asarray(dropped) != 0,
        "tree": (variables, grads),
    }


@pytest.fixture(scope="module")
def port_step(step_inputs, jax_step):
    """The port's step from the same weights, batch, FPS start 0 and
    dropout mask."""
    pts, labels, weights = step_inputs
    model = PointNet2SemSegSSG()
    model.load_state_dict(from_jax_variables(jax_step["variables"]))
    state = TrainState(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, weighted_nll_loss)
    start = [torch.zeros(B, dtype=torch.int32)] * 4
    loss = step(state, torch.from_numpy(pts), torch.from_numpy(labels),
                torch.from_numpy(weights), LR, BN_MOMENTUM, start_idx=start,
                dropout_mask=torch.from_numpy(jax_step["mask"]))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return {"loss": loss.item(), "state": state, "model": model,
            "before": to_jax_variables(before), "grads": to_jax_variables(grads)}


@pytest.fixture(scope="module")
def float64_grads(step_inputs, jax_step):
    """The same step's loss and gradients evaluated in float64 (the
    port's model; the float32 geometry, whose indices both sides share)."""
    pts, labels, weights = step_inputs
    model = PointNet2SemSegSSG()
    model.load_state_dict(from_jax_variables(jax_step["variables"]))
    model.double().train()
    geo = build_geometry(torch.from_numpy(pts)[..., :3])
    geo = {"sa": tuple((c.double(), i) for c, i in geo["sa"]),
           "fp": tuple((i, w.double()) for i, w in geo["fp"])}
    logp, _ = model(torch.from_numpy(pts).double(), geometry=geo,
                    momentum=1.0 - BN_MOMENTUM,
                    dropout_mask=torch.from_numpy(jax_step["mask"]))
    loss = weighted_nll_loss(logp, torch.from_numpy(labels),
                             torch.from_numpy(weights).double())
    loss.backward()
    return loss.item(), to_jax_variables(
        {k: p.grad for k, p in model.named_parameters()})


def _noise_only(path):
    """Dense biases under a BatchNorm: the true gradient is 0, what is
    there is rounding noise."""
    return path.endswith("Dense_0/bias") and "PointConv" in path


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_step_loss_matches_jax(jax_step, port_step, float64_grads):
    # float32 arithmetic in another summation order: 2e-5 of the loss
    assert port_step["loss"] == pytest.approx(jax_step["loss"], rel=2e-5)
    assert port_step["loss"] == pytest.approx(float64_grads[0], rel=2e-6)


def test_step_gradients_match_jax(jax_step, port_step, float64_grads):
    """Per leaf, in relative L2: the port is within 2 % of float64 and no
    further from it than JAX is (plus 0.2 %); the port is within 1.5 times
    JAX's own float64 distance of JAX (plus 0.2 %), and within 8 % at the
    most. Over all leaves together: port to JAX within 5 %."""
    _, g64 = float64_grads
    assert set(port_step["grads"]) == set(jax_step["grads"]) == set(g64)
    leaves = [p for p in sorted(g64) if not _noise_only(p)]
    assert len(leaves) == 68  # 134 leaves − 44 statistics − 22 noise-only biases
    for path in leaves:
        got, want, exact = port_step["grads"][path], jax_step["grads"][path], g64[path]
        jax_off, port_off = _rel_l2(want, exact), _rel_l2(got, exact)
        assert port_off < 0.02 and port_off < jax_off + 2e-3, (path, port_off, jax_off)
        assert _rel_l2(got, want) < min(1.5 * jax_off + 2e-3, 0.08), (path, jax_off)
    whole = lambda g: np.concatenate([g[p].ravel() for p in leaves])
    assert _rel_l2(whole(port_step["grads"]), whole(jax_step["grads"])) < 0.05
    assert _rel_l2(whole(port_step["grads"]), whole(g64)) < 0.01
    for path in set(g64) - set(leaves):  # noise on both sides, and small
        scale = max(np.abs(jax_step["grads"][k]).max() for k in leaves)
        assert np.abs(port_step["grads"][path]).max() < 1e-4 * scale, path
        assert np.abs(jax_step["grads"][path]).max() < 1e-4 * scale, path


def test_step_batch_statistics_match_jax(jax_step, port_step):
    """Running statistics after one step at keep 0.9: a tenth of the batch
    statistic, which the JAX side sums in plain float32 order."""
    got = to_jax_variables({k: v for k, v in port_step["model"].state_dict().items()
                            if k.endswith((".mean", ".var"))})
    assert set(got) == set(jax_step["stats"])
    for path, want in jax_step["stats"].items():
        np.testing.assert_allclose(got[path], want, rtol=2e-3, atol=2e-4, err_msg=path)
        assert not np.array_equal(want, jax_step["variables"][path])  # they moved


def test_whole_step_matches_jax_where_the_gradient_is_clear_of_noise(jax_step, port_step):
    """The first Adam update is lr · g / (|g| + ε) with the L2 term in g:
    ±lr wherever |g| is clear of the noise, on both sides alike. "Clear"
    is a fifth of the leaf's largest entry: the two gradients differ by a
    few per cent of it (see above), so the signs agree there."""
    variables, grads = jax_step["tree"]
    tx = jax_make_optimizer()
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    new = jax.tree_util.tree_map(lambda p, u: p - LR * u, variables["params"], updates)
    want = _flat(new, "params")
    got = to_jax_variables({k: v for k, v in port_step["model"].state_dict().items()
                            if not k.endswith((".mean", ".var"))})
    compared = 0
    for path, w in want.items():
        if _noise_only(path):
            continue
        g = jax_step["grads"][path]
        clear = np.abs(g) > 0.2 * np.abs(g).max()
        compared += int(clear.sum())
        # ±lr on both sides, to float32 rounding of g / (|g| + ε)
        np.testing.assert_allclose(got[path][clear], w[clear], rtol=0, atol=1e-5,
                                   err_msg=path)
        moved = np.abs(got[path] - port_step["before"][path])[clear]
        np.testing.assert_allclose(moved, LR, rtol=1e-3)
    assert compared > 10_000


# --- part 2: the optimizer alone, on identical gradients ---------------------

def test_optimizer_matches_jax_on_identical_gradients_across_an_lr_change():
    """``adam_update`` against ``make_optimizer`` + ``p − lr·u`` for 7
    steps, the lr changing after the fourth; gradients from a numpy seed,
    some at rounding level, handed to both. Agreement to 1e-6: the same
    float32 elementwise arithmetic (the bias corrections are computed in
    float64 here and in float32 there, a relative 1e-7)."""
    rng = np.random.default_rng(4)
    layer = PointConv(6, 5)
    state = TrainState(layer)
    names = [k for k, _ in layer.named_parameters()]
    params = {k: jnp.asarray(p.detach().numpy().copy())
              for k, p in layer.named_parameters()}
    tx = jax_make_optimizer(weight_decay=1e-4)
    opt = tx.init(params)
    for it in range(7):
        lr = 0.003 if it < 4 else 0.0021
        grads = {k: (rng.standard_normal(params[k].shape)
                     * rng.choice([1.0, 1e-3, 1e-9], params[k].shape)).astype(np.float32)
                 for k in names}
        updates, opt = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, opt, params)
        params = {k: params[k] - lr * updates[k] for k in names}
        state.grads.copy_(torch.cat([torch.from_numpy(grads[k]).reshape(-1) for k in names]))
        adam_update(state, lr)
        for k, p in layer.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                       rtol=0, atol=1e-6, err_msg=f"{k} step {it}")
    assert state.count.item() == 7
    mu = torch.cat([torch.from_numpy(np.asarray(opt[1].mu[k])).reshape(-1) for k in names])
    nu = torch.cat([torch.from_numpy(np.asarray(opt[1].nu[k])).reshape(-1) for k in names])
    np.testing.assert_allclose(state.mu.numpy(), mu.numpy(), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(state.nu.numpy(), nu.numpy(), rtol=1e-5, atol=1e-20)


# --- the guard ---------------------------------------------------------------

def test_nan_guard_keeps_parameters_moments_and_statistics():
    rng = np.random.default_rng(6)
    pts = rng.random((2, 64, 9)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 13, (2, 64)))
    weights = torch.ones(13)
    model = PointNet2SemSegSSG()
    init_parameters(model, torch.Generator().manual_seed(0))
    state = TrainState(model)
    step = make_train_step(model, weighted_nll_loss)
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(step(state, torch.from_numpy(pts), labels, weights, LR,
                               BN_MOMENTUM, gen))
    kept = [t.clone() for t in (state.params, state.mu, state.nu, state.count, state.stats)]
    assert state.step == 1 and state.count.item() == 1 and state.mu.abs().sum() > 0
    bad = pts.copy()
    bad[1, 7, 4] = np.nan  # a colour: the geometry stays finite
    loss = step(state, torch.from_numpy(bad), labels, weights, LR, BN_MOMENTUM, gen)
    assert not torch.isfinite(loss)  # reported, so the loop can count it
    for new, old in zip((state.params, state.mu, state.nu, state.count, state.stats), kept):
        assert torch.equal(new, old)
    # counted as JAX counts: the step of every batch, Adam's count of updates
    assert state.step == 2 and state.count.item() == 1
    assert all(torch.isfinite(v).all() for v in model.state_dict().values())
    # and the next good batch trains on
    assert torch.isfinite(step(state, torch.from_numpy(pts), labels, weights, LR,
                               BN_MOMENTUM, gen))
    assert state.step == 3 and state.count.item() == 2
    assert not torch.equal(state.params, kept[0])


def test_jax_guard_counts_the_same_way():
    """The JAX step on a NaN batch: ``step`` goes up, Adam's count and the
    parameters stay (a small model: the guard does not depend on it)."""
    rng = np.random.default_rng(7)
    pts = rng.random((2, 16, 9)).astype(np.float32)
    pts[0, 0, 0] = np.nan
    labels = jnp.asarray(rng.integers(0, 13, (2, 16)))
    model = JaxPointMLP((13,))
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(pts))
    tx = jax_make_optimizer()
    state = JaxTrainState(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    before = jax.tree_util.tree_map(np.asarray, state.params)
    step = jax_make_train_step(model, tx, jax_weighted_nll_loss)
    state, loss, _ = step(state, jnp.asarray(pts), labels, jnp.ones(13), LR,
                          BN_MOMENTUM, jax.random.PRNGKey(1))
    assert not np.isfinite(float(loss))
    assert int(state.step) == 1 and int(state.opt_state[1].count) == 0
    jax.tree_util.tree_map(np.testing.assert_array_equal, before,
                           jax.tree_util.tree_map(np.asarray, state.params))


def test_checkpoint_payload_round_trip(tmp_path):
    from pointsecguard_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_checkpoint,
    )

    layer = PointConv(4, 3)
    state = TrainState(layer)
    state.grads.normal_(generator=torch.Generator().manual_seed(0))
    adam_update(state, LR)
    state.step = 5
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    assert ckpt.restore_latest() is None and ckpt.restore_best() is None
    ckpt.save(1, state.payload(), miou=0.4)
    best = {k: v.clone() for k, v in layer.state_dict().items()}
    adam_update(state, LR)
    ckpt.save(2, state.payload(), miou=0.3)  # a worse epoch: latest moves, best stays
    latest = ckpt.restore_latest()
    assert latest["epoch"] == 2 and latest["best_miou"] == 0.4
    for k, v in ckpt.restore_best().items():
        assert torch.equal(v, best[k])
    for k, v in load_checkpoint(str(tmp_path)).items():  # readers: best first
        assert torch.equal(v, best[k])
    other = TrainState(PointConv(4, 3))
    other.load_payload(latest)
    assert other.step == 5 and other.count.item() == 2
    assert torch.equal(other.params, state.params) and torch.equal(other.nu, state.nu)
    ckpt.save(3, state.payload(), miou=0.5)
    assert torch.equal(ckpt.restore_best()["dense.weight"], layer.dense.weight)
    (tmp_path / "checkpoints" / "best.pt").unlink()
    assert torch.equal(load_checkpoint(str(tmp_path))["dense.weight"], layer.dense.weight)
