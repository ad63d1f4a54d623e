"""Parity of the port's RandLA-Net training parts with the JAX package, on
the CPU: class weights, the lr schedule, the weighted softmax
cross-entropy, and one optimizer step of a narrow RandLA-Net (d_out
(16, 32), sub-ratios (4, 4), batch 2 × 1024 points of a spatially-regular
sample) from JAX-initialised weights with the JAX step's dropout mask,
against ``pointsecguard_tpu.train.make_train_step`` with weight decay 0.

The JAX step does not return its gradient; after one step without weight
decay Adam's first moment is 0.1 · g, so g is read from it. As in
``tests/test_torch_train.py`` both gradients are also held against a
float64 evaluation of the port's model on the same pyramid and mask.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu.data import class_weights as jax_class_weights
from pointsecguard_tpu.models import RandLANet as JaxRandLANet
from pointsecguard_tpu.models import build_pyramid as jax_build_pyramid
from pointsecguard_tpu.models import weighted_softmax_ce_loss as jax_ce_loss
from pointsecguard_tpu.train import schedules as jax_schedules
from pointsecguard_tpu.train.trainer import TrainState as JaxTrainState
from pointsecguard_tpu.train.trainer import make_optimizer as jax_make_optimizer
from pointsecguard_tpu.train.trainer import make_train_step as jax_make_train_step
from pointsecguard_tpu_torch.configs import RandlaConfig
from pointsecguard_tpu_torch.data import class_weights
from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
from pointsecguard_tpu_torch.models import (
    RandLANet,
    init_parameters,
    weighted_softmax_ce_loss,
)
from pointsecguard_tpu_torch.train import schedules
from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, randla_family
from pointsecguard_tpu_torch.utils.convert import (
    randla_from_jax_variables,
    randla_to_jax_variables,
)

D_OUT, RATIOS = (16, 32), (4, 4)
CFG = RandlaConfig(d_out=D_OUT, num_layers=2, sub_sampling_ratio=RATIOS)
B, P = 2, 1024
LR = 0.01


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("dataset", ["S3DIS", "Semantic3D", "SemanticKITTI"])
def test_class_weights_equal_jax(dataset):
    np.testing.assert_array_equal(class_weights.get_class_weights(dataset),
                                  jax_class_weights.get_class_weights(dataset))
    np.testing.assert_array_equal(class_weights.NUM_PER_CLASS[dataset],
                                  jax_class_weights.NUM_PER_CLASS[dataset])


@pytest.mark.parametrize("epoch", [0, 1, 7, 31, 99])
def test_randla_lr_equals_jax(epoch):
    assert schedules.randla_lr(epoch) == jax_schedules.randla_lr(epoch)
    assert (schedules.randla_lr(epoch, base=3e-3, decay=0.9)
            == jax_schedules.randla_lr(epoch, base=3e-3, decay=0.9))


def test_config_training_fields_equal_jax():
    from pointsecguard_tpu.configs import RandlaConfig as JaxRandlaConfig

    assert vars(RandlaConfig()) == vars(JaxRandlaConfig())


def test_weighted_softmax_ce_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 500, 13))).astype(np.float32)
    labels = rng.integers(0, 13, (3, 500))
    w = class_weights.get_class_weights("S3DIS")
    want = float(jax_ce_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w)))
    got = weighted_softmax_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(w)).item()
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_weighted_softmax_ce_loss_refuses_ignored_labels():
    """Kept under its name from before the ignored-label loss was ported; it
    now holds that loss to the JAX one: ignored points are left out and the
    rest reduced to the valid classes (SemanticKITTI's 19 classes, label 0
    ignored; tests/test_torch_randla_presets.py holds its gradient), and a
    batch of only ignored points gives 0."""
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 400, 19))).astype(np.float32)
    labels = rng.integers(0, 20, (2, 400))
    w = class_weights.get_class_weights("SemanticKITTI")
    table = torch.from_numpy(randla_dataset_preset("semantickitti").label_table())
    want = float(jax_ce_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w),
                             ignored_labels=(0,)))
    got = weighted_softmax_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(w), label_table=table).item()
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    assert weighted_softmax_ce_loss(torch.zeros(1, 4, 19), torch.zeros(1, 4, dtype=torch.long),
                                    torch.ones(19), label_table=table).item() == 0.0


# --- one optimizer step ------------------------------------------------------

@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    """One sampler batch of [2, 1024] from a synthetic room prepared at
    0.1 m (4329 points, so nothing is up-sampled), S3DIS weights."""
    from pointsecguard_tpu_torch.data import make_synthetic_rooms
    from pointsecguard_tpu_torch.data.randla import SpatiallyRegularSampler, prepare_room

    root = tmp_path_factory.mktemp("randla_step")
    make_synthetic_rooms(str(root / "rooms"), points_per_room=8000, seed=0)
    for name in sorted(os.listdir(root / "rooms")):
        prepare_room(str(root / "rooms" / name), str(root / "prep"), 0.1)
    sampler = SpatiallyRegularSampler.load(str(root / "prep"), split="train",
                                           num_points=P, rng=np.random.default_rng(0))
    assert min(len(c.labels) for c in sampler.clouds) >= P
    _, feats, labels, _, _ = next(sampler.batches(B, 1))
    return feats, labels, class_weights.get_class_weights("S3DIS")


def _flat(tree, top):
    return {k: np.asarray(v) for k, v in flatten_dict({top: tree}, sep="/").items()}


@pytest.fixture(scope="module")
def jax_step(step_inputs):
    """``make_train_step`` of the JAX package with the RandLA loop's
    ``model_args`` and ``output_head``, Adam without weight decay; the
    dropout mask read off the ``Dropout`` module's output in a forward
    with the same key (the step's dropout stream)."""
    feats, labels, weights = step_inputs
    f = jnp.asarray(feats)
    pyramid_fn = jax.jit(lambda x: jax_build_pyramid(x, num_layers=2, sub_ratios=RATIOS,
                                                     knn_tile=None))
    model = JaxRandLANet(d_out=D_OUT)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), f, pyramid_fn(f[..., :3]))
    key = jax.random.PRNGKey(5)
    _, mutated = jax.jit(lambda v, x: model.apply(
        v, x, pyramid_fn(x[..., :3]), train=True, rngs={"dropout": key},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout)))(variables, f)
    dropped = mutated["intermediates"]["Dropout_0"]["__call__"][0]
    before = {**_flat(variables["params"], "params"),
              **_flat(variables["batch_stats"], "batch_stats")}
    tx = jax_make_optimizer(weight_decay=0.0)
    state = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(model, tx, jax_ce_loss,
                               model_args=lambda x: (x, pyramid_fn(x[..., :3])),
                               output_head=lambda out: out)
    # the trainer's bn_momentum: the loop passes 0.01, which RandLA never reads
    new, loss, _ = step(state, f, jnp.asarray(labels), jnp.asarray(weights), LR, 0.01, key)
    mu = _flat(new.opt_state[1].mu, "params")
    return {"before": before, "loss": float(loss), "mask": np.asarray(dropped) != 0,
            "grads": {k: v / 0.1 for k, v in mu.items()}, "mu": mu,
            "nu": _flat(new.opt_state[1].nu, "params"),
            "params": _flat(new.params, "params"),
            "stats": _flat(new.batch_stats, "batch_stats")}


def _port_model(flat):
    model = RandLANet(d_out=D_OUT)
    model.load_state_dict(randla_from_jax_variables(flat))
    return model


@pytest.fixture(scope="module")
def port_step(step_inputs, jax_step):
    feats, labels, weights = step_inputs
    model = _port_model(jax_step["before"])
    state = TrainState(model)
    step = make_train_step(model, weighted_softmax_ce_loss, weight_decay=0.0,
                           family=randla_family(CFG))
    loss = step(state, torch.from_numpy(feats), torch.from_numpy(labels),
                torch.from_numpy(weights), LR, None,
                dropout_mask=torch.from_numpy(jax_step["mask"]))

    def split(flat):
        out, offset = {}, 0
        for k, p in model.named_parameters():
            out[k] = flat[offset : offset + p.numel()].view_as(p)
            offset += p.numel()
        return randla_to_jax_variables(out)

    sd = model.state_dict()
    return {"loss": loss.item(), "grads": split(state.grads), "mu": split(state.mu),
            "nu": split(state.nu), "state": state,
            "params": randla_to_jax_variables(
                {k: v for k, v in sd.items() if not k.endswith((".mean", ".var"))}),
            "stats": randla_to_jax_variables(
                {k: v for k, v in sd.items() if k.endswith((".mean", ".var"))})}


@pytest.fixture(scope="module")
def float64_grads(step_inputs, jax_step):
    """Loss and gradients of the same step in float64 (the port's model on
    the float32 pyramid, whose indices both sides share)."""
    feats, labels, weights = step_inputs
    model = _port_model(jax_step["before"]).double().train()
    pyr = randla_family(CFG).plan(torch.from_numpy(feats))
    pyr = dict(pyr, xyz=tuple(x.double() for x in pyr["xyz"]))
    logits = model(torch.from_numpy(feats).double(), pyr,
                   dropout_mask=torch.from_numpy(jax_step["mask"]))
    loss = weighted_softmax_ce_loss(logits, torch.from_numpy(labels),
                                    torch.from_numpy(weights).double())
    loss.backward()
    return loss.item(), randla_to_jax_variables(
        {k: p.grad for k, p in model.named_parameters()})


def _noise_only(path):
    """Dense biases under a BatchNorm (every conv's, and fc0's under bn0):
    the true gradient is 0, what is there is rounding noise."""
    return path.endswith("Dense_0/bias") and ("PointConv" in path or path == "params/Dense_0/bias")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_step_loss_matches_jax(jax_step, port_step, float64_grads):
    """The same float32 loss to 1e-6 of itself, and both within 1e-6 of the
    float64 evaluation."""
    assert port_step["loss"] == pytest.approx(jax_step["loss"], rel=1e-6)
    assert port_step["loss"] == pytest.approx(float64_grads[0], rel=1e-6)
    assert jax_step["loss"] == pytest.approx(float64_grads[0], rel=1e-6)


def test_step_gradients_match_jax(jax_step, port_step, float64_grads):
    """Per leaf, in relative L2: the port within 1e-4 of float64 and no
    further from it than twice JAX's distance (plus 1e-5); port to JAX
    within 1e-4. The noise-only biases are small on both sides."""
    _, g64 = float64_grads
    assert set(port_step["grads"]) == set(jax_step["grads"]) == set(g64)
    leaves = [p for p in sorted(g64) if not _noise_only(p)]
    assert len(leaves) == 66  # 86 leaves − 20 noise-only biases
    for path in leaves:
        got, want, exact = port_step["grads"][path], jax_step["grads"][path], g64[path]
        jax_off, port_off = _rel_l2(want, exact), _rel_l2(got, exact)
        assert port_off < 1e-4 and port_off < 2 * jax_off + 1e-5, (path, port_off, jax_off)
        assert _rel_l2(got, want) < 1e-4, path
    whole = lambda g: np.concatenate([g[p].ravel() for p in leaves])  # noqa: E731
    assert _rel_l2(whole(port_step["grads"]), whole(g64)) < 1e-5
    scale = max(np.abs(g64[k]).max() for k in leaves)
    for path in set(g64) - set(leaves):
        assert np.abs(port_step["grads"][path]).max() < 1e-4 * scale, path
        assert np.abs(jax_step["grads"][path]).max() < 1e-4 * scale, path


def test_step_batch_statistics_match_jax(jax_step, port_step):
    """Running statistics after one step at RandLA's fixed keep 0.99."""
    assert set(port_step["stats"]) == set(jax_step["stats"])
    for path, want in jax_step["stats"].items():
        np.testing.assert_allclose(port_step["stats"][path], want, rtol=1e-5, atol=1e-6,
                                   err_msg=path)
        assert not np.array_equal(want, jax_step["before"][path])  # they moved


def test_step_adam_moments_match_jax(jax_step, port_step):
    leaves = [p for p in jax_step["mu"] if not _noise_only(p)]
    whole = lambda g: np.concatenate([g[p].ravel() for p in leaves])  # noqa: E731
    assert _rel_l2(whole(port_step["mu"]), whole(jax_step["mu"])) < 1e-5
    assert _rel_l2(whole(port_step["nu"]), whole(jax_step["nu"])) < 2e-5
    assert port_step["state"].count.item() == 1 and port_step["state"].step == 1


def test_whole_step_matches_jax_where_the_gradient_is_clear_of_noise(jax_step, port_step):
    """The first Adam update is lr · g / (|g| + ε), ±lr wherever |g| is
    clear of the noise (a fifth of the leaf's largest entry), on both
    sides alike."""
    compared = 0
    for path, want in jax_step["params"].items():
        if _noise_only(path):
            continue
        g = jax_step["grads"][path]
        clear = np.abs(g) > 0.2 * np.abs(g).max()
        compared += int(clear.sum())
        np.testing.assert_allclose(port_step["params"][path][clear], want[clear],
                                   rtol=0, atol=1e-6, err_msg=path)
        moved = np.abs(port_step["params"][path] - jax_step["before"][path])[clear]
        np.testing.assert_allclose(moved, LR, rtol=1e-3)
    assert compared > 500


def test_the_step_reads_no_bn_momentum(step_inputs, jax_step):
    """RandLA's BatchNorm keep is fixed at 0.99 (the JAX model drops the
    trainer's momentum): two steps given different momenta are equal."""
    feats, labels, weights = step_inputs
    out = []
    for momentum in (None, 0.5):
        model = _port_model(jax_step["before"])
        state = TrainState(model)
        step = make_train_step(model, weighted_softmax_ce_loss, weight_decay=0.0,
                               family=randla_family(CFG))
        step(state, torch.from_numpy(feats), torch.from_numpy(labels),
             torch.from_numpy(weights), LR, momentum,
             dropout_mask=torch.from_numpy(jax_step["mask"]))
        out.append((state.params.clone(), state.stats.clone()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


# --- the model in training mode ----------------------------------------------

def test_dropout_mask_from_a_generator_or_given():
    """Train mode: the head's 32 features are kept where the mask is true
    and scaled by 2, the mask drawn from the generator when none is given;
    evaluation mode applies none."""
    model = RandLANet(d_out=D_OUT)
    init_parameters(model, torch.Generator().manual_seed(0))
    feats = torch.from_numpy(np.random.default_rng(1).random((2, 256, 6)).astype(np.float32))
    pyr = randla_family(CFG).plan(feats)
    seen = {}
    hooks = [model.fc2.register_forward_hook(lambda m, i, o: seen.__setitem__("f", o)),
             model.fc.register_forward_hook(lambda m, i, o: seen.__setitem__("x", i[0]))]
    model.train()
    a = model(feats, pyr, generator=torch.Generator().manual_seed(4))
    b = model(feats, pyr, generator=torch.Generator().manual_seed(4))
    c = model(feats, pyr, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    mask = torch.from_numpy(np.random.default_rng(2).random((2, 256, 32)) < 0.5)
    model(feats, pyr, dropout_mask=mask)
    assert torch.equal(seen["x"], torch.where(mask, 2 * seen["f"], torch.zeros_like(seen["f"])))
    model.eval()
    assert model(feats, pyr).shape == (2, 256, 13)
    assert torch.equal(seen["x"], seen["f"])
    for h in hooks:
        h.remove()


def test_init_parameters_is_flax_lecun_normal_for_randla():
    """Zero biases, truncated-normal kernels of variance 1 / fan_in and the
    attentive scores' bias-free Dense, as ``model.init`` gives them."""
    import math

    f = jnp.zeros((1, 256, 6), jnp.float32)
    pyr = jax_build_pyramid(f[..., :3], num_layers=2, sub_ratios=RATIOS, knn_tile=None)
    flat = flatten_dict(jax.jit(JaxRandLANet(d_out=D_OUT).init)(jax.random.PRNGKey(0), f, pyr),
                        sep="/")
    model = RandLANet(d_out=D_OUT)
    init_parameters(model, torch.Generator().manual_seed(0))
    port = randla_to_jax_variables(model.state_dict())
    assert set(port) == set(flat)
    for path, want in flat.items():
        got, want = port[path], np.asarray(want)
        assert got.shape == want.shape
        if path.endswith("/kernel"):
            bound = 2.0 / 0.87962566103423978 / math.sqrt(want.shape[0])
            assert np.abs(got).max() <= bound * (1 + 1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_nan_guard_skips_a_poisoned_batch():
    rng = np.random.default_rng(6)
    feats = rng.random((2, 256, 6)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 13, (2, 256)))
    weights = torch.from_numpy(class_weights.get_class_weights("S3DIS"))
    model = RandLANet(d_out=D_OUT)
    init_parameters(model, torch.Generator().manual_seed(0))
    state = TrainState(model)
    step = make_train_step(model, weighted_softmax_ce_loss, weight_decay=0.0,
                           family=randla_family(CFG))
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(step(state, torch.from_numpy(feats), labels, weights, LR, None, gen))
    kept = [t.clone() for t in (state.params, state.mu, state.nu, state.count, state.stats)]
    bad = feats.copy()
    bad[1, 7, 4] = np.nan  # a colour: the pyramid stays finite
    loss = step(state, torch.from_numpy(bad), labels, weights, LR, None, gen)
    assert not torch.isfinite(loss)
    for new, old in zip((state.params, state.mu, state.nu, state.count, state.stats), kept):
        assert torch.equal(new, old)
    assert state.step == 2 and state.count.item() == 1
    assert torch.isfinite(step(state, torch.from_numpy(feats), labels, weights, LR, None, gen))
    assert state.step == 3 and state.count.item() == 2
