"""``--adv_train nb`` in the port (``train.trainer.make_adv_train_fn``)
against the JAX package's ``make_adv_train_fn``, on the CPU.

The crafted batch: the same PointNet weights in both packages (through
``utils/convert.py``), random start 0, float64 on both sides
(``jax.enable_x64``, with the JAX BatchNorm's, STN's and logits' float32
casts swapped out as tests/test_torch_cls_models.py swaps them), within
1e-10; the same in the reduced class space of an ignored label. Then the
hook's own properties: a zero budget is the identity (and the step with it
is the step without it, bit for bit), the batch stays in the ε-ball and
the clip box, ignored points never move, the hoisted plan equals one
rebuilt in every forward (PointNet++ SSG and RandLA), and the attack moves
no BatchNorm statistic.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu.attacks.pgd import PGDConfig as JaxPGDConfig
from pointsecguard_tpu.models import common as jcommon
from pointsecguard_tpu.models import pointnet as jpointnet
from pointsecguard_tpu.train.trainer import TrainState as JaxTrainState
from pointsecguard_tpu.train.trainer import make_adv_train_fn as jax_make_adv_train_fn
from pointsecguard_tpu_torch.attacks.pgd import PGDConfig
from pointsecguard_tpu_torch.configs import RandlaConfig
from pointsecguard_tpu_torch.models import (
    PointNet2SemSegSSG,
    PointNetSemSeg,
    RandLANet,
    init_parameters,
    weighted_nll_loss,
)
from pointsecguard_tpu_torch.train.trainer import (
    POINTNET,
    POINTNET2,
    TrainState,
    make_adv_train_fn,
    make_train_step,
    randla_family,
)
from pointsecguard_tpu_torch.utils.convert import pointnet_from_jax_variables

B, N = 2, 128


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(seed=0, b=B, n=N, classes=13):
    rng = np.random.default_rng(seed)
    pts = rng.random((b, n, 9))
    return pts, rng.integers(0, classes, (b, n))


# --- against the JAX hook, in float64 ---------------------------------------------

class BatchNorm(nn.Module):
    """The JAX evaluation-mode BatchNorm without its float32 cast (named
    as the original, so that flax names its variables alike)."""

    epsilon: float = 1e-5

    @nn.compact
    def __call__(self, x, use_running_average, momentum=0.9):
        f = x.shape[-1]
        mean = self.variable("batch_stats", "mean", jnp.zeros, (f,), x.dtype)
        var = self.variable("batch_stats", "var", jnp.ones, (f,), x.dtype)
        scale = self.param("scale", nn.initializers.ones, (f,))
        bias = self.param("bias", nn.initializers.zeros, (f,))
        assert use_running_average, "evaluation mode only"
        inv = jnp.reciprocal(jnp.sqrt(var.value + self.epsilon))
        return (x - mean.value) * inv * scale + bias


class STN(nn.Module):
    """The JAX STN with its alignment matrix in the input's dtype."""

    k: int
    dtype: object = None

    @nn.compact
    def __call__(self, x, *, train=False, momentum=0.9):
        h = x
        for f in (64, 128, 1024):
            h = jcommon.PointConv(f)(h, train=train, momentum=momentum)
        h = jnp.max(h, axis=1)
        for f in (512, 256):
            h = nn.relu(BatchNorm()(nn.Dense(f)(h), not train, momentum))
        h = nn.Dense(self.k * self.k)(h)
        return (h + jnp.eye(self.k, dtype=h.dtype).reshape(1, -1)).reshape(-1, self.k, self.k)


class _PointNetSemSeg64(jpointnet.PointNetSemSeg):
    """The JAX PointNetSemSeg with its logits left in the input's dtype."""

    @nn.compact
    def __call__(self, points, *, train=False, momentum=0.9):
        x, _, trans_feat = jpointnet.PointNetEncoder(global_feat=False, feature_transform=True)(
            points[..., :6], train=train, momentum=momentum)
        for f in (512, 256, 128):
            x = jcommon.PointConv(f)(x, train=train, momentum=momentum)
        return nn.log_softmax(nn.Dense(self.num_classes)(x), axis=-1), trans_feat


@pytest.fixture
def _jax_float64(monkeypatch):
    for module in (jcommon, jpointnet):
        monkeypatch.setattr(module, "BatchNorm", BatchNorm)
    monkeypatch.setattr(jpointnet, "STN", STN)


def _random_pointnet(classes, seed=0):
    """The JAX PointNetSemSeg's variables, BatchNorm statistics and scales
    drawn away from their defaults, as a flat float64 map."""
    variables = jpointnet.PointNetSemSeg(num_classes=classes).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 9), jnp.float32))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in flatten_dict(jax.tree_util.tree_map(np.asarray, dict(variables)),
                             sep="/").items():
        if k.endswith("/mean") or k.endswith("/bias"):
            v = rng.normal(0, 0.1, v.shape)
        elif k.endswith("/var") or k.endswith("/scale"):
            v = rng.uniform(0.5, 2.0, v.shape)
        flat[k] = np.asarray(v, np.float64)
    return flat


_JAX_CASES = {"s3dis": ((), 13), "ignored_label_0": ((0,), 12)}


@pytest.mark.parametrize("case", sorted(_JAX_CASES))
def test_crafted_batch_equals_jax_in_float64(_jax_float64, case):
    ignored, classes = _JAX_CASES[case]
    flat = _random_pointnet(classes)
    pts, labels = _batch(classes=classes + len(ignored))
    jcfg = JaxPGDConfig(eps=0.1, alpha=0.03, iters=4)
    with jax.enable_x64(True):
        variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v, jnp.float64)
                                    for k, v in flat.items()})
        kw = {"ignored_labels": ignored, "num_classes": classes} if ignored else {}
        jfn = jax_make_adv_train_fn(_PointNetSemSeg64(num_classes=classes), jcfg, **kw)
        state = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=None, step=jnp.zeros((), jnp.int32))
        want = np.asarray(jax.jit(functools.partial(jfn, state))(
            jnp.asarray(pts), jnp.asarray(labels), jax.random.PRNGKey(0)))
    assert want.dtype == np.float64

    model = PointNetSemSeg(num_classes=classes)
    model.load_state_dict(pointnet_from_jax_variables(flat))
    model.double().train()
    fn = make_adv_train_fn(model, POINTNET, PGDConfig(eps=0.1, alpha=0.03, iters=4),
                           ignored_labels=ignored, num_classes=classes)
    got = fn(torch.from_numpy(pts), torch.from_numpy(labels)).numpy()
    assert got.dtype == np.float64 and model.training
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    moved = np.abs(got - pts).max(axis=-1) > 0
    assert moved.mean() > 0.5  # the attack did move most points
    if ignored:
        assert not moved[labels == 0].any()


# --- the hook's own properties ---------------------------------------------------

def _pointnet(seed=0):
    model = PointNetSemSeg()
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def test_zero_budget_is_the_identity_and_leaves_the_step_alone():
    """eps = 0 projects every iteration back onto the clean colours: the
    crafted batch is the batch, and the step with the hook is the step
    without it, bit for bit (no draw taken, no statistic moved)."""
    pts, labels = (torch.from_numpy(a) for a in _batch())
    pts = pts.float()
    states = []
    for eps in (None, 0.0):
        model = _pointnet()
        state = TrainState(model)
        adv = None if eps is None else make_adv_train_fn(
            model, POINTNET, PGDConfig(eps=eps, alpha=0.05, iters=3))
        if adv is not None:
            assert torch.equal(adv(pts, labels), pts)
        step = make_train_step(model, weighted_nll_loss, family=POINTNET, adv_fn=adv)
        loss = step(state, pts, labels, torch.ones(13), 0.01, 0.1, torch.Generator())
        states.append((loss, state))
    (l0, s0), (l1, s1) = states
    assert torch.equal(l0, l1)
    for name in ("params", "mu", "nu", "stats"):
        assert torch.equal(getattr(s0, name), getattr(s1, name)), name


@pytest.mark.parametrize("rand_init", [0.0, 0.05])
def test_the_batch_stays_in_the_eps_ball_and_the_clip_box(rand_init):
    pts, labels = (torch.from_numpy(a) for a in _batch(seed=1))
    pts = pts.float()
    model = _pointnet()
    fn = make_adv_train_fn(model, POINTNET, PGDConfig(eps=0.05, alpha=0.03, iters=3,
                                                      rand_init_eps=rand_init))
    adv = fn(pts, labels, torch.Generator().manual_seed(2))
    delta = adv[..., 3:6] - pts[..., 3:6]
    assert float(delta.abs().max()) <= 0.05 + 1e-6 and float(delta.abs().max()) > 0.04
    assert float(adv[..., 3:6].min()) >= 0.0 and float(adv[..., 3:6].max()) <= 1.0
    assert torch.equal(adv[..., :3], pts[..., :3]) and torch.equal(adv[..., 6:], pts[..., 6:])
    # the random start draws from the generator: another seed, another batch
    other = fn(pts, labels, torch.Generator().manual_seed(3))
    assert torch.equal(adv, other) == (rand_init == 0.0)
    if rand_init:
        with pytest.raises(ValueError, match="generator"):
            fn(pts, labels)


def test_ignored_points_are_never_perturbed():
    pts, labels = (torch.from_numpy(a) for a in _batch(seed=2, classes=9))
    pts = pts.float()
    model = PointNetSemSeg(num_classes=8)
    init_parameters(model, torch.Generator().manual_seed(1))
    fn = make_adv_train_fn(model, POINTNET, PGDConfig(eps=0.1, alpha=0.05, iters=3,
                                                      rand_init_eps=0.05),
                           ignored_labels=(0,), num_classes=8)
    adv = fn(pts, labels, torch.Generator().manual_seed(0))
    ignored = labels == 0
    assert 0 < int(ignored.sum()) < ignored.numel()
    assert torch.equal(adv[ignored], pts[ignored])
    assert bool((adv[~ignored] != pts[~ignored]).any(dim=-1).all())
    with pytest.raises(ValueError, match="num_classes"):
        make_adv_train_fn(model, POINTNET, PGDConfig(eps=0.1, alpha=0.05, iters=1),
                          ignored_labels=(0,))


def _ssg():
    model = PointNet2SemSegSSG()
    init_parameters(model, torch.Generator().manual_seed(0))
    return model, POINTNET2, _batch(seed=3)


RANDLA_CFG = RandlaConfig(d_out=(16, 32), num_layers=2, sub_sampling_ratio=(4, 4))


def _randla():
    model = RandLANet(d_out=RANDLA_CFG.d_out)
    init_parameters(model, torch.Generator().manual_seed(0))
    pts, labels = _batch(seed=4, n=256)
    return model, randla_family(RANDLA_CFG), (pts[..., :6], labels)


@pytest.mark.parametrize("build", [_ssg, _randla], ids=["pointnet2", "randla"])
def test_hoisted_plan_equals_one_rebuilt_every_forward(build):
    """The evaluation plan the hook builds once from the clean batch gives
    the batch that the attack gives with the plan rebuilt in every
    forward (the JAX model's own forward); one plan a step against one a
    forward; no BatchNorm statistic moves, and the model is back in
    training mode."""
    from pointsecguard_tpu_torch.attacks.pgd import pgd_color_attack

    model, family, (pts, labels) = build()
    pts, labels = torch.from_numpy(pts).float(), torch.from_numpy(labels)
    stats = TrainState(model).stats
    before = stats.clone()
    plans = []
    counted = family._replace(plan=lambda p, **kw: plans.append(1) or family.plan(p, **kw))
    cfg = PGDConfig(eps=0.1, alpha=0.03, iters=3)
    model.train()
    hoisted = make_adv_train_fn(model, counted, cfg)(pts, labels)
    assert len(plans) == 1 and model.training
    assert all(p.requires_grad for p in model.parameters())
    plans.clear()
    model.eval().requires_grad_(False)
    rebuilt = pgd_color_attack(
        lambda p: family.head(family.apply(model, p, counted.plan(p))), pts, labels, cfg,
        evaluate=False)
    model.train().requires_grad_(True)
    assert len(plans) == cfg.iters
    assert torch.equal(hoisted, rebuilt) and not torch.equal(hoisted, pts)
    assert torch.equal(stats, before)
