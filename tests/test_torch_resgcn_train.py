"""Parity of the port's ResGCN-28 training parts with the JAX package, on
the CPU: ``resgcn_lr``, the config's fields, the plain mean cross-entropy,
and one optimizer step of a narrow DenseDeepGCN (5 blocks, 16 filters,
k = 16, batch 2 × 256 points) from JAX-initialised weights against
``pointsecguard_tpu.train.make_train_step`` with weight decay 0, as the
JAX ResGCN loop builds it.

Both steps run on the same train-mode graphs, the JAX model's own,
pinned through ``graphs=`` (a flax subclass passes them to the JAX step):
each graph depends on float32 features that round differently in XLA and
torch, and one near-tie would cascade into later blocks. The graphs
themselves, in evaluation and in training mode, are held against JAX in
``tests/test_torch_resgcn.py``. The JAX step does not return its
gradient; after one step without weight decay Adam's first moment is
0.1 · g, so g is read from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu.models import DenseDeepGCN as JaxDenseDeepGCN
from pointsecguard_tpu.train import schedules as jax_schedules
from pointsecguard_tpu.train.trainer import TrainState as JaxTrainState
from pointsecguard_tpu.train.trainer import make_optimizer as jax_make_optimizer
from pointsecguard_tpu.train.trainer import make_train_step as jax_make_train_step
from pointsecguard_tpu_torch.configs import ResgcnConfig
from pointsecguard_tpu_torch.models import DenseDeepGCN
from pointsecguard_tpu_torch.models.resgcn import ce_loss
from pointsecguard_tpu_torch.train import schedules
from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step, resgcn_family
from pointsecguard_tpu_torch.utils.convert import (
    resgcn_from_jax_variables,
    resgcn_to_jax_variables,
)

SMALL = dict(n_blocks=5, n_filters=16, k=16)
B, P = 2, 256
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("epoch", [0, 1, 19, 20, 45, 99])
def test_resgcn_lr_equals_jax(epoch):
    assert schedules.resgcn_lr(epoch) == jax_schedules.resgcn_lr(epoch) == 1e-3
    for kw in (dict(enabled=True), dict(base=3e-3, decay=0.9, adjust_freq=7, enabled=True)):
        assert schedules.resgcn_lr(epoch, **kw) == jax_schedules.resgcn_lr(epoch, **kw)


def test_config_fields_equal_jax():
    from pointsecguard_tpu.configs import ResgcnConfig as JaxResgcnConfig

    jax_cfg = vars(JaxResgcnConfig())
    for key, value in vars(ResgcnConfig()).items():
        assert jax_cfg[key] == value, key


def test_overrides_equal_jax():
    import argparse

    from pointsecguard_tpu.configs import resgcn_overrides as jax_overrides
    from pointsecguard_tpu_torch.configs import resgcn_overrides

    for ns in (dict(), dict(resgcn_blocks=7, resgcn_k=8, resgcn_filters=32,
                            resgcn_block_type="dense", resgcn_conv="mr", resgcn_epsilon=0.2)):
        args = argparse.Namespace(**ns)
        assert resgcn_overrides(args) == jax_overrides(args)


def _jax_ce(logits, labels, _):
    """The JAX ResGCN loop's loss (`pointsecguard_tpu/train/loops.py:513-515`)."""
    lp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(lp, labels[..., None], axis=-1))


def test_ce_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 500, 13))).astype(np.float32)
    labels = rng.integers(0, 13, (3, 500))
    want = float(_jax_ce(jnp.asarray(logits), jnp.asarray(labels), None))
    got = ce_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


class _PinnedGCN(JaxDenseDeepGCN):
    """The JAX model on fixed graphs, in the call signature
    ``make_train_step`` uses."""

    pinned: tuple = ()

    def __call__(self, points, *, train=False, momentum=None):
        return super().__call__(points, train=train, momentum=momentum,
                                graphs=tuple(jnp.asarray(g) for g in self.pinned))


def _flat(tree, top):
    return {k: np.asarray(v) for k, v in flatten_dict({top: tree}, sep="/").items()}


@pytest.fixture(scope="module")
def jax_step():
    rng = np.random.default_rng(4)
    pts = rng.random((B, P, 9)).astype(np.float32)
    labels = rng.integers(0, 13, (B, P)).astype(np.int32)
    model = JaxDenseDeepGCN(**SMALL)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(pts))
    # the train-mode graphs of the JAX model
    (_, graphs), _ = model.apply(variables, jnp.asarray(pts), train=True, collect_graphs=True,
                                 mutable=["batch_stats"])
    graphs = tuple(np.asarray(g) for g in graphs)
    before = {**_flat(variables["params"], "params"),
              **_flat(variables["batch_stats"], "batch_stats")}
    tx = jax_make_optimizer(weight_decay=0.0)
    state = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(_PinnedGCN(**SMALL, pinned=graphs), tx, _jax_ce,
                               output_head=lambda out: out)
    # the loop's bn_momentum 0.1, which the model drops
    new, loss, _ = step(state, jnp.asarray(pts), jnp.asarray(labels), jnp.ones(13), LR, 0.1,
                        jax.random.PRNGKey(5))
    mu = _flat(new.opt_state[1].mu, "params")
    return {"pts": pts, "labels": labels, "graphs": graphs, "before": before,
            "loss": float(loss), "grads": {k: v / 0.1 for k, v in mu.items()}, "mu": mu,
            "nu": _flat(new.opt_state[1].nu, "params"),
            "params": _flat(new.params, "params"),
            "stats": _flat(new.batch_stats, "batch_stats")}


@pytest.fixture(scope="module")
def port_step(jax_step):
    model = DenseDeepGCN(**SMALL)
    model.load_state_dict(resgcn_from_jax_variables(jax_step["before"]))
    state = TrainState(model)
    step = make_train_step(model, ce_loss, weight_decay=0.0, family=resgcn_family())
    loss = step(state, torch.from_numpy(jax_step["pts"]),
                torch.from_numpy(jax_step["labels"]).long(), torch.ones(13), LR, 0.1,
                geometry=tuple(torch.from_numpy(g) for g in jax_step["graphs"]))

    def split(flat):
        out, offset = {}, 0
        for k, p in model.named_parameters():
            out[k] = flat[offset : offset + p.numel()].view_as(p)
            offset += p.numel()
        return resgcn_to_jax_variables(out)

    sd = model.state_dict()
    return {"loss": loss.item(), "grads": split(state.grads), "mu": split(state.mu),
            "nu": split(state.nu), "state": state,
            "params": resgcn_to_jax_variables(
                {k: v for k, v in sd.items() if not k.endswith((".mean", ".var"))}),
            "stats": resgcn_to_jax_variables(
                {k: v for k, v in sd.items() if k.endswith((".mean", ".var"))})}


@pytest.fixture(scope="module")
def float64_grads(jax_step):
    """Loss and gradients of the same step in float64: the port's model in
    double precision on the same graphs."""
    model = DenseDeepGCN(**SMALL)
    model.load_state_dict(resgcn_from_jax_variables(jax_step["before"]))
    model = model.double().train()
    x = torch.from_numpy(jax_step["pts"]).double()
    graphs = tuple(torch.from_numpy(g) for g in jax_step["graphs"])
    feats = [model.head(x, graphs[0])]  # the forward, without its float32 cast
    for i, blk in enumerate(model.backbone):
        feats.append(blk(feats[-1], graphs[1 + i])[0] + feats[-1])
    h = torch.cat(feats, dim=-1)
    fusion = torch.amax(model.fusion(h), dim=1, keepdim=True).expand(-1, h.shape[1], -1)
    logits = model.cls(model.pred[1](model.pred[0](torch.cat([fusion, h], dim=-1))))
    lp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(lp, -1, torch.from_numpy(jax_step["labels"]).long()[..., None]).mean()
    loss.backward()
    return loss.item(), resgcn_to_jax_variables(
        {k: p.grad for k, p in model.named_parameters()})


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _whole(g):
    return np.concatenate([g[p].ravel() for p in sorted(g)])


def test_step_loss_matches_jax(jax_step, port_step, float64_grads):
    """The port within 1e-6 of the float64 loss, and within 1e-5 of JAX's
    (which sits 1.7e-6 from float64 at this seed)."""
    assert port_step["loss"] == pytest.approx(float64_grads[0], rel=1e-6)
    assert port_step["loss"] == pytest.approx(jax_step["loss"], rel=1e-5)


def test_step_gradients_match_jax(jax_step, port_step, float64_grads):
    """Per leaf in relative L2: the port within 1e-3 of JAX's gradient and
    no further from float64 than twice JAX's distance (plus 1e-5); the
    whole vector within 5e-4 of JAX's. Both float32 gradients sit up to
    4e-2 from float64 in the first blocks (a maximum over neighbours
    picks another of two nearly equal entries in double precision), so
    the port is judged against JAX's distance. BasicConv puts the
    activation between its Linear and its BatchNorm: no bias has a true
    gradient of 0 here."""
    _, g64 = float64_grads
    assert set(port_step["grads"]) == set(jax_step["grads"]) == set(g64)
    assert len(g64) == 8 * 4 + 2  # 5 graph convs and 3 BasicConvs with a BatchNorm, cls
    for path, want in jax_step["grads"].items():
        got = port_step["grads"][path]
        assert _rel_l2(got, want) < 1e-3, path
        assert _rel_l2(got, g64[path]) < 2 * _rel_l2(want, g64[path]) + 1e-5, path
    assert _rel_l2(_whole(port_step["grads"]), _whole(jax_step["grads"])) < 5e-4


def test_step_adam_moments_and_statistics_match_jax(jax_step, port_step):
    """Adam's moments (the first 5e-4 from JAX's in relative L2 like the
    gradient, the second 1e-3), and the BatchNorm running statistics at
    the fixed keep 0.9 (the trainer's momentum is not read), moved and
    within 1e-4 relative (1e-5 absolute) of JAX's: they are moments of
    features that five blocks of float32 sums put ~1e-5 apart."""
    assert _rel_l2(_whole(port_step["mu"]), _whole(jax_step["mu"])) < 5e-4
    assert _rel_l2(_whole(port_step["nu"]), _whole(jax_step["nu"])) < 1e-3
    assert port_step["state"].count.item() == 1 and port_step["state"].step == 1
    assert set(port_step["stats"]) == set(jax_step["stats"])
    for path, want in jax_step["stats"].items():
        np.testing.assert_allclose(port_step["stats"][path], want, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
        assert not np.array_equal(want, jax_step["before"][path])


def test_whole_step_matches_jax_where_the_gradient_is_clear_of_noise(jax_step, port_step):
    """The first Adam update is lr · g / (|g| + ε), ±lr wherever |g| is
    clear of the noise (a fifth of the leaf's largest entry)."""
    compared = 0
    for path, want in jax_step["params"].items():
        g = jax_step["grads"][path]
        clear = np.abs(g) > 0.2 * np.abs(g).max()
        compared += int(clear.sum())
        np.testing.assert_allclose(port_step["params"][path][clear], want[clear],
                                   rtol=0, atol=1e-7, err_msg=path)
        moved = np.abs(port_step["params"][path] - jax_step["before"][path])[clear]
        np.testing.assert_allclose(moved, LR, rtol=1e-3)
    assert compared > 500
