"""The data-parallel train step of the port (``make_train_step(ctx=...)``)
on two gloo ranks of the CPU, and the points-sharded one on a 1×2 layout,
held to the one-process step and to the JAX package's step on a 2-device
mesh of the virtual CPU mesh (``tests/conftest.py``): PointNet++ SSG
(weighted NLL, FPS from index 0, JAX's dropout mask) and a narrow ResGCN
(plain CE on JAX's graphs, pinned), from JAX-initialised weights.

What is held, and why so:

- against one process: the loss within rtol 1e-6 and the BatchNorm
  statistics within 1e-5 in float32; the gradient within atol 1e-5 in
  float64. In float32 the random-initialised train-mode networks turn the
  ranks' other summation order into gradients up to a few per cent apart
  (their BatchNorms divide by batch deviations; ``tests/test_torch_train.py``
  measures the same sensitivity between JAX and the port); in float64 the
  two runs agree to 1e-12, so a fault in the collectives would show there.
- across ranks: the parameters after the step, bit for bit.
- against JAX's sharded step: the loss and statistics within the
  tolerances of ``tests/test_torch_train.py`` and
  ``tests/test_torch_resgcn_train.py`` (the port against JAX on one device).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu.models import DenseDeepGCN as JaxDenseDeepGCN
from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxSSG
from pointsecguard_tpu.models import weighted_nll_loss as jax_weighted_nll_loss
from pointsecguard_tpu.parallel import make_mesh as jax_make_mesh
from pointsecguard_tpu.parallel import shard_batch as jax_shard_batch
from pointsecguard_tpu_torch.models import DenseDeepGCN, PointNet2SemSegSSG
from pointsecguard_tpu_torch.parallel import make_mesh, spawn
from pointsecguard_tpu_torch.parallel import dryrun
from pointsecguard_tpu_torch.utils.convert import (
    from_jax_variables,
    resgcn_from_jax_variables,
    resgcn_to_jax_variables,
    to_jax_variables,
)

B, P_SSG, P_GCN = 2, 512, 256
GCN = dict(n_blocks=5, n_filters=16, k=16)
LR = 1e-3


def _sampler_rooms():
    from pointsecguard_tpu_torch.data.synthetic import make_room

    rooms = [make_room(512, rng=np.random.default_rng(s)) for s in (1, 2)]
    return [r[:, :6] for r in rooms], [r[:, 6].astype(np.int64) for r in rooms]


SAMPLER_ROOMS = _sampler_rooms()


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree, top):
    return {k: np.asarray(v) for k, v in flatten_dict({top: tree}, sep="/").items()}


def _jax_mesh():
    return jax_make_mesh(jax.devices()[:2])


@pytest.fixture(scope="module")
def ssg():
    """JAX's SSG step on a 2-device mesh, from its parts (no ``sample``
    rng: FPS from index 0): loss, new statistics and the dropout mask."""
    rng = np.random.default_rng(0)
    pts = rng.random((B, P_SSG, 9)).astype(np.float32)
    labels = rng.integers(0, 13, (B, P_SSG))
    weights = (0.5 + rng.random(13)).astype(np.float32)
    model = JaxSSG()
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(pts))
    mesh = _jax_mesh()
    pts_s, labels_s = jax_shard_batch(mesh, (jnp.asarray(pts), jnp.asarray(labels)))

    def compute(params, p, y):
        (logp, _), mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, p, train=True,
            momentum=0.9, rngs={"dropout": jax.random.PRNGKey(5)},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
        loss = jax_weighted_nll_loss(logp, y, jnp.asarray(weights))
        return loss, (mutated["batch_stats"], mutated["intermediates"]["Dropout_0"]["__call__"][0])

    with mesh:
        loss, (stats, dropped) = jax.jit(compute)(variables["params"], pts_s, labels_s)
    state = from_jax_variables({**_flat(variables["params"], "params"),
                                **_flat(variables["batch_stats"], "batch_stats")})
    return {"pts": pts, "labels": labels, "weights": weights, "loss": float(loss),
            "stats": _flat(stats, "batch_stats"), "mask": np.asarray(dropped) != 0,
            "state": {k: v.numpy() for k, v in state.items()}}


class _PinnedGCN(JaxDenseDeepGCN):
    pinned: tuple = ()

    def __call__(self, points, *, train=False, momentum=None):
        return super().__call__(points, train=train, momentum=momentum,
                                graphs=tuple(jnp.asarray(g) for g in self.pinned))


@pytest.fixture(scope="module")
def gcn():
    """JAX's narrow ResGCN step on a 2-device mesh on its own train-mode
    graphs, pinned: loss, gradient (Adam's first moment / 0.1) and new
    statistics."""
    from pointsecguard_tpu.train.trainer import TrainState as JaxTrainState
    from pointsecguard_tpu.train.trainer import make_optimizer, make_train_step

    rng = np.random.default_rng(4)
    pts = rng.random((B, P_GCN, 9)).astype(np.float32)
    labels = rng.integers(0, 13, (B, P_GCN)).astype(np.int32)
    model = JaxDenseDeepGCN(**GCN)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(pts))
    (_, graphs), _ = model.apply(variables, jnp.asarray(pts), train=True,
                                 collect_graphs=True, mutable=["batch_stats"])
    graphs = tuple(np.asarray(g) for g in graphs)
    before = {**_flat(variables["params"], "params"),
              **_flat(variables["batch_stats"], "batch_stats")}
    tx = make_optimizer(weight_decay=0.0)
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))

    def ce(logits, y, _):
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, y[..., None], axis=-1))

    step = make_train_step(_PinnedGCN(**GCN, pinned=graphs), tx, ce,
                           output_head=lambda out: out)
    mesh = _jax_mesh()
    with mesh:
        pts_s, labels_s = jax_shard_batch(mesh, (jnp.asarray(pts), jnp.asarray(labels)))
        new, loss, _ = step(jstate, pts_s, labels_s, jnp.ones(13), LR, 0.1,
                            jax.random.PRNGKey(5))
    state = resgcn_from_jax_variables(before)
    return {"pts": pts, "labels": labels, "graphs": graphs, "loss": float(loss),
            "grads": {k: v / 0.1 for k, v in _flat(new.opt_state[1].mu, "params").items()},
            "stats": _flat(new.batch_stats, "batch_stats"),
            "state": {k: v.numpy() for k, v in state.items()}}


def _calls(ssg, gcn):
    ones = np.ones(13, np.float32)
    ssg_args = (ssg["pts"], ssg["labels"], ssg["weights"], ssg["state"])
    ssg_kw = dict(lr=LR, seed=None, dropout_mask=ssg["mask"])
    gcn_args = (gcn["pts"], gcn["labels"].astype(np.int64), ones, gcn["state"])
    gcn_kw = dict(lr=LR, graphs=gcn["graphs"], model_kw=GCN)
    return [("train_step_program", ("pointnet2", *ssg_args), {**ssg_kw, "dtype": dt})
            for dt in ("float32", "float64")] + \
           [("train_step_program", ("resgcn", *gcn_args), {**gcn_kw, "dtype": dt})
            for dt in ("float32", "float64")] + \
           [("sampler_program", (*SAMPLER_ROOMS, ssg["state"], 4), {})]


@pytest.fixture(scope="module")
def runs(ssg, gcn):
    calls = _calls(ssg, gcn)
    return {"one": dryrun.programs(None, calls),
            "dp": spawn(dryrun.programs, make_mesh(["cpu"] * 2), (calls,)),
            "sp": spawn(dryrun.programs, make_mesh(["cpu"] * 2, points_axis=2), (calls,))}


NAMES = ["ssg float32", "ssg float64", "resgcn float32", "resgcn float64"]


@pytest.mark.parametrize("layout", ["dp", "sp"])
@pytest.mark.parametrize("case", range(4), ids=NAMES)
def test_step_equals_one_process(runs, layout, case):
    loss, grads, params, stats = runs["one"][case]
    for rank, res in enumerate(runs[layout]):
        r_loss, r_grads, r_params, r_stats = res[case]
        np.testing.assert_allclose(r_loss, loss, rtol=1e-6, err_msg=f"rank {rank}")
        np.testing.assert_allclose(r_stats, stats, rtol=1e-5, atol=1e-5, err_msg=f"rank {rank}")
        if NAMES[case].endswith("float64"):
            np.testing.assert_allclose(r_grads, grads, atol=1e-5, err_msg=f"rank {rank}")
        # one update, the same on every rank
        np.testing.assert_array_equal(r_params, runs[layout][0][case][2])
        np.testing.assert_array_equal(r_grads, runs[layout][0][case][1])


def test_device_sampler_steps_equal_one_process(runs):
    """Two ``--device_sampler`` steps of 4 blocks (float64), every rank of
    either layout a rank of the data axis over all of them
    (``parallel.mesh.flat_view``): each draws the global batch and keeps
    its rows. Losses within rtol 1e-6, parameters equal across ranks."""
    losses, _ = runs["one"][4]
    for layout in ("dp", "sp"):
        for res in runs[layout]:
            np.testing.assert_allclose(res[4][0], losses, rtol=1e-6)
            np.testing.assert_array_equal(res[4][1], runs[layout][0][4][1])


def _stats_by_name(model, flat: np.ndarray, to_jax) -> dict:
    out, offset = {}, 0
    for name, buf in model.named_buffers():
        out[name] = torch.from_numpy(flat[offset : offset + buf.numel()]).view_as(buf)
        offset += buf.numel()
    return to_jax(out)


def _params_by_name(model, flat: np.ndarray, to_jax) -> dict:
    out, offset = {}, 0
    for name, p in model.named_parameters():
        out[name] = torch.from_numpy(flat[offset : offset + p.numel()]).view_as(p)
        offset += p.numel()
    return to_jax(out)


@pytest.mark.parametrize("layout", ["dp", "sp"])
def test_ssg_step_matches_jax_on_two_devices(runs, ssg, layout):
    """Loss within 2e-5 and statistics within rtol 2e-3 / atol 2e-4 of
    JAX's step on a 2-device mesh (``tests/test_torch_train.py``)."""
    loss, _, _, stats = runs[layout][0][0]
    assert float(loss[0]) == pytest.approx(ssg["loss"], rel=2e-5)
    got = _stats_by_name(PointNet2SemSegSSG(), stats, to_jax_variables)
    assert set(got) == set(ssg["stats"])
    for path, want in ssg["stats"].items():
        np.testing.assert_allclose(got[path], want, rtol=2e-3, atol=2e-4, err_msg=path)


@pytest.mark.parametrize("layout", ["dp", "sp"])
def test_resgcn_step_matches_jax_on_two_devices(runs, gcn, layout):
    """Loss within 1e-5, gradient within 5e-4 (relative L2 over all leaves)
    and statistics within rtol 1e-4 / atol 1e-5 of JAX's step on a
    2-device mesh (``tests/test_torch_resgcn_train.py``)."""
    loss, grads, _, stats = runs[layout][0][2]
    assert float(loss[0]) == pytest.approx(gcn["loss"], rel=1e-5)
    model = DenseDeepGCN(**GCN)
    got = _params_by_name(model, grads, resgcn_to_jax_variables)
    keys = sorted(gcn["grads"])
    assert set(got) == set(keys)
    whole = lambda g: np.concatenate([g[k].ravel() for k in keys])
    rel = np.linalg.norm(whole(got) - whole(gcn["grads"])) / np.linalg.norm(whole(gcn["grads"]))
    assert rel < 5e-4
    got = _stats_by_name(model, stats, resgcn_to_jax_variables)
    for path, want in gcn["stats"].items():
        np.testing.assert_allclose(got[path], want, rtol=1e-4, atol=1e-5, err_msg=path)
