"""The points-sharded kNN, the points-sharded RandLA pyramid and a RandLA
forward + backward under ``--shard_points``, on gloo ranks of the CPU, held
to the port's one-process run and to the JAX package's ``shard_map`` kNN
and pyramid on the virtual CPU mesh of ``tests/conftest.py``.

The ranks run ``pointsecguard_tpu_torch.parallel.dryrun``'s programs, so
that a spawned rank imports torch and the port only; each layout starts
its ranks once, for all its programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.models import build_pyramid as jax_build_pyramid
from pointsecguard_tpu.parallel import knn_points_sharded as jax_knn_points_sharded
from pointsecguard_tpu.parallel import make_mesh as jax_make_mesh
from pointsecguard_tpu.parallel import shard_batch as jax_shard_batch
from pointsecguard_tpu_torch.models import RandLANet, init_parameters
from pointsecguard_tpu_torch.parallel import make_mesh, spawn
from pointsecguard_tpu_torch.parallel import dryrun

# (ranks, points axis): 1×2, 1×4 and 2×2 data × points
LAYOUTS = {"1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}
K = 16
FIELDS = ("neigh_idx", "sub_idx", "interp_idx")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    state_model = RandLANet()
    init_parameters(state_model, torch.Generator().manual_seed(0))
    return {
        "q": rng.rand(2, 256, 3).astype(np.float32),
        "p": rng.rand(2, 512, 3).astype(np.float32),
        "xyz": rng.rand(2, 1024, 3).astype(np.float32),
        "feats": rng.rand(2, 1024, 6).astype(np.float32),
        "labels": rng.randint(0, 13, (2, 1024)),
        "randla": {k: v.numpy() for k, v in state_model.state_dict().items()},
    }


def _calls(inp, data: int):
    """The programs of one layout: the data axis takes ``data`` clouds of
    the pyramid and RandLA inputs (the kNN inputs hold 2)."""
    return [("knn_program", (inp["q"], inp["p"], K), {}),
            ("pyramid_program", (inp["xyz"][:data],), {}),
            ("randla_grad_program", (inp["feats"][:data], inp["labels"][:data],
                                     inp["randla"]), {}),
            ("knn_errors_program", (), {})]


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout(request, inputs):
    n, points = LAYOUTS[request.param]
    data = n // points
    ranks = spawn(dryrun.programs, make_mesh(["cpu"] * n, points_axis=points),
                  (_calls(inputs, data),))
    one = dryrun.programs(None, _calls(inputs, data)[:3])
    return {"name": request.param, "n": n, "points": points, "data": data,
            "ranks": ranks, "one": one}


def _assemble(layout, part: int, what: int) -> np.ndarray:
    """The whole batch's kNN output ``what`` (0 dists, 1 idx) from the
    ranks' parts: rank d·P + p holds data slice d's query shard p."""
    P, D = layout["points"], layout["data"]
    rows = [np.concatenate([layout["ranks"][d * P + p][part][what] for p in range(P)],
                           axis=1) for d in range(D)]
    return np.concatenate(rows, axis=0)


def _jax_mesh(layout):
    return jax_make_mesh(jax.devices()[: layout["n"]], points_axis=layout["points"])


def test_knn_points_sharded_equals_ops_knn_and_jax(layout, inputs):
    dist, idx = _assemble(layout, 0, 0), _assemble(layout, 0, 1)
    want_d, want_i = layout["one"][0][:2]
    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_allclose(dist, want_d, atol=1e-5)
    mesh = _jax_mesh(layout)
    qs, ps = jax_shard_batch(mesh, (jnp.asarray(inputs["q"]), jnp.asarray(inputs["p"])),
                             shard_points=True)
    jd, ji = jax.jit(lambda a, b: jax_knn_points_sharded(a, b, K, mesh=mesh))(qs, ps)
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_allclose(dist, np.asarray(jd), atol=1e-5)
    # every rank's shard: [B / data, S / points, k] with global indices
    B, S = inputs["q"].shape[:2]
    for r in layout["ranks"]:
        assert r[0][1].shape == (B // layout["data"], S // layout["points"], K)


def test_knn_points_sharded_refusals(layout):
    for r in layout["ranks"]:
        divide, too_many = r[3]
        assert "do not divide" in divide and too_many == "k=128 > N=64"


def test_sp_pyramid_bit_identical_to_unsharded_and_jax(layout, inputs):
    """Every level's tables, whole on every rank of a points group, equal to
    the unsharded pyramid of its data slice — including the deep levels
    that fall back to the plain op when their sizes stop dividing the
    points axis (1×4: the last upsample, 4 queries over 2 points) — and to
    JAX's ``build_pyramid(sp_mesh=...)``."""
    D = layout["data"]
    one = layout["one"][1]
    mesh = _jax_mesh(layout)
    xyz = jnp.asarray(inputs["xyz"][:D])
    jpyr = jax.jit(lambda x: jax_build_pyramid(x, sp_mesh=mesh))(
        jax_shard_batch(mesh, xyz, shard_points=True))
    for r, got in enumerate(layout["ranks"]):
        d = r // layout["points"]
        for f in FIELDS:
            for lvl, want in enumerate(one[f]):
                np.testing.assert_array_equal(got[1][f][lvl], want[d : d + 1],
                                              err_msg=f"{f} level {lvl}, rank {r}")
                np.testing.assert_array_equal(got[1][f][lvl],
                                              np.asarray(jpyr[f][lvl])[d : d + 1],
                                              err_msg=f"{f} level {lvl}, rank {r} vs JAX")


def test_randla_forward_backward_under_sp_equals_unsharded(layout):
    """The loss of the whole batch and its gradient on the features, with
    the points axis sharded (``points_sharded_forward``): rtol 1e-6 and
    atol 1e-5, ``tests/test_parallel.py``'s tolerances. The xyz gradient
    through a point's zero distance to itself is NaN on both sides."""
    loss, grad = layout["one"][2]
    assert np.isfinite(loss) and np.isfinite(grad[..., 3:]).all()
    for r in layout["ranks"]:
        np.testing.assert_allclose(r[2][0], loss, rtol=1e-6)
        np.testing.assert_allclose(r[2][1], grad, atol=1e-5)
