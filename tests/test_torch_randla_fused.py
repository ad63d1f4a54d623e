"""The port's RandLA-Net with ``ap_impl="fused"`` against the JAX package's
``ap_impl="fused_interpret"`` (its Pallas kernel run by the interpreter),
on the CPU, at the default widths and 512 points with the JAX-initialised
weights carried across (as ``tests/test_models.py`` holds the JAX fused
model against its reference).

Tolerances are the JAX package's own for fused vs reference: logits at
atol 2e-6, colour gradients at 1e-8 + 1e-4·max|g|. The port runs the
fused layers' plain version (CPU tensors).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu.models import RandLANet as JaxRandLANet
from pointsecguard_tpu.models import build_pyramid as jax_build_pyramid
from pointsecguard_tpu_torch.models import RandLANet, build_pyramid
from pointsecguard_tpu_torch.utils.convert import randla_from_jax_variables

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
def case():
    """Weights at PRNGKey(7), the fixture cloud, labels from a seed, and
    the JAX fused model's logits and colour gradient (one interpreted
    program)."""
    fix = np.load(FIXTURE)
    xyz, feats = fix["randla_xyz"], fix["randla_feats"]
    labels = np.random.default_rng(0).integers(0, 13, (1, 512)).astype(np.int32)
    jpyr = jax.jit(lambda x: jax_build_pyramid(x, knn_tile=None))(jnp.asarray(xyz))
    variables = jax.jit(JaxRandLANet().init)(jax.random.PRNGKey(7), jnp.asarray(feats), jpyr)
    fused = JaxRandLANet(ap_impl="fused_interpret")

    def loss(colors):
        f = jnp.asarray(feats).at[..., 3:6].set(colors)
        logits = fused.apply(variables, f, jpyr)
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(labels)[..., None], -1)), logits

    (_, logits), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(feats[..., 3:6]))
    flat = {k: np.asarray(x) for k, x in flatten_dict(variables, sep="/").items()}
    return xyz, feats, labels, flat, np.asarray(logits), np.asarray(grad)


def _port(flat, ap_impl):
    model = RandLANet(ap_impl=ap_impl)
    model.load_state_dict(randla_from_jax_variables(flat))
    return model.eval().requires_grad_(False)


def _plan(model, feats, pyr, use_plan):
    if not use_plan:
        return None
    with torch.no_grad():
        return model(feats, pyr, collect_pos=True)[1]


@pytest.mark.parametrize("use_plan", [False, True])
def test_fused_logits_match_jax_fused(case, use_plan):
    xyz, feats, _, flat, want, _ = case
    model = _port(flat, "fused")
    f, pyr = torch.from_numpy(feats), build_pyramid(torch.from_numpy(xyz))
    plan = _plan(model, f, pyr, use_plan)
    with torch.no_grad():
        got = model(f, pyr, pos_plan=plan)
    assert got.shape == (1, 512, 13)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("use_plan", [False, True])
def test_fused_colour_gradient_matches_jax_fused(case, use_plan):
    xyz, feats, labels, flat, _, want = case
    model = _port(flat, "fused")
    f, pyr = torch.from_numpy(feats), build_pyramid(torch.from_numpy(xyz))
    plan = _plan(model, f, pyr, use_plan)
    colors = f[..., 3:6].clone().requires_grad_(True)
    logits = model(torch.cat([f[..., :3], colors], dim=-1), pyr, pos_plan=plan)
    lp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(lp, -1, torch.from_numpy(labels).long()[..., None]).mean()
    (got,) = torch.autograd.grad(loss, colors)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-8 + 1e-4 * np.abs(want).max())


def test_fused_model_takes_the_reference_state_dict(case):
    """Same parameters either way: the converted JAX tree loads into both,
    and the fused logits stay within reassociation of the reference's, on
    a batch of two clouds (the fixture's and its points shuffled), with
    and without the position plan."""
    _, feats, _, flat, _, _ = case
    fused, ref = _port(flat, "fused"), _port(flat, "reference")
    assert fused.state_dict().keys() == ref.state_dict().keys()
    perm = np.random.default_rng(1).permutation(feats.shape[1])
    f = torch.from_numpy(np.concatenate([feats, feats[:, perm]]))
    pyr = build_pyramid(f[..., :3])
    with torch.no_grad():
        want = ref(f, pyr)
        for plan in (None, fused(f, pyr, collect_pos=True)[1]):
            np.testing.assert_allclose(fused(f, pyr, pos_plan=plan).numpy(), want.numpy(),
                                       atol=2e-6)


def test_fused_layers_and_their_position_plan(case):
    """At the S3DIS widths layers 0 and 1 are fused (2·d_in and d_out
    below 128), as in the JAX package; their plan is k-major."""
    xyz, feats, _, flat, _, _ = case
    model = _port(flat, "fused")
    K = 16
    assert [b.lfa.fused(K) for b in model.blocks] == [True, True, False, False, False]
    f, pyr = torch.from_numpy(feats), build_pyramid(torch.from_numpy(xyz))
    plan = _plan(model, f, pyr, True)
    for level, (d_in, d_out) in enumerate([(8, 16), (32, 64)]):
        fx1, fx2, kidx = plan[level]
        M = pyr["xyz"][level].shape[1]
        assert fx1.shape == (K, M, d_in) and fx2.shape == (K, M, d_out // 2)
        assert kidx.shape == (1, K, M)
        np.testing.assert_array_equal(
            kidx[0].t().numpy(), pyr["neigh_idx"][level][0].numpy())
    assert len(plan[2]) == 2  # a reference layer keeps (f_xyz1, f_xyz2)
