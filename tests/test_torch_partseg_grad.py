"""The xyz gradient of the port's part-segmentation nets against the JAX
package, on the CPU (the shapes, weights and helpers of
``test_torch_partseg_models.py``).

The forward that builds its own geometry is the coordinate attacks'
path: its FPS centres and the 3-NN interpolation weights of both planned
hops carry the gradient. In float64 against ``jax.grad`` under
``jax.enable_x64``; in float32 against ``jax.grad`` by relative L2. JAX's
float64 run keeps its BatchNorm and PointNet's STN in float32; the test
swaps in copies of those two modules without the casts (``_jax_float64``),
as the classifiers' test does. Both packages also keep d² in float32
(``_float64_distances`` takes that island out of both).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pointsecguard_tpu.models import common as jcommon
from pointsecguard_tpu.models import pointnet as jpointnet
from pointsecguard_tpu.models import pointnet2_cls as jpointnet2_cls
from pointsecguard_tpu.ops import interpolate as jinterpolate
from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models.pointnet2_cls import moving_geometry
from pointsecguard_tpu_torch.ops import interpolate
from test_torch_partseg_models import (
    _labels,
    _variables,
    jax_variables,
    one_hot,
    port_model,
    shapes,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _margin(lp, labels):
    """The summed log-probability margin of each point's label over the
    next part: its gradient at the logits is +1 and -1, exactly."""
    nxt = (labels + 1) % 50
    if isinstance(lp, torch.Tensor):
        take = lambda y: torch.gather(lp, -1, torch.as_tensor(y)[..., None])
    else:
        take = lambda y: jnp.take_along_axis(lp, jnp.asarray(y)[..., None], -1)
    return (take(labels) - take(nxt)).sum()


@functools.lru_cache(maxsize=None)
def jax_xyz_grad(name):
    """``jax.grad`` of ``_margin`` with respect to the xyz of ``shapes(6)``
    in float32, geometry None, on ``jax_variables(name, seed=5)``."""
    model, flat = jax_variables(name, seed=5)
    variables, oh, labels = _variables(flat), jnp.asarray(one_hot()), _labels()
    grad = jax.jit(jax.grad(lambda p: _margin(model.apply(variables, p, oh)[0], labels)))(
        jnp.asarray(shapes(6)))
    return np.asarray(grad)[..., :3]


class BatchNorm(nn.Module):
    """The JAX package's evaluation-mode BatchNorm in its input's dtype
    (the float32 cast taken out), named as the original."""

    epsilon: float = 1e-5

    @nn.compact
    def __call__(self, x, use_running_average, momentum=0.9):
        features = x.shape[-1]
        mean = self.variable("batch_stats", "mean", jnp.zeros, (features,), x.dtype)
        var = self.variable("batch_stats", "var", jnp.ones, (features,), x.dtype)
        scale = self.param("scale", nn.initializers.ones, (features,))
        bias = self.param("bias", nn.initializers.zeros, (features,))
        assert use_running_average, "evaluation mode only"
        inv = jnp.reciprocal(jnp.sqrt(var.value + self.epsilon))
        return (x - mean.value) * inv * scale + bias


class STN(nn.Module):
    """The JAX package's STN with its alignment matrix left in the input's
    dtype."""

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


@pytest.fixture
def _jax_float64(monkeypatch):
    for module in (jcommon, jpointnet, jpointnet2_cls):
        monkeypatch.setattr(module, "BatchNorm", BatchNorm)
    monkeypatch.setattr(jpointnet, "STN", STN)


def _square_distance64(src, dst):
    """``square_distance`` in its inputs' dtype (either package's array
    type): the same association, no float32 cast."""
    xp = torch if isinstance(src, torch.Tensor) else jnp
    cross = xp.einsum("bnc,bmc->bnm", src, dst)
    return ((src * src).sum(-1)[:, :, None] - 2.0 * cross) + (dst * dst).sum(-1)[:, None, :]


def _float64_distances(monkeypatch):
    """The 3-NN plans of both packages on float64 distances. Both compute
    d² in float32 whatever the input (JAX's einsum takes a float32
    ``preferred_element_type``), and the backward of that float32 island
    rounds otherwise in XLA's simplified program than in autograd."""
    monkeypatch.setattr(jinterpolate, "square_distance", _square_distance64)
    monkeypatch.setattr(interpolate, "square_distance", _square_distance64)


def jax_xyz_grad64(name):
    """``jax.grad`` of ``_margin`` with respect to the xyz of ``shapes(6)``
    in float64 (``jax.enable_x64``, float64 variables), geometry None."""
    model, flat = jax_variables(name, seed=5)
    labels = _labels()
    with jax.enable_x64(True):
        variables = _variables(flat, jnp.float64)
        oh = jnp.asarray(one_hot(), jnp.float64)
        grad = jax.jit(jax.grad(lambda p: _margin(model.apply(variables, p, oh)[0], labels)))(
            jnp.asarray(shapes(6), jnp.float64))
        assert grad.dtype == jnp.float64
        return np.asarray(grad)[..., :3]


def port_xyz_grad(model, pts, geometry_of=None):
    """The port's xyz gradient of ``_margin``; ``geometry_of(xyz leaf)``
    builds the plan the forward takes (None: its own)."""
    p = pts.clone().requires_grad_(True)
    oh = torch.from_numpy(one_hot()).to(pts.dtype)
    geo = None if geometry_of is None else geometry_of(p[..., :3])
    _margin(model(p, oh, geometry=geo)[0] if geo is not None else model(p, oh)[0],
            _labels()).backward()
    return p.grad[..., :3]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# float32 gradient bounds (relative L2): of the port and of JAX from float64,
# and of the two from each other. On these shapes: SSG 6.2e-4 / 6.3e-4 /
# 8.5e-5, MSG 1.2e-3 / 1.0e-3 / 8.1e-4 (the 3-NN weights go as 1 / d², and
# d² = |q|² − 2 q·p + |p|² rounds to ~1e-7 whatever its size; MSG also
# takes maxima over groups of near-tied points, k up to 128 of 256);
# PointNet 4.0e-3 / 7.6e-7 / 4.0e-3, all of it the clipped shape 1, whose
# faces hold exact duplicate points: torch's CPU GEMM rounds duplicate rows
# apart where they fall in different blocks, so a max that splits its
# gradient over the duplicates in float64 (and in XLA's float32) picks one
# (6.3e-3 on that shape, 7e-7 on the others)
_GRAD32 = {"pointnet2_part_seg": (1e-3, 1e-3), "pointnet2_part_seg_msg": (1e-2, 1e-2),
           "pointnet_part_seg": (1e-2, 1e-2)}
# the float64 models as shipped, whose d² and 3-NN weights stay float32 in
# both packages: the backward of that island rounds apart (5.0e-6 SSG,
# 1.1e-5 MSG on these shapes)
_GRAD64_ISLAND = 1e-4


@pytest.mark.parametrize("name", sorted(_GRAD32))
def test_xyz_gradient_matches_jax(name, _jax_float64, monkeypatch):
    """float64: autograd through the moving geometry (centres and 3-NN
    weights) within 1e-10 (relative L2) of ``jax.grad`` of the margin
    loss, with float64 distances on both sides (``_float64_distances``),
    and within ``_GRAD64_ISLAND`` as shipped. float32: the port and
    ``jax.grad`` each within ``_GRAD32`` of float64 and of each other."""
    _, flat = jax_variables(name, seed=5)
    pts = torch.from_numpy(shapes(6))
    net64 = port_model(name, flat, torch.float64)
    got64 = port_xyz_grad(net64, pts.double()).numpy()
    assert _rel_l2(got64, jax_xyz_grad64(name)) <= (
        1e-10 if name == "pointnet_part_seg" else _GRAD64_ISLAND)
    got32 = port_xyz_grad(port_model(name, flat), pts).numpy()
    want32 = jax_xyz_grad(name)
    to64, apart = _GRAD32[name]
    assert _rel_l2(got32, got64) <= to64
    assert _rel_l2(want32, got64) <= to64
    assert _rel_l2(got32, want32) <= apart
    if name != "pointnet_part_seg":
        with monkeypatch.context() as m:
            _float64_distances(m)
            assert _rel_l2(port_xyz_grad(net64, pts.double()).numpy(),
                           jax_xyz_grad64(name)) <= 1e-10


def _detached_weights_geometry(net, xyz):
    """The moving geometry with its centres' gradient but the 3-NN weights
    computed without one."""
    geo = moving_geometry(net.build_sa, xyz)
    l1, l2 = geo["sa"][0][0], geo["sa"][1][0]
    with torch.no_grad():
        fp = (ops.three_nn_plan(l1, l2), ops.three_nn_plan(xyz, l1))
    return {**geo, "fp": fp}


def test_gradient_keeps_the_three_nn_weight_term():
    """Detaching the 3-NN weights (or taking the fixed plan of
    ``build_geometry_partseg``) drops a term of JAX's gradient: in float64
    those gradients are far from the moving-geometry one, which is within
    float32 rounding of JAX's (SSG; MSG's plans are built by the same
    ``with_three_nn``)."""
    name = "pointnet2_part_seg"
    _, flat = jax_variables(name, seed=5)
    net = port_model(name, flat, torch.float64)
    pts = torch.from_numpy(shapes(6)).double()
    moving = port_xyz_grad(net, pts).numpy()
    detached = port_xyz_grad(net, pts, lambda xyz: _detached_weights_geometry(net, xyz)).numpy()
    fixed = port_xyz_grad(net, pts, net.build_geometry).numpy()
    assert _rel_l2(moving, jax_xyz_grad(name)) <= _GRAD32[name][0]
    assert _rel_l2(detached, moving) >= 0.01
    assert _rel_l2(fixed, moving) >= _rel_l2(detached, moving)
