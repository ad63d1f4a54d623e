"""Parity of the port's classifiers (PointNet++ SSG and MSG, PointNet) with
the JAX package, on the CPU.

The same numpy shapes and the same weights (flax variables, BatchNorm
statistics made non-trivial, carried through ``utils/convert.py``) go
through both packages: log-probabilities to 1e-4 in float32, the FPS
centres and ball-query groups of both geometry builders exactly,
``sample_and_group_all`` exactly, and the xyz gradient of the forward that
builds its own geometry (the coordinate attacks' path): in float32
against ``jax.grad`` by relative L2; in float64 against the chain rule
written out by hand (the gradient with the centres as inputs of their own,
plus the centres' gradient carried back along the FPS indices) and against
``jax.grad`` under ``jax.enable_x64``. JAX's float64 run keeps two float32
islands: its BatchNorm computes in float32 whatever its input (the guard of
its bfloat16 statistics), and PointNet's STN casts its alignment matrix to
float32. For the float64 comparison the test swaps in copies of those two
modules without the casts (``_jax_float64``). Both packages take the head's
logits to float32 before the log-softmax; the float64 loss is a logit margin,
whose gradient at the logits is exactly ±1 in float32, so everything else
stays float64 on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict

from pointsecguard_tpu import ops as jops
from pointsecguard_tpu.models import common as jcommon
from pointsecguard_tpu.models import pointnet as jpointnet
from pointsecguard_tpu.models import pointnet2_cls as jpointnet2_cls
from pointsecguard_tpu.models import PointNet2ClsMSG as JaxMSG
from pointsecguard_tpu.models import PointNet2ClsSSG as JaxSSG
from pointsecguard_tpu.models import PointNetCls as JaxPointNetCls
from pointsecguard_tpu.models.pointnet2_cls import build_geometry_cls as jax_geometry_ssg
from pointsecguard_tpu.models.pointnet2_cls import build_geometry_cls_msg as jax_geometry_msg
from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models import build_geometry_cls, build_geometry_cls_msg
from pointsecguard_tpu_torch.utils.convert import cls_from_jax_variables, cls_to_jax_variables

K, B, N = 4, 4, 256
_JAX = {"pointnet2_cls": JaxSSG, "pointnet2_cls_msg": JaxMSG, "pointnet_cls": JaxPointNetCls}
_LEAVES = {"pointnet2_cls": 68, "pointnet2_cls_msg": 140, "pointnet_cls": 96}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def shapes(seed=0, b=B, n=N, normals=True):
    """[b, n, 6] unit-sphere shapes (an ellipsoid shell, a box and noise)
    with unit normals, float32."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    xyz = v * rng.uniform(0.5, 1.0, (b, 1, 3))
    xyz[1] = np.clip(xyz[1] * 1.6, -0.6, 0.6)
    xyz[-1] = rng.uniform(-0.7, 0.7, (n, 3))
    nrm = rng.normal(size=(b, n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pts = np.concatenate([xyz, nrm], -1) if normals else xyz
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_variables(name, seed=0, normals=True):
    """Flat flax variables with BatchNorm statistics drawn away from 0 / 1,
    so that the network's evaluation mode is not the identity's."""
    model = _JAX[name](num_classes=K, normal_channel=normals)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(shapes(seed, normals=normals)))
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    rng = np.random.default_rng(seed + 1)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return model, flat


def jax_apply(model, flat, pts):
    from flax.traverse_util import unflatten_dict

    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return model.apply(variables, pts)


def port_model(name, flat, dtype=torch.float32):
    from pointsecguard_tpu_torch.utils.convert import _cls_model

    model = _cls_model(name, flat)
    model.load_state_dict(cls_from_jax_variables(name, flat))
    return model.to(dtype).eval()


@pytest.mark.parametrize("name", sorted(_JAX))
def test_flax_map_round_trip(name):
    """Every leaf maps (params and BatchNorm statistics), and back."""
    _, flat = jax_variables(name)
    assert len(flat) == _LEAVES[name]
    sd = cls_from_jax_variables(name, flat)
    back = cls_to_jax_variables(name, sd)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("normals", [True, False], ids=["normals", "xyz"])
@pytest.mark.parametrize("name", sorted(_JAX))
def test_log_probs_match_jax(name, normals):
    model, flat = jax_variables(name, normals=normals)
    pts = shapes(1, normals=normals)
    want, _ = jax_apply(model, flat, jnp.asarray(pts))
    got, _ = port_model(name, flat)(torch.from_numpy(pts))
    assert got.shape == (B, K)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,jax_fn,port_fn", [
    ("ssg", jax_geometry_ssg, build_geometry_cls),
    ("msg", jax_geometry_msg, build_geometry_cls_msg)])
def test_geometry_indices_equal(name, jax_fn, port_fn):
    """FPS centres and every ball-query group, exactly (N = 256 < 512
    centres: FPS wraps, as it does on clouds smaller than the level)."""
    xyz = np.concatenate([shapes(2)[..., :3], shapes(3, n=N)[..., :3]])
    want = jax_fn(jnp.asarray(xyz))["sa"]
    got = port_fn(torch.from_numpy(xyz))["sa"]
    for (jc, jidx), (pc, pidx) in zip(want, got):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        jidx = jidx if isinstance(jidx, tuple) else (jidx,)
        pidx = pidx if isinstance(pidx, tuple) else (pidx,)
        assert len(jidx) == len(pidx)
        for a, b in zip(jidx, pidx):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("with_feats", [True, False])
def test_sample_and_group_all_exact(with_feats):
    pts = shapes(4)
    feats = pts[..., 3:] if with_feats else None
    jx, jg = jops.sample_and_group_all(jnp.asarray(pts[..., :3]),
                                       None if feats is None else jnp.asarray(feats))
    px, pg = ops.sample_and_group_all(torch.from_numpy(pts[..., :3]),
                                      None if feats is None else torch.from_numpy(feats))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    assert pg.shape == (B, 1, N, 6 if with_feats else 3)


def _labels():
    return np.array([0, 1, 2, 3])[:B]


@functools.lru_cache(maxsize=None)
def jax_xyz_grad(name):
    """``jax.grad`` of the summed NLL of ``_labels()`` with respect to the
    xyz of ``shapes(6)``, geometry None (built inside the forward, centres
    with their gradient), on ``jax_variables(name, seed=5)``."""
    from flax.traverse_util import unflatten_dict

    model, flat = jax_variables(name, seed=5)
    pts, labels = shapes(6), _labels()
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})

    def loss(p):
        lp = model.apply(variables, p)[0]
        return -jnp.take_along_axis(lp, jnp.asarray(labels)[:, None], 1).sum()

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(pts)))[..., :3]


class BatchNorm(nn.Module):
    """The JAX package's evaluation-mode BatchNorm
    (`models/common.py:32-79`) in its input's dtype: the float32 cast taken
    out. Named as the original, so that flax gives its variables the same
    names."""

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
    """The JAX package's STN (`models/pointnet.py:18-42`) with its
    alignment matrix left in the input's dtype."""

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
    """The JAX classifiers with ``BatchNorm`` and ``STN`` in float64."""
    for module in (jcommon, jpointnet, jpointnet2_cls):
        monkeypatch.setattr(module, "BatchNorm", BatchNorm)
    monkeypatch.setattr(jpointnet, "STN", STN)


def _margin(lp, labels):
    """The summed log-probability margin of each label over the next
    class: its gradient at the logits is +1 and -1, exactly."""
    rows = np.arange(len(labels))
    return (lp[rows, labels] - lp[rows, (labels + 1) % K]).sum()


def jax_xyz_grad64(name):
    """``jax.grad`` of ``_margin`` with respect to the xyz of ``shapes(6)``
    in float64 (``jax.enable_x64``, float64 variables), geometry None."""
    from flax.traverse_util import unflatten_dict

    model, flat = jax_variables(name, seed=5)
    labels = _labels()
    with jax.enable_x64(True):
        variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v, jnp.float64)
                                    for k, v in flat.items()})
        grad = jax.jit(jax.grad(lambda p: _margin(model.apply(variables, p)[0], labels)))(
            jnp.asarray(shapes(6), jnp.float64))
        assert grad.dtype == jnp.float64
        return np.asarray(grad)[..., :3]


def port_xyz_grad(model, pts, labels, loss=None, **kw):
    p = pts.clone().requires_grad_(True)
    lp = model(p, **kw)[0]
    if loss is None:
        (-torch.gather(lp, 1, torch.as_tensor(labels)[:, None]).sum()).backward()
    else:
        loss(lp, labels).backward()
    return p.grad[..., :3]


def chain_rule_grad(model, pts, labels):
    """The xyz gradient of the moving-geometry forward, with the centres
    of both levels as leaves of their own: the direct term plus each
    level's centre gradient scattered back along its FPS indices."""
    geo = model.build_geometry(pts[..., :3])
    p = pts.clone().requires_grad_(True)
    centres = [c.clone().requires_grad_(True) for c, _ in geo["sa"]]
    plan = {"sa": tuple((c, i) for c, (_, i) in zip(centres, geo["sa"]))}
    lp = model(p, geometry=plan)[0]
    (-torch.gather(lp, 1, torch.as_tensor(labels)[:, None]).sum()).backward()
    # level 2's centres are level 1's at fps[1]; level 1's the cloud's at fps[0]
    g1 = centres[0].grad.clone()
    g1.scatter_add_(1, geo["fps"][1].long()[..., None].expand(-1, -1, 3), centres[1].grad)
    g0 = p.grad[..., :3].clone()
    g0.scatter_add_(1, geo["fps"][0].long()[..., None].expand(-1, -1, 3), g1)
    return g0


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# float32 gradient bounds (relative L2): of the port and of JAX from float64,
# and of the two from each other. MSG's runs through maxima over groups of
# near-tied points (k up to 128 of 256 points), where float32 rounding alone
# moves it: both packages sat 4.7e-3 from float64 and 3.9e-4 from each other
# on these shapes; SSG and PointNet within 7.5e-7 on all three
_GRAD32 = {"pointnet2_cls": (1e-5, 1e-5), "pointnet2_cls_msg": (1e-2, 1e-3),
           "pointnet_cls": (1e-5, 1e-5)}


@pytest.mark.parametrize("name", sorted(_GRAD32))
def test_xyz_gradient_matches_jax(name, _jax_float64):
    """float64: autograd through the moving geometry within 1e-10 (relative
    L2) of ``jax.grad`` (the margin loss) and of the chain rule written out.
    float32: the port and ``jax.grad`` each within ``_GRAD32`` of float64
    and of each other."""
    _, flat = jax_variables(name, seed=5)
    pts = shapes(6)
    labels = _labels()
    want32 = jax_xyz_grad(name)
    net64 = port_model(name, flat, torch.float64)
    margin64 = port_xyz_grad(net64, torch.from_numpy(pts).double(), labels, loss=_margin)
    assert _rel_l2(margin64.numpy(), jax_xyz_grad64(name)) <= 1e-10
    got64 = port_xyz_grad(net64, torch.from_numpy(pts).double(), labels).numpy()
    if name != "pointnet_cls":
        ref64 = chain_rule_grad(net64, torch.from_numpy(pts).double(), labels).numpy()
        assert _rel_l2(got64, ref64) <= 1e-10
    got32 = port_xyz_grad(port_model(name, flat), torch.from_numpy(pts), labels).numpy()
    to64, apart = _GRAD32[name]
    assert _rel_l2(got32, got64) <= to64
    assert _rel_l2(want32, got64) <= to64
    assert _rel_l2(got32, want32) <= apart


@pytest.mark.parametrize("name", ["pointnet2_cls", "pointnet2_cls_msg"])
def test_gradient_keeps_the_centre_term(name):
    """Gathering the centres without their gradient (the fixed plan of
    ``build_geometry_cls*``) drops a term that JAX's gradient has: that
    gradient is far from JAX's, the moving-geometry one is not."""
    _, flat = jax_variables(name, seed=5)
    pts = shapes(6)
    labels = _labels()
    want = jax_xyz_grad(name)
    net = port_model(name, flat)
    moving = port_xyz_grad(net, torch.from_numpy(pts), labels).numpy()
    fixed = port_xyz_grad(net, torch.from_numpy(pts), labels,
                          geometry=net.build_geometry(torch.from_numpy(pts)[..., :3])).numpy()
    assert _rel_l2(moving, want) <= _GRAD32[name][1]
    assert _rel_l2(fixed, want) >= 0.05
