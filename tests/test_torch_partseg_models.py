"""Parity of the port's part-segmentation nets (PointNet++ SSG and MSG,
PointNet) with the JAX package, on the CPU.

The same numpy shapes, category one-hots and weights (flax variables,
BatchNorm statistics made non-trivial, carried through
``utils/convert.py``) go through both packages: log-probabilities to 1e-4
in float32, with the geometry built inside the forward and with
``build_geometry_partseg*``'s plan (its indices equal to JAX's, its 3-NN
weights to 1e-6). The xyz gradient is in ``test_torch_partseg_grad.py``,
which takes its shapes and weights from here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu.models import pointnet2_cls as jpointnet2_cls
from pointsecguard_tpu.models import PointNet2PartSegMSG as JaxMSG
from pointsecguard_tpu.models import PointNet2PartSegSSG as JaxSSG
from pointsecguard_tpu.models import PointNetPartSeg as JaxPointNet
from pointsecguard_tpu_torch.models import build_geometry_partseg, build_geometry_partseg_msg
from pointsecguard_tpu_torch.utils.convert import cls_from_jax_variables, cls_to_jax_variables

B, N = 3, 256
_JAX = {"pointnet2_part_seg": JaxSSG, "pointnet2_part_seg_msg": JaxMSG,
        "pointnet_part_seg": JaxPointNet}
_LEAVES = {"pointnet2_part_seg": 104, "pointnet2_part_seg_msg": 152, "pointnet_part_seg": 114}
_CATS = np.array([3, 0, 15])  # category ids of the B shapes


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def shapes(seed=0, normals=True):
    """[B, N, 6] unit-sphere shapes (an ellipsoid shell, a clipped one and
    noise) with unit normals, float32."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, N, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    xyz = v * rng.uniform(0.5, 1.0, (B, 1, 3))
    xyz[1] = np.clip(xyz[1] * 1.6, -0.6, 0.6)
    xyz[-1] = rng.uniform(-0.7, 0.7, (N, 3))
    nrm = rng.normal(size=(B, N, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pts = np.concatenate([xyz, nrm], -1) if normals else xyz
    return pts.astype(np.float32)


def one_hot():
    return np.eye(16, dtype=np.float32)[_CATS]


def _jax_model(name, normals):
    if name == "pointnet_part_seg":
        return JaxPointNet(part_num=50, normal_channel=normals)
    return _JAX[name](num_classes=50, normal_channel=normals)


@functools.lru_cache(maxsize=None)
def jax_variables(name, seed=0, normals=True):
    """Flat flax variables with BatchNorm statistics drawn away from 0 / 1,
    so that the network's evaluation mode is not the identity's."""
    model = _jax_model(name, normals)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(shapes(seed, normals)), jnp.asarray(one_hot()))
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    rng = np.random.default_rng(seed + 1)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return model, flat


def _variables(flat, dtype=jnp.float32):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v, dtype) for k, v in flat.items()})


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
    back = cls_to_jax_variables(name, cls_from_jax_variables(name, flat))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("normals", [True, False], ids=["normals", "xyz"])
@pytest.mark.parametrize("name", sorted(_JAX))
def test_log_probs_match_jax(name, normals):
    """The forward that builds its own geometry, against JAX's
    ``geometry=None`` forward."""
    model, flat = jax_variables(name, normals=normals)
    pts = shapes(1, normals=normals)
    want, _ = jax.jit(model.apply)(_variables(flat), jnp.asarray(pts), jnp.asarray(one_hot()))
    net = port_model(name, flat)
    assert net(torch.zeros(B, N, pts.shape[-1]), torch.from_numpy(one_hot()))[0].shape == (B, N, 50)
    got, l3 = net(torch.from_numpy(pts), torch.from_numpy(one_hot()))
    assert got.shape == (B, N, 50) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,jax_fn,port_fn", [
    ("pointnet2_part_seg", jpointnet2_cls.build_geometry_partseg, build_geometry_partseg),
    ("pointnet2_part_seg_msg", jpointnet2_cls.build_geometry_partseg_msg,
     build_geometry_partseg_msg)])
def test_given_geometry_matches_jax(name, jax_fn, port_fn):
    """``build_geometry_partseg*``: FPS centres and every ball-query group
    exactly, the 3-NN indices exactly and their weights to float32
    rounding; the forward on the port's plan against JAX's on its own."""
    pts = shapes(2)
    # jitted: XLA fuses |q|² − 2 q·p + |p|² into the rounding the port's
    # square_distance keeps; JAX's op-by-op run rounds otherwise
    want = jax.jit(jax_fn)(jnp.asarray(pts[..., :3]))
    got = port_fn(torch.from_numpy(pts[..., :3]))
    for (jc, jidx), (pc, pidx) in zip(want["sa"], got["sa"]):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        jidx = jidx if isinstance(jidx, tuple) else (jidx,)
        pidx = pidx if isinstance(pidx, tuple) else (pidx,)
        assert len(jidx) == len(pidx)
        for a, b in zip(jidx, pidx):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for (ji, jw), (pi, pw) in zip(want["fp"], got["fp"]):
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert not any(t.requires_grad for _, t in got["fp"])
    model, flat = jax_variables(name)
    lp_want, _ = jax.jit(functools.partial(model.apply, geometry=want))(
        _variables(flat), jnp.asarray(pts), jnp.asarray(one_hot()))
    lp_got, _ = port_model(name, flat)(torch.from_numpy(pts), torch.from_numpy(one_hot()),
                                       geometry=got)
    np.testing.assert_allclose(lp_got.detach().numpy(), np.asarray(lp_want), rtol=0, atol=1e-4)


def test_train_mode_geometry_draws_starts():
    """With a generator, one FPS start per shape and level from it; two
    3-NN plans over the drawn centres."""
    xyz = torch.from_numpy(shapes(3)[..., :3])
    g1, g2 = (build_geometry_partseg(xyz, torch.Generator().manual_seed(s)) for s in (1, 1))
    g3 = build_geometry_partseg(xyz, torch.Generator().manual_seed(2))
    assert all(torch.equal(a, b) for a, b in zip(g1["fps"], g2["fps"]))
    assert not torch.equal(g1["fps"][0], g3["fps"][0])
    assert g1["fp"][1][0].shape == (B, N, 3) and g1["fp"][0][0].shape == (B, 512, 3)


def _labels():
    """[B, N] part labels of the gradient tests' losses."""
    return np.random.default_rng(4).integers(0, 50, (B, N))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_three_nn_plan_rounds_as_jitted_jax(dtype):
    """The 3-NN plan's distances and weights bit for bit as the jitted JAX
    package rounds them, float32 and under ``jax.enable_x64`` (where both
    keep d² in float32, the cross term rounded once from float64), and
    ``three_nn_weights`` at the plan's indices its weights."""
    from pointsecguard_tpu import ops as jops
    from pointsecguard_tpu_torch import ops

    rng = np.random.default_rng(7)
    dst = rng.normal(size=(2, 300, 3)).astype(dtype)
    src = dst[:, ::3].copy()  # a third of the dense points are the sparse ones
    with jax.enable_x64(dtype == "float64"):
        want_d = np.asarray(jax.jit(jops.square_distance)(jnp.asarray(dst), jnp.asarray(src)))
        want_i, want_w = jax.jit(jops.three_nn_plan)(jnp.asarray(dst), jnp.asarray(src))
    d, s = torch.from_numpy(dst), torch.from_numpy(src)
    got_d = ops.square_distance(d, s).numpy()
    assert got_d.dtype == want_d.dtype == np.float32
    np.testing.assert_array_equal(got_d, want_d)
    idx, w = ops.three_nn_plan(d, s)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    assert torch.equal(ops.three_nn_weights(d, s, idx), w)
