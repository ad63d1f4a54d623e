"""The port's mixed precision (``dtype=torch.bfloat16``, ``--precision
bfloat16``) against the JAX package's (``dtype=jnp.bfloat16``) on the CPU,
for all eleven models.

The recipe is the JAX package's (`pointsecguard_tpu/models/common.py`,
`tests/test_precision.py`): parameters stay float32, every Dense runs in
bf16 (its bias added after the product is rounded), BatchNorm computes in
float32 and returns the caller's dtype, and softmaxes, logits, losses and
all neighbour search stay float32.

Weights are the port's initialisation with BatchNorm parameters and
statistics drawn away from the identity, carried to flax through
``utils/convert.py``; inputs are numpy draws from a seed, and the
geometry is pinned where it is data-dependent (RandLA's pyramid, ResGCN's
graphs, both taken from the port's float32 run). Stated tolerances:

- port bf16 against JAX bf16: ``BF16_ULPS`` bf16 ulps of the largest
  centred output (log-probabilities or logits less their mean over the
  classes, i.e. the logits up to a shift). The two packages' bf16
  products sum in another order, so a rounding can fall the other way
  and carry through the layers; they agree to that, not bit for bit.
- port bf16 against port float32: JAX's own limits, 0.05 on PointNet-
  family log-probabilities and 0.1 on RandLA and ResGCN logits.
- the input gradient: finite, float32, as close to float32's as JAX's
  bf16 gradient is (cosine less 0.02), and above 0.99 in JAX's own setting.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from pointsecguard_tpu import models as jmodels
from pointsecguard_tpu_torch import models
from pointsecguard_tpu_torch.models import init_parameters
from pointsecguard_tpu_torch.models.common import BatchNorm, linear
from pointsecguard_tpu_torch.utils import convert

BF16 = torch.bfloat16
BF16_ULPS = 4
B, N = 2, 128
RANDLA = dict(d_out=(4, 8, 16, 32, 64))
RANDLA_K, RANDLA_RATIOS = 4, (2, 2, 2, 2, 2)
RESGCN = dict(n_blocks=4, n_filters=8, k=4)
# JAX's bf16-against-float32 limits (tests/test_precision.py)
LIMIT = {"randla": 0.1, "resgcn": 0.1}
LOGP_LIMIT = 0.05


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# name → (port constructor, JAX constructor, port state dict → flat flax,
#         input channels, takes the part-seg one-hot)
CASES = {
    "pointnet2": (models.PointNet2SemSegSSG, jmodels.PointNet2SemSegSSG,
                  convert.to_jax_variables, 9, False),
    "pointnet2_msg": (models.PointNet2SemSegMSG, jmodels.PointNet2SemSegMSG,
                      convert.pointnet2_msg_to_jax_variables, 9, False),
    "pointnet": (models.PointNetSemSeg, jmodels.PointNetSemSeg,
                 convert.pointnet_to_jax_variables, 9, False),
    "pointnet2_cls": (functools.partial(models.PointNet2ClsSSG, num_classes=5),
                      functools.partial(jmodels.PointNet2ClsSSG, num_classes=5),
                      functools.partial(convert.cls_to_jax_variables, "pointnet2_cls"),
                      6, False),
    "pointnet2_cls_msg": (functools.partial(models.PointNet2ClsMSG, num_classes=5),
                          functools.partial(jmodels.PointNet2ClsMSG, num_classes=5),
                          functools.partial(convert.cls_to_jax_variables, "pointnet2_cls_msg"),
                          6, False),
    "pointnet_cls": (functools.partial(models.PointNetCls, num_classes=5),
                     functools.partial(jmodels.PointNetCls, num_classes=5),
                     functools.partial(convert.cls_to_jax_variables, "pointnet_cls"),
                     6, False),
    "pointnet2_part_seg": (models.PointNet2PartSegSSG, jmodels.PointNet2PartSegSSG,
                           functools.partial(convert.cls_to_jax_variables,
                                             "pointnet2_part_seg"), 3, True),
    "pointnet2_part_seg_msg": (models.PointNet2PartSegMSG, jmodels.PointNet2PartSegMSG,
                               functools.partial(convert.cls_to_jax_variables,
                                                 "pointnet2_part_seg_msg"), 3, True),
    "pointnet_part_seg": (functools.partial(models.PointNetPartSeg, normal_channel=False),
                          functools.partial(jmodels.PointNetPartSeg, normal_channel=False),
                          functools.partial(convert.cls_to_jax_variables, "pointnet_part_seg"),
                          3, True),
    "randla": (functools.partial(models.RandLANet, **RANDLA),
               functools.partial(jmodels.RandLANet, **RANDLA),
               convert.randla_to_jax_variables, 6, False),
    "resgcn": (functools.partial(models.DenseDeepGCN, **RESGCN),
               functools.partial(jmodels.DenseDeepGCN, stochastic=False, **RESGCN),
               convert.resgcn_to_jax_variables, 9, False),
}
NAMES = sorted(CASES)


def _inputs(name: str, seed: int = 0):
    """(points [B, N, C] float32, part-seg one-hot [B, 16] or None)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(B, N, CASES[name][3])) * 0.3).astype(np.float32)
    onehot = None
    if CASES[name][4]:
        onehot = np.eye(16, dtype=np.float32)[rng.integers(0, 16, B)]
    return pts, onehot


@functools.lru_cache(maxsize=None)
def _state(name: str, seed: int = 0) -> dict:
    """The port's initialisation with every BatchNorm's scale, bias, mean
    and variance drawn from the seed, so that no layer is the identity."""
    model = CASES[name][0]()
    init_parameters(model, torch.Generator().manual_seed(seed),
                    scale=2.0 if name == "resgcn" else 1.0)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.mean.shape[0]
                mod.scale.copy_(torch.rand(n, generator=gen) + 0.5)
                mod.bias.copy_(torch.rand(n, generator=gen) - 0.5)
                mod.mean.copy_(torch.rand(n, generator=gen) - 0.5)
                mod.var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
    return model.state_dict()


def _port(name: str, dtype=None):
    model = CASES[name][0](dtype=dtype)
    model.load_state_dict(_state(name))
    return model.eval()


@functools.lru_cache(maxsize=None)
def _plan(name: str):
    """The pinned geometry of the case's inputs, from the port's float32
    model: RandLA's pyramid, ResGCN's graphs; None for the others (the
    PointNet family's geometry is built from the float32 xyz alone, equal
    in both packages: tests/test_torch_pointnet2.py and friends)."""
    pts, _ = _inputs(name)
    if name == "randla":
        return models.build_pyramid(torch.from_numpy(pts[..., :3]), k=RANDLA_K,
                                    sub_ratios=RANDLA_RATIOS)
    if name == "resgcn":
        with torch.no_grad():
            return _port(name)(torch.from_numpy(pts), collect_graphs=True)[1]
    return None


def _port_out(model, name: str, pts: torch.Tensor, onehot) -> torch.Tensor:
    """The model's log-probabilities (PointNet family) or logits."""
    plan = _plan(name)
    if name == "randla":
        return model(pts, plan)
    if name == "resgcn":
        return model(pts, graphs=plan)
    if onehot is not None:
        return model(pts, torch.from_numpy(onehot))[0]
    return model(pts)[0]


@functools.lru_cache(maxsize=None)
def _jax_run(name: str) -> tuple[np.ndarray, np.ndarray]:
    """JAX's bf16 output on the case's inputs and the gradient of ``_loss``
    in the input, from one jitted program."""
    pts, onehot = _inputs(name)
    flat = CASES[name][2](_state(name))
    variables = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    model = CASES[name][1](dtype=jnp.bfloat16)
    plan = _plan(name)
    if name == "randla":
        pyr = {k: tuple(jnp.asarray(t.numpy()) for t in v) for k, v in plan.items()}
        fwd = lambda p: model.apply(variables, p, pyr)  # noqa: E731
    elif name == "resgcn":
        graphs = tuple(jnp.asarray(g.numpy()) for g in plan)
        fwd = lambda p: model.apply(variables, p, graphs=graphs)  # noqa: E731
    elif onehot is not None:
        fwd = lambda p: model.apply(variables, p, jnp.asarray(onehot))[0]  # noqa: E731
    else:
        fwd = lambda p: model.apply(variables, p)[0]  # noqa: E731

    def loss(p):
        out = fwd(p)
        return -jnp.mean(jax.nn.log_softmax(out, axis=-1)[..., 0]), out

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(pts))
    return np.asarray(out), np.asarray(grad)


def _ulp(out: np.ndarray) -> float:
    """One bf16 ulp at the largest centred output (8 significant bits)."""
    centred = out - out.mean(axis=-1, keepdims=True)
    return 2.0 ** (np.floor(np.log2(np.abs(centred).max())) - 7)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_matches_jax_bf16(name):
    pts, onehot = _inputs(name)
    with torch.no_grad():
        got = _port_out(_port(name, BF16), name, torch.from_numpy(pts), onehot)
    assert got.dtype == torch.float32
    want = _jax_run(name)[0]
    assert want.dtype == np.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_ULPS * _ulp(want), (name, err, _ulp(want))


@pytest.mark.parametrize("name", NAMES)
def test_bf16_close_to_float32(name):
    pts, onehot = _inputs(name)
    with torch.no_grad():
        lo16 = _port_out(_port(name, BF16), name, torch.from_numpy(pts), onehot)
        lo32 = _port_out(_port(name), name, torch.from_numpy(pts), onehot)
    assert lo16.dtype == lo32.dtype == torch.float32
    assert (lo16 - lo32).abs().max().item() < LIMIT.get(name, LOGP_LIMIT)
    agree = (lo16.argmax(-1) == lo32.argmax(-1)).float().mean().item()
    assert agree > 0.9


def _loss(out: torch.Tensor) -> torch.Tensor:
    """NLL of class 0 (of the log-softmax for logits)."""
    return -torch.log_softmax(out, dim=-1)[..., 0].mean()


@pytest.mark.parametrize("name", NAMES)
def test_train_step_keeps_parameters_and_gradients_float32(name):
    """A train-mode forward and backward in bf16: every parameter, its
    gradient and every BatchNorm statistic stays float32 and finite."""
    pts, onehot = _inputs(name, seed=1)
    model = _port(name, BF16).train()
    _loss(_port_out(model, name, torch.from_numpy(pts), onehot)).backward()
    for key, p in model.named_parameters():
        assert p.dtype == torch.float32, key
        if p.grad is not None:
            assert p.grad.dtype == torch.float32, key
            assert torch.isfinite(p.grad).all(), key
    assert sum(p.grad is not None for p in model.parameters()) > 0
    for key, b in model.named_buffers():
        assert b.dtype == torch.float32 and torch.isfinite(b).all(), key


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64).reshape(-1), np.asarray(b, np.float64).reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _input_grads(name: str, pts: np.ndarray, onehot, state=None) -> list[np.ndarray]:
    """The gradient of ``_loss`` in the input, float32 model then bf16."""
    grads = []
    for dtype in (None, BF16):
        model = _port(name, dtype)
        if state is not None:
            model.load_state_dict(state)
        x = torch.from_numpy(pts).requires_grad_(True)
        _loss(_port_out(model, name, x, onehot)).backward()
        assert x.grad.dtype == torch.float32 and torch.isfinite(x.grad).all()
        grads.append(x.grad.numpy())
    return grads


@pytest.mark.parametrize("name", NAMES)
def test_input_gradient_as_close_to_float32_as_jax(name):
    """The attacks differentiate the input: bf16's gradient is float32 and
    finite, and points where float32's does at least as well as JAX's bf16
    gradient on the same weights (less 0.02). With the BatchNorm layers
    drawn away from the identity, bf16 rounding turns the gradient of a
    max-pooled net visibly in both packages, so JAX's own cosine sets the
    floor."""
    pts, onehot = _inputs(name)
    g32, g16 = _input_grads(name, pts, onehot)
    assert _cos(g16, g32) >= _cos(_jax_run(name)[1], g32) - 0.02


def test_input_gradient_close_to_float32_in_jax_setting():
    """JAX's own check (`tests/test_precision.py:121-140`) in its setting:
    PointNet++ SSG at its initialisation (BatchNorm the identity), inputs
    a tenth of a unit normal, cosine above 0.99."""
    model = models.PointNet2SemSegSSG()
    init_parameters(model, torch.Generator().manual_seed(1))
    pts = (np.random.default_rng(0).normal(size=(B, N, 9)) * 0.1).astype(np.float32)
    g32, g16 = _input_grads("pointnet2", pts, None, model.state_dict())
    assert _cos(g16, g32) > 0.99


def test_resgcn_head_graph_identical_across_precision():
    """The head's graph is built on the raw xyz, which no bf16 product
    touches; every block's kNN runs on float32 features."""
    pts, _ = _inputs("resgcn", seed=2)
    with torch.no_grad():
        _, g32 = _port("resgcn")(torch.from_numpy(pts), collect_graphs=True)
        _, g16 = _port("resgcn", BF16)(torch.from_numpy(pts), collect_graphs=True)
    assert torch.equal(g32[0], g16[0])


def test_fused_attentive_pooling_refused_with_bf16():
    with pytest.raises(ValueError, match="float32 attentive kernel"):
        models.RandLANet(ap_impl="fused", dtype=BF16, **RANDLA)
    models.RandLANet(ap_impl="fused", **RANDLA)


def test_linear_without_dtype_is_the_module_and_with_bf16_rounds_twice():
    """``linear(x, layer)`` is ``layer(x)`` bit for bit (the float32 and
    float64 paths do not move); with bf16 it is the product rounded to
    bf16, then the bias added in bf16."""
    gen = torch.Generator().manual_seed(0)
    layer = torch.nn.Linear(16, 8).double()
    x = torch.randn(4, 16, generator=gen, dtype=torch.float64)
    assert torch.equal(linear(x, layer), layer(x))
    layer = layer.float()
    y = linear(x.float(), layer, BF16)
    prod = (x.float().bfloat16() @ layer.weight.bfloat16().t())
    assert y.dtype == BF16
    assert torch.equal(y, prod + layer.bias.bfloat16())


def test_batchnorm_computes_in_float32_and_returns_the_callers_dtype():
    bn = BatchNorm(8).train()
    x = torch.randn(4, 5, 8, generator=torch.Generator().manual_seed(0))
    y = bn(x.bfloat16())
    assert y.dtype == BF16 and bn.mean.dtype == torch.float32
    want = BatchNorm(8).train()(x.bfloat16().float())
    assert torch.equal(y, want.bfloat16())


def test_the_float_modes_keep_bf16_products_reducing_in_float32():
    """``--precision bfloat16`` accumulates its products in float32, as
    JAX's do: the entry points turn cuBLAS's bf16 reduction off with TF32."""
    from pointsecguard_tpu_torch.utils.runtime import model_dtype, resolve_device

    before = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        resolve_device("cpu")
        assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = before
    assert model_dtype("float32") is None and model_dtype("bfloat16") is BF16
    with pytest.raises(ValueError, match="unknown precision"):
        model_dtype("float16")
