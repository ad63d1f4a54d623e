"""Parity of the port's sparse GCN library (``models/gcn_sparse.py``) and
its flax weight map (``utils/convert.py:gcn_sparse_from_jax_variables``)
with the JAX package's ``models/gcn_sparse.py``, on the CPU.

The JAX package's own seven tests (``tests/test_gcn_sparse.py``) run
against the port as cases of parametrised tests. Then every conv
configuration of JAX's ``test_forward_shapes`` list and both blocks,
JAX-initialised (BatchNorm statistics, GENConv's t / p, GIN's eps and
MsgNorm's scale drawn away from their initial values) and carried across:
the forward in evaluation and in training mode, the input gradient of a
fixed cotangent and the BatchNorm statistics after the training forward,
in float32 within 1e-5 and in float64 (``jax.enable_x64``) within 1e-10:
of the largest magnitude for outputs and statistics, in relative L2 for
the gradient (in float32 against the float64 gradient, which JAX's own
float32 gradient is not always as close to). JAX's BatchNorm computes in
float32 whatever its input; the float64 comparison swaps in a copy of it
without that cast, named as the original so that flax names its
variables the same.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu.models import gcn_sparse as jgcn
from pointsecguard_tpu_torch.models import gcn_sparse as tgcn
from pointsecguard_tpu_torch.utils.convert import (
    gcn_sparse_from_jax_variables,
    gcn_sparse_to_jax_variables,
)

N, C, K = 32, 8, 4
TOL = {np.float32: 1e-5, np.float64: 1e-10}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def graph():
    """JAX's fixture: x [32, 8] and the k = 4 kNN graph of random
    positions (``knn_edge_index`` of the port; equal to JAX's, below)."""
    rng = np.random.RandomState(0)
    x = rng.randn(N, C).astype(np.float32)
    pos = rng.rand(N, 3).astype(np.float32)
    ei = tgcn.knn_edge_index(torch.from_numpy(pos), K)
    return torch.from_numpy(x), ei


# --- JAX's seven tests, on the port -------------------------------------------

def _mean(x, ei):
    out = tgcn.aggregate(x[ei[0].long()], ei[1], N, aggr="mean")
    src, dst = ei.numpy()
    want = np.stack([x.numpy()[src[dst == i]].mean(0) for i in range(N)])
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


def _softmax(x, ei):
    out = tgcn.aggregate(torch.ones(ei.shape[1], 1), ei[1], N, aggr="softmax")
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


def _max_uncovered(x, ei):
    ei = torch.tensor([[1, 2], [0, 0]])  # only node 0 receives messages
    out = tgcn.aggregate(x[ei[0]], ei[1], N, aggr="max").numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[1:], 0.0)
    np.testing.assert_allclose(out[0], np.maximum(x[1].numpy(), x[2].numpy()), atol=1e-6)


def _powermean(x, ei):
    msgs = torch.abs(x[ei[0].long()]) + 0.1
    a = tgcn.aggregate(msgs, ei[1], N, aggr="powermean", p=1.0)
    b = tgcn.aggregate(msgs, ei[1], N, aggr="mean")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


@pytest.mark.parametrize("check", [_mean, _softmax, _max_uncovered, _powermean],
                         ids=["mean_matches_numpy", "softmax_weights_sum_to_one",
                              "max_zero_fills_uncovered_nodes", "powermean_p1_is_mean_of_clipped"])
def test_aggregate(graph, check):
    check(*graph)


# (JAX class, port class, kwargs): JAX's test_forward_shapes list
CONVS = [
    (jgcn.GENConv, tgcn.GENConv, {"emb_dim": 16}),
    (jgcn.GENConv, tgcn.GENConv, {"emb_dim": 16, "aggr": "powermean", "learn_p": True}),
    (jgcn.GENConv, tgcn.GENConv, {"emb_dim": 16, "msg_norm": True, "learn_t": True}),
    (jgcn.SparseEdgeConv, tgcn.SparseEdgeConv, {"out_channels": 16}),
    (jgcn.SparseMRConv, tgcn.SparseMRConv, {"out_channels": 16}),
    (jgcn.SparseGAT, tgcn.SparseGAT, {"out_channels": 4, "heads": 2}),
    (jgcn.SparseSAGE, tgcn.SparseSAGE, {"out_channels": 16}),
    (jgcn.SparseGIN, tgcn.SparseGIN, {"out_channels": 16}),
    (jgcn.SemiGCN, tgcn.SemiGCN, {"out_channels": 16}),
]
CONV_IDS = ["gen", "gen_powermean_learn_p", "gen_msgnorm_learn_t", "edge", "mr", "gat",
            "sage", "gin", "semigcn"]


@pytest.mark.parametrize("jcls,tcls,kwargs", CONVS, ids=CONV_IDS)
def test_forward_shapes(graph, jcls, tcls, kwargs):
    x, ei = graph
    layer = tcls(C, **kwargs).eval()
    out = layer(x, ei)
    assert out.shape[0] == N
    assert torch.isfinite(out).all()


def test_res_and_dense_blocks(graph):
    x, ei = graph
    assert tgcn.ResGraphBlock(tgcn.SparseEdgeConv(C, C))(x, ei).shape == (N, C)
    assert tgcn.DenseGraphBlock(tgcn.SparseEdgeConv(C, C))(x, ei).shape == (N, 2 * C)


def test_knn_edges():
    pos = torch.from_numpy(np.random.RandomState(0).rand(16, 3).astype(np.float32))
    ei = tgcn.knn_edge_index(pos, 3)
    assert ei.shape == (2, 48) and ei.dtype == torch.int32
    # self edge is always the nearest neighbour
    assert (ei[0][::3].numpy() == np.arange(16)).all()


# --- against the JAX package, weights carried across ----------------------------

class BatchNorm(fnn.Module):
    """The JAX package's BatchNorm (`models/common.py:32-79`) in its input's
    dtype: the float32 cast taken out, training mode included."""

    epsilon: float = 1e-5

    @fnn.compact
    def __call__(self, x, use_running_average, momentum=0.9):
        features = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean", jnp.zeros, (features,), x.dtype)
        ra_var = self.variable("batch_stats", "var", jnp.ones, (features,), x.dtype)
        scale = self.param("scale", fnn.initializers.ones, (features,))
        bias = self.param("bias", fnn.initializers.zeros, (features,))
        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            axes = tuple(range(x.ndim - 1))
            mean, var = jnp.mean(x, axes), jnp.var(x, axes)
            if not self.is_initializing():
                n = x.size // features
                ra_mean.value = momentum * ra_mean.value + (1.0 - momentum) * mean
                ra_var.value = momentum * ra_var.value + (1.0 - momentum) * var * (n / (n - 1))
        return (x - mean) * jnp.reciprocal(jnp.sqrt(var + self.epsilon)) * scale + bias


BLOCKS = [
    (lambda: jgcn.ResGraphBlock(jgcn.SparseEdgeConv(C)),
     lambda: tgcn.ResGraphBlock(tgcn.SparseEdgeConv(C, C))),
    (lambda: jgcn.DenseGraphBlock(jgcn.SparseEdgeConv(C)),
     lambda: tgcn.DenseGraphBlock(tgcn.SparseEdgeConv(C, C))),
]
CASES = [(lambda j=j, kw=kw: j(**kw), lambda t=t, kw=kw: t(C, **kw)) for j, t, kw in CONVS] \
    + BLOCKS
CASE_IDS = CONV_IDS + ["res_block", "dense_block"]


def _jax_flat(make_jax, x, ei, seed: int) -> dict:
    """JAX-initialised leaves with the BatchNorm statistics and affine
    parameters and the scalar parameters drawn from a seed."""
    variables = make_jax().init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(ei))
    flat = {k: np.asarray(v) for k, v in flatten_dict(variables, sep="/").items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if leaf in ("mean", "bias") and "BatchNorm" in k:
            flat[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        elif leaf in ("var", "scale") or v.shape == (1,):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return flat


def _jax_run(make_jax, flat, x, ei, cot, dtype, train: bool):
    """(output, input gradient of <output, cot>, updated batch_stats)."""
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v, dtype)
                                for k, v in flat.items()})
    layer = make_jax()

    def f(x):
        if train:
            out, upd = layer.apply(variables, x, ei, train=True, mutable=["batch_stats"])
        else:
            out, upd = layer.apply(variables, x, ei), {}
        return jnp.sum(out * cot), (out, upd)

    (_, (out, upd)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x, dtype))
    stats = {k: np.asarray(v) for k, v in flatten_dict(dict(upd), sep="/").items()}
    return np.asarray(out), np.asarray(g), stats


def _close(got, want, tol, what):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - want).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of the largest magnitude"


def _close_l2(got, want, tol, what):
    err = np.linalg.norm(got.astype(np.float64) - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} relative L2"


# JAX's own float32 input gradient of GENConv's softmax aggregation in
# training mode sits 1.4e-5 (relative L2) from the float64 one, the port's
# 8.6e-7: in float32 both are held to the float64 gradient, the port within
# TOL and JAX within this
JAX_GRAD32 = 5e-5


def _port_run(port, x, ei, cot, train: bool):
    port.train(train)
    xt = torch.tensor(x, requires_grad=True)
    out = port(xt, ei)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("make_jax,make_port", CASES, ids=CASE_IDS)
def test_layer_equals_jax(graph, monkeypatch, make_jax, make_port, dtype):
    if dtype == np.float64:
        monkeypatch.setattr(jgcn, "BatchNorm", BatchNorm)
    x32, ei_t = graph
    x = x32.numpy().astype(dtype)
    ei = ei_t.numpy()
    flat = _jax_flat(make_jax, x32.numpy(), ei, seed=11)
    sd = gcn_sparse_from_jax_variables(flat, make_port())
    # the map is its own inverse, leaf for leaf
    back = gcn_sparse_to_jax_variables(sd)
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    ports = {}
    for dt in (torch.float32, torch.float64):
        ports[dt] = make_port().to(dt)
        ports[dt].load_state_dict(sd)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    port = ports[tdtype]
    shape = port.eval()(torch.from_numpy(x), ei_t).shape
    cot = np.random.default_rng(3).normal(0, 1, shape).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        for train in (False, True):
            mode = "train" if train else "eval"
            out_w, g_w, stats_w = _jax_run(make_jax, flat, x, ei, cot, dtype, train)
            out, grad = _port_run(port, x, ei_t, cot, train)
            assert out.dtype == dtype and out.shape == out_w.shape
            _close(out, out_w, TOL[dtype], f"{mode} forward")
            if dtype == np.float64:
                _close_l2(grad, g_w, TOL[dtype], f"{mode} input gradient")
            else:
                _, g64 = _port_run(ports[torch.float64], x.astype(np.float64), ei_t,
                                   cot.astype(np.float64), train)
                _close_l2(grad, g64, TOL[dtype], f"{mode} input gradient")
                _close_l2(g_w, g64, JAX_GRAD32, f"{mode} JAX's input gradient")
            if train:
                got_stats = gcn_sparse_to_jax_variables(
                    {k: v for k, v in port.state_dict().items()
                     if k.endswith((".mean", ".var"))})
                assert got_stats.keys() == stats_w.keys()
                for k in stats_w:
                    _close(got_stats[k], stats_w[k], TOL[dtype], k)


@pytest.mark.parametrize("fault", ["missing", "unconsumed", "misshapen"])
def test_from_jax_variables_refuses_leaves_that_do_not_fill_the_layer(graph, fault):
    """The map checks the leaves against the port layer: a leaf left out,
    one the layer has no place for, or one of the wrong shape raises."""
    _, ei_t = graph
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (ei_t.max() + 1, C))
                         .astype(np.float32))
    port = tgcn.GENConv(C, C, msg_norm=True, learn_t=True)
    port.train()(x, ei_t)
    flat = gcn_sparse_to_jax_variables(port.state_dict())
    key = next(k for k in flat if k.endswith("/kernel"))
    if fault == "missing":
        del flat[key]
    elif fault == "unconsumed":
        flat["params/MsgNorm_0/shift"] = np.ones(1, np.float32)
    else:
        flat[key] = flat[key][:-1]
    with pytest.raises(ValueError, match=fault + r" \['"):
        gcn_sparse_from_jax_variables(flat, port)
    assert gcn_sparse_from_jax_variables(gcn_sparse_to_jax_variables(port.state_dict()),
                                         port).keys() == port.state_dict().keys()


@pytest.mark.parametrize("aggr", ["max", "add", "mean", "softmax", "powermean"])
def test_aggregate_ties_and_uncovered_nodes(aggr):
    """Messages with exact ties in every column (integers) onto 6 targets
    of 10 nodes, 4 of which no edge reaches; value and gradient of a fixed
    cotangent against JAX in float64 (the max splits its gradient evenly
    among tied maxima in both)."""
    rng = np.random.default_rng(4)
    msgs = rng.integers(0, 3, (40, 5)).astype(np.float64) / 2 + 0.25
    targets = rng.choice([0, 2, 3, 5, 7, 8], 40)
    cot = rng.normal(0, 1, (10, 5))
    with jax.enable_x64(True):
        f = lambda m: jnp.sum(jgcn.aggregate(m, jnp.asarray(targets), 10, aggr=aggr,
                                             t=1.5, p=2.0) * cot)
        want_v = np.asarray(jgcn.aggregate(jnp.asarray(msgs), jnp.asarray(targets), 10,
                                           aggr=aggr, t=1.5, p=2.0))
        want_g = np.asarray(jax.grad(f)(jnp.asarray(msgs)))
    m = torch.tensor(msgs, requires_grad=True)
    got = tgcn.aggregate(m, torch.from_numpy(targets), 10, aggr=aggr, t=1.5, p=2.0)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want_v, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(m.grad.numpy(), want_g, rtol=1e-12, atol=1e-14)
    assert (got.detach().numpy()[[1, 4, 6, 9]] == 0).all()


@pytest.mark.parametrize("shape,k", [((64, 3), 4), ((64, 3), 16), ((48, 8), 6)],
                         ids=["xyz_k4", "xyz_k16", "features_k6"])
def test_knn_edge_index_equals_jax(shape, k):
    x = np.random.default_rng(9).random(shape).astype(np.float32)
    want = np.asarray(jgcn.knn_edge_index(jnp.asarray(x), k))
    got = tgcn.knn_edge_index(torch.from_numpy(x), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
