"""Parity of the port's ResGCN-28 (``models/resgcn.py``,
``ops/neighbors.py:dense_knn_graph`` / ``dilate_neighbors``, the flax
weight map of ``utils/convert.py``) with the JAX package, on the CPU.

Inputs are drawn from numpy seeds; weights are JAX-initialised and cross
through ``resgcn_from_jax_variables``. A [2, 256, 9] model with k = 16 and
5 blocks builds graphs at k·d = 16, 32, 48 (the fused-kNN route) and 64
(the distance product and the stable sort), so both routes are held
against JAX's graphs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu import ops as jops
from pointsecguard_tpu.models import DenseDeepGCN as JaxDenseDeepGCN
from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.models import DenseDeepGCN
from pointsecguard_tpu_torch.utils.convert import (
    resgcn_from_jax_variables,
    resgcn_module_map,
    resgcn_to_jax_variables,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "model_logits.npz")
SMALL = dict(n_blocks=5, n_filters=16, k=16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(variables) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(variables, sep="/").items()}


def _with_random_stats(flat: dict, seed: int) -> dict:
    """BatchNorm running statistics drawn from a seed (mean ±0.5, var in
    [0.5, 2]), so that evaluation mode normalises by something other than
    the initial 0 and 1."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k, v in flat.items():
        if k.endswith("/mean"):
            out[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        elif k.endswith("/var"):
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return out


def _port(flat: dict, **kw) -> DenseDeepGCN:
    model = DenseDeepGCN(**kw)
    model.load_state_dict(resgcn_from_jax_variables(flat))
    return model.eval()


def test_fixture_logits_reproduced():
    """``tests/test_fixtures.py::test_resgcn``: JAX PRNGKey(7) weights of
    DenseDeepGCN(n_blocks=3, n_filters=8, k=4) give the checked-in logits."""
    fix = np.load(FIXTURE)
    model = JaxDenseDeepGCN(n_blocks=3, n_filters=8, k=4)
    flat = _flat(jax.jit(model.init)(jax.random.PRNGKey(7), jnp.asarray(fix["points"])))
    port = _port(flat, n_blocks=3, n_filters=8, k=4)
    with torch.no_grad():
        got = port(torch.from_numpy(fix["points"])).numpy()
    np.testing.assert_allclose(got, fix["resgcn_logits"], atol=1e-4)


# --- the graphs ---------------------------------------------------------------

@pytest.mark.parametrize("k,D", [(16, 3), (16, 64), (48, 64), (64, 64), (144, 9)])
def test_dense_knn_graph_equals_jax(k, D):
    """Both routes: k ≤ 48 the fused kernel's plain version, larger k the
    distance product and the stable sort; the self point first."""
    x = np.random.default_rng(k + D).standard_normal((2, 300, D)).astype(np.float32)
    want = np.asarray(jops.dense_knn_graph(jnp.asarray(x), k))
    got = ops.dense_knn_graph(torch.from_numpy(x), k)
    assert got.dtype == torch.int32 and got.shape == (2, 300, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[..., 0].numpy(), np.tile(np.arange(300), (2, 1)))


def test_dense_knn_graph_keeps_no_gradient():
    x = torch.randn(1, 64, 8, requires_grad=True)
    idx = ops.dense_knn_graph(x * 2.0, 8)
    assert not idx.requires_grad and idx.grad_fn is None


@pytest.mark.parametrize("dilation", [1, 2, 5])
def test_dilate_neighbors_strided_equals_jax(dilation):
    idx = np.random.default_rng(dilation).integers(0, 500, (2, 40, 4 * dilation)).astype(np.int32)
    want = np.asarray(jops.dilate_neighbors(jnp.asarray(idx), dilation))
    np.testing.assert_array_equal(ops.dilate_neighbors(torch.from_numpy(idx), dilation).numpy(),
                                  want)
    # stochastic without a draw or a generator, or not in training: strided
    got = ops.dilate_neighbors(torch.from_numpy(idx), dilation, stochastic=True, epsilon=1.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dilate_neighbors_with_the_draws_passed_in():
    """The JAX body with its two draws replaced by given values: u below
    epsilon takes the permuted columns, above it the strided ones."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 500, (2, 40, 12)).astype(np.int32)
    perm = rng.permutation(12)
    t = torch.from_numpy(idx)
    taken = ops.dilate_neighbors(t, 3, stochastic=True, epsilon=0.2,
                                 draws=(0.1, torch.from_numpy(perm)))
    np.testing.assert_array_equal(taken.numpy(), np.take(idx, perm[:4], axis=-1))
    kept = ops.dilate_neighbors(t, 3, stochastic=True, epsilon=0.2,
                                draws=(0.7, torch.from_numpy(perm)))
    np.testing.assert_array_equal(kept.numpy(), idx[..., ::3])
    g1 = ops.dilate_neighbors(t, 3, stochastic=True, epsilon=1.0,
                              generator=torch.Generator().manual_seed(4))
    g2 = ops.dilate_neighbors(t, 3, stochastic=True, epsilon=1.0,
                              generator=torch.Generator().manual_seed(4))
    assert torch.equal(g1, g2) and g1.shape == (2, 40, 4)
    assert set(g1[0, 0].tolist()) <= set(idx[0, 0].tolist())


# --- the model against JAX ------------------------------------------------------

@pytest.fixture(scope="module")
def small_case():
    """[2, 256, 9] points, JAX-initialised 5-block model with random
    BatchNorm statistics, JAX logits, graphs and, on those graphs, the
    points' gradient of Σ w · logits (w from a seed)."""
    rng = np.random.default_rng(11)
    pts = rng.random((2, 256, 9)).astype(np.float32)
    w = rng.standard_normal((2, 256, 13)).astype(np.float32)
    model = JaxDenseDeepGCN(**SMALL)
    flat = _with_random_stats(_flat(jax.jit(model.init)(jax.random.PRNGKey(1),
                                                         jnp.asarray(pts))), 2)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    logits, graphs = jax.jit(lambda v, p: model.apply(v, p, collect_graphs=True))(
        variables, jnp.asarray(pts))
    # on the graphs collected above: jit fuses the gradient's program
    # another way, and its own graphs could differ at a near-tie
    grad = jax.jit(jax.grad(lambda p: jnp.sum(model.apply(variables, p, graphs=graphs) * w)))(
        jnp.asarray(pts))
    return {"pts": pts, "w": w, "flat": flat, "logits": np.asarray(logits),
            "graphs": [np.asarray(g) for g in graphs], "grad": np.asarray(grad)}


def _rows_apart(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor):
    """(rows of two kNN graphs of ``x`` that differ, of them the rows where
    the difference is not a near-tie). A row's difference is a near-tie
    when ``got`` holds no index twice and the distances of ``got``'s
    neighbours equal those of ``want``'s position by position within
    4 ulp of |q|² + the largest |p|² of those neighbours, the scale of a
    distance's rounding: another summation order of the features may swap
    neighbours only inside such a run. The rule of ROADMAP's watch list
    where bit-equality cannot be reached; ``chip_smoke.py`` applies it
    card vs CPU."""
    from pointsecguard_tpu_torch.ops.distance import square_distance

    rows = (got != want).any(-1).nonzero()
    bad = 0
    for b, s in rows.tolist():
        d = square_distance(x[b : b + 1, s : s + 1], x[b : b + 1])[0, 0]
        g, w = got[b, s], want[b, s]
        scale = (x[b, s] ** 2).sum() + (x[b, torch.cat([g, w])] ** 2).sum(-1).max()
        apart = (d[g] - d[w]).abs().max() > 4 * torch.finfo(torch.float32).eps * scale
        if apart or g.unique().numel() < g.numel():
            bad += 1
    return int(rows.shape[0]), bad


def _chip_smoke_near_tie_check():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.near_tie_check


@pytest.mark.parametrize("checker", ["test", "chip_smoke"])
@pytest.mark.parametrize("got,bad", [
    ([0, 1, 2, 3], 0),  # equal
    ([0, 2, 1, 3], 0),  # the tied pair swapped
    ([0, 1, 2, 4], 1),  # a wrong neighbour in a row that also holds a tie
    ([0, 1, 1, 3], 1),  # one neighbour twice
])
def test_near_tie_rule_excuses_only_the_tied_positions(checker, got, bad):
    """Query 0 at the origin; points 1 and 2 tie at distance 1, then 3, 4
    at 4 and 9. A differing row passes only where it differs inside the
    tie, whatever other ties the row holds."""
    check = _rows_apart if checker == "test" else _chip_smoke_near_tie_check()
    x = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [2.0, 0.0], [3.0, 0.0]]])
    want = torch.tensor([[[0, 1, 2, 3]]])
    differ = int(got != [0, 1, 2, 3])
    assert check(x, torch.tensor([[got]]), want) == (differ, bad)


def _pinned_run(small_case):
    """The port on JAX's graphs: its logits, the input features of every
    block (hooks), and the points' gradient of Σ w · logits."""
    model = _port(small_case["flat"], **SMALL).requires_grad_(False)
    inputs = {}
    for i, blk in enumerate(model.backbone):
        blk.register_forward_pre_hook(lambda m, a, i=i: inputs.__setitem__(i, a[0].detach()))
    p = torch.from_numpy(small_case["pts"]).requires_grad_(True)
    logits = model(p, graphs=tuple(torch.from_numpy(g) for g in small_case["graphs"]))
    (logits * torch.from_numpy(small_case["w"])).sum().backward()
    return logits.detach().numpy(), inputs, p.grad.numpy()


def test_graphs_equal_jax_on_both_routes(small_case):
    """Each block's graph, built by the port from the features it reaches
    on JAX's upstream graphs, equals JAX's except in near-tie rows
    (``_rows_apart``): the features come through float32 sums that round
    one way in XLA and another in torch (which also changes with its
    thread count). Upstream graphs are pinned, so that one near-tie does
    not cascade into every later block."""
    _, inputs, _ = _pinned_run(small_case)
    pts = torch.from_numpy(small_case["pts"])
    # head k = 16 over xyz: xyz is the input itself, so exactly equal
    np.testing.assert_array_equal(ops.dense_knn_graph(pts[..., :3], 16).numpy(),
                                  small_case["graphs"][0])
    differ = 0
    for i in range(1, 5):  # k·d = 16, 32, 48 (fused route), 64 (the sort)
        got = ops.dilate_neighbors(ops.dense_knn_graph(inputs[i - 1], 16 * i), i)
        assert got.shape == (2, 256, 16)
        d, bad = _rows_apart(inputs[i - 1], got,
                             torch.from_numpy(small_case["graphs"][i]))
        assert bad == 0, f"graph {i}: {bad} of {d} differing rows are not near-ties"
        differ += d
    assert differ <= 4  # of 2048 rows


def test_train_mode_graphs_equal_jax(small_case):
    """In training mode (batch statistics), the same per-block rule."""
    model = JaxDenseDeepGCN(**SMALL)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                for k, v in small_case["flat"].items()})
    (_, want), _ = model.apply(variables, jnp.asarray(small_case["pts"]), train=True,
                               collect_graphs=True, mutable=["batch_stats"])
    port = _port(small_case["flat"], **SMALL).train()
    inputs = {}
    for i, blk in enumerate(port.backbone):
        blk.register_forward_pre_hook(lambda m, a, i=i: inputs.__setitem__(i, a[0]))
    with torch.no_grad():
        port(torch.from_numpy(small_case["pts"]),
             graphs=tuple(torch.from_numpy(np.asarray(g)) for g in want))
        differ = 0
        for i in range(1, 5):
            got = ops.dilate_neighbors(ops.dense_knn_graph(inputs[i - 1], 16 * i), i)
            d, bad = _rows_apart(inputs[i - 1], got, torch.from_numpy(np.asarray(want[i])))
            assert bad == 0, f"graph {i}: {bad} of {d} differing rows are not near-ties"
            differ += d
    assert differ <= 4


def test_logits_and_gradient_match_jax_on_its_graphs(small_case):
    """On JAX's graphs: logits within 1e-4 of JAX's; the colour gradient,
    and the whole points' gradient, within 1e-5 of JAX's in relative L2
    (float32 sums in other orders)."""
    logits, _, grad = _pinned_run(small_case)
    np.testing.assert_allclose(logits, small_case["logits"], atol=1e-4)
    got, want = grad[..., 3:6], small_case["grad"][..., 3:6]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    assert np.linalg.norm(grad - small_case["grad"]) / np.linalg.norm(small_case["grad"]) < 1e-5


def test_collected_graphs_pinned_give_the_same_logits(small_case):
    model = _port(small_case["flat"], **SMALL)
    pts = torch.from_numpy(small_case["pts"])
    with torch.no_grad():
        logits, graphs = model(pts, collect_graphs=True)
        assert torch.equal(model(pts, graphs=graphs), logits)


@pytest.mark.parametrize("variant", [dict(conv="mr"), dict(block="dense"), dict(block="plain"),
                                     dict(conv="mr", block="dense")])
def test_variants_match_jax(variant):
    """MRConv, the dense (concatenating) and plain backbones: logits (on
    JAX's graphs and on the port's own) and graphs against JAX on
    [2, 128, 9], 4 blocks, k = 8."""
    kw = dict(n_blocks=4, n_filters=8, k=8, **variant)
    pts = np.random.default_rng(7).random((2, 128, 9)).astype(np.float32)
    model = JaxDenseDeepGCN(**kw)
    flat = _with_random_stats(_flat(jax.jit(model.init)(jax.random.PRNGKey(2),
                                                         jnp.asarray(pts))), 3)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    want, want_graphs = model.apply(variables, jnp.asarray(pts), collect_graphs=True)
    port = _port(flat, **kw)
    with torch.no_grad():
        got, graphs = port(torch.from_numpy(pts), collect_graphs=True)
        pinned = port(torch.from_numpy(pts),
                      graphs=tuple(torch.from_numpy(np.asarray(g)) for g in want_graphs))
    np.testing.assert_allclose(pinned.numpy(), np.asarray(want), atol=1e-4)
    # 128 points of 8 narrow features: no near-tie at these seeds
    for g, wg in zip(graphs, want_graphs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert resgcn_to_jax_variables(port.state_dict(), kw.get("conv", "edge")).keys() == flat.keys()


# --- weights ------------------------------------------------------------------

def test_full_width_leaves_and_round_trip():
    """The full-width model's 188 flax leaves (``jax.eval_shape``, no
    compute) fill the port's 3,651,469 floats one to one, and weights go
    there and back unchanged."""
    shapes = jax.eval_shape(JaxDenseDeepGCN().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 512, 9), jnp.float32))
    flat_shapes = {k: v.shape for k, v in flatten_dict(shapes, sep="/").items()}
    assert len(flat_shapes) == 188
    assert len(resgcn_module_map()) == 28 * 2 + 3 * 2 + 1
    rng = np.random.default_rng(0)
    flat = {k: rng.standard_normal(s).astype(np.float32) for k, s in flat_shapes.items()}
    sd = resgcn_from_jax_variables(flat)
    assert len(sd) == 188 and sum(t.numel() for t in sd.values()) == 3_651_469
    model = DenseDeepGCN()
    model.load_state_dict(sd)
    back = resgcn_to_jax_variables(model.state_dict())
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_convert_refuses_leaves_it_cannot_place():
    flat = _flat(JaxDenseDeepGCN(n_blocks=3, n_filters=8, k=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 9))))
    with pytest.raises(ValueError, match="unconsumed"):
        resgcn_from_jax_variables({**flat, "params/Extra_0/kernel": np.zeros((2, 2))})
    del flat["params/BasicConv_1/Dense_0/bias"]
    with pytest.raises(ValueError, match="missing"):
        resgcn_from_jax_variables(flat)


def test_train_mode_dropout_from_a_generator_or_given():
    """With ``dropout`` > 0 the head's 256 features are kept where the mask
    is true and scaled by 1 / (1 − rate), the mask drawn from the generator
    when none is given; evaluation mode applies none."""
    model = DenseDeepGCN(n_blocks=2, n_filters=8, k=4, dropout=0.5)
    pts = torch.from_numpy(np.random.default_rng(1).random((2, 64, 9)).astype(np.float32))
    seen = {}
    model.cls.register_forward_hook(lambda m, i, o: seen.__setitem__("x", i[0]))
    model.pred[1].register_forward_hook(lambda m, i, o: seen.__setitem__("f", o))
    model.train()
    a = model(pts, generator=torch.Generator().manual_seed(4))
    b = model(pts, generator=torch.Generator().manual_seed(4))
    c = model(pts, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    mask = torch.from_numpy(np.random.default_rng(2).random((2, 64, 256)) < 0.5)
    model(pts, dropout_mask=mask)
    assert torch.equal(seen["x"], torch.where(mask, 2 * seen["f"], torch.zeros_like(seen["f"])))
    model.eval()
    model(pts)
    assert torch.equal(seen["x"], seen["f"])


def test_stochastic_dilation_only_in_training_with_epsilon():
    """epsilon 0 (the config's) always takes the strided graph; with
    epsilon 1 in training the generator's draw replaces it, in evaluation
    never."""
    pts = torch.from_numpy(np.random.default_rng(5).random((1, 96, 9)).astype(np.float32))
    ref = DenseDeepGCN(n_blocks=3, n_filters=8, k=4)
    rnd = DenseDeepGCN(n_blocks=3, n_filters=8, k=4, epsilon=1.0)
    rnd.load_state_dict(ref.state_dict())
    for m in (ref, rnd):
        m.train()
    gen = torch.Generator().manual_seed(0)
    _, g_ref = ref(pts, collect_graphs=True, generator=gen)
    _, g_rnd = rnd(pts, collect_graphs=True, generator=gen)
    # dilation 1 draws too, as in JAX: the same neighbours in another order
    assert torch.equal(g_ref[1].sort(-1)[0], g_rnd[1].sort(-1)[0])
    assert not torch.equal(g_ref[2], g_rnd[2])
    rnd.eval()
    ref.eval()
    assert torch.equal(rnd(pts, collect_graphs=True, generator=gen)[1][2],
                       ref(pts, collect_graphs=True)[1][2])
