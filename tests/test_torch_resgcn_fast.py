"""ResGCN's ``--resgcn_fast`` in the port against the JAX package on the
CPU: ``DenseDeepGCN(dilated_mode="subsample", knn_strategy="approx")``
(``models/resgcn.py``), ``ops.knn`` under each of JAX's strategy names,
the weight map, and ``cli.attack`` / ``cli.eval --resgcn_fast``.

The model is 6 blocks wide 16 with k = 16 over [2, 64, 9] points: blocks
of dilation 2–5 search the stride-d candidates (32, 22, 16 and 13 of them),
so the last one has fewer candidates than k and ``repeat_pad_k`` fills its
lists. Inputs are drawn from numpy seeds; weights are JAX-initialised and
cross through ``resgcn_from_jax_variables``. Graphs are held under the
near-tie rule of tests/test_torch_resgcn.py, logits within ``LOGITS_ATOL``
(float32 sums of another order, on logits of magnitude ~30).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu import ops as jops
from pointsecguard_tpu.configs import resgcn_overrides as jax_overrides
from pointsecguard_tpu.models import DenseDeepGCN as JaxDenseDeepGCN
from pointsecguard_tpu_torch import ops
from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.configs import resgcn_overrides
from pointsecguard_tpu_torch.data import make_synthetic_rooms
from pointsecguard_tpu_torch.models import DenseDeepGCN
from pointsecguard_tpu_torch.models.resgcn import DynConv
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.convert import resgcn_from_jax_variables

FAST = dict(dilated_mode="subsample", knn_strategy="approx")
SMALL = dict(n_blocks=6, n_filters=16, k=16)
N = 64
LOGITS_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(variables) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(variables, sep="/").items()}


def _near_tie_check():
    """``chip_smoke.near_tie_check``: the rule of tests/test_torch_resgcn.py."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.near_tie_check


@pytest.fixture(scope="module")
def case():
    """JAX's subsample model on [2, 64, 9] points with random BatchNorm
    statistics: its weights, logits and graphs."""
    rng = np.random.default_rng(21)
    pts = rng.random((2, N, 9)).astype(np.float32)
    model = JaxDenseDeepGCN(**SMALL, **FAST)
    flat = _flat(jax.jit(model.init)(jax.random.PRNGKey(5), jnp.asarray(pts)))
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    logits, graphs = jax.jit(lambda v, p: model.apply(v, p, collect_graphs=True))(
        variables, jnp.asarray(pts))
    return {"pts": pts, "flat": flat, "logits": np.asarray(logits),
            "graphs": [np.array(g) for g in graphs]}


def _port(flat: dict, **kw) -> DenseDeepGCN:
    model = DenseDeepGCN(**SMALL, **kw)
    model.load_state_dict(resgcn_from_jax_variables(flat))
    return model.eval()


def test_subsample_mode_adds_no_parameter(case):
    """The JAX trees of the exact and subsample models are one tree (the
    exact one initialised where its k·d fits), and the port's state dict
    is the same in both modes: ``utils/convert.py`` carries a JAX
    subsample checkpoint across unchanged."""
    exact = _flat(jax.jit(JaxDenseDeepGCN(**SMALL).init)(jax.random.PRNGKey(5),
                                                         jnp.zeros((1, 128, 9))))
    assert {k: v.shape for k, v in exact.items()} == \
        {k: v.shape for k, v in case["flat"].items()}
    sd = resgcn_from_jax_variables(case["flat"])
    for mode in ({}, FAST):
        own = DenseDeepGCN(**SMALL, **mode).state_dict()
        assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in sd.items()}


def test_graphs_equal_jax(case):
    """Every block's graph from the features it reaches on JAX's upstream
    graphs: block 0 (d = 1) the dense k = 16 graph, blocks 1–5 the k
    nearest of the stride-d candidates as whole-cloud indices, the last
    one padded by repetition (13 candidates) — equal to JAX's but in
    near-tie rows."""
    model = _port(case["flat"], **FAST)
    inputs = {}
    for i, blk in enumerate(model.backbone):
        blk.register_forward_pre_hook(lambda m, a, i=i: inputs.__setitem__(i, a[0]))
    with torch.no_grad():
        model(torch.from_numpy(case["pts"]),
              graphs=tuple(torch.from_numpy(g) for g in case["graphs"]))
    check = _near_tie_check()
    for i, blk in enumerate(model.backbone):
        with torch.no_grad():
            _, got = blk(inputs[i])
        want = torch.from_numpy(case["graphs"][1 + i])
        assert got.shape == (2, N, 16) and got.dtype == torch.int32
        d = blk.dilation
        k_eff = min(16, -(-N // d))
        if d > 1:
            assert (got % d == 0).all()  # indices of stride-d candidates
        if k_eff < 16:  # the list repeated to width k
            assert torch.equal(got, ops.repeat_pad_k(got[..., :k_eff], 16))
        rows, bad = check(inputs[i], got[..., :k_eff], want[..., :k_eff])
        assert bad == 0, f"block {i}: {bad} of {rows} differing rows are not near-ties"


def test_logits_equal_jax(case):
    """The port's own forward (its graphs built as it goes) and the forward
    on JAX's graphs: logits within ``LOGITS_ATOL`` of JAX's; the graphs it
    collects equal JAX's."""
    model = _port(case["flat"], **FAST)
    with torch.no_grad():
        logits, graphs = model(torch.from_numpy(case["pts"]), collect_graphs=True)
        pinned = model(torch.from_numpy(case["pts"]),
                       graphs=tuple(torch.from_numpy(g) for g in case["graphs"]))
    for got, want in zip(graphs, case["graphs"]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(logits.numpy(), case["logits"], atol=LOGITS_ATOL)
    np.testing.assert_allclose(pinned.numpy(), case["logits"], atol=LOGITS_ATOL)
    assert np.abs(case["logits"]).max() > 1.0


def test_subsample_graph_carries_no_gradient_and_no_draw(case):
    """The graph is built from ``x.detach()``; in training with ε > 0 the
    subsample blocks draw nothing (JAX draws only in exact mode)."""
    blk = DynConv(16, 16, k=16, dilation=3, conv="edge", epsilon=1.0, **FAST).train()
    x = torch.randn(2, N, 16, requires_grad=True)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    _, idx = blk(x * 2.0, generator=gen)
    assert idx.grad_fn is None and torch.equal(gen.get_state(), state)
    assert torch.equal(idx, DynConv(16, 16, k=16, dilation=3, conv="edge", epsilon=0.0,
                                    **FAST)(x)[1])


@pytest.mark.parametrize("strategy", ["auto", "approx", "topk", "iterative", "twostage"])
@pytest.mark.parametrize("k", [16, 64])
def test_knn_strategy_equals_jax(strategy, k):
    """``ops.knn`` under each of JAX's strategy names against JAX's same
    strategy on the CPU: queries [2, 100, 64] against 300 candidates;
    approx at k = 64 takes the exact selection (the kernel's k is 48)."""
    rng = np.random.default_rng(k)
    q = rng.standard_normal((2, 100, 64)).astype(np.float32)
    p = rng.standard_normal((2, 300, 64)).astype(np.float32)
    if strategy == "auto" and k > 48:
        strategy = "pallas"  # the port's exact route for any k
        want = jops.knn(jnp.asarray(q), jnp.asarray(p), k, strategy="topk")
    else:
        want = jops.knn(jnp.asarray(q), jnp.asarray(p), k, strategy=strategy)
    got = ops.knn(torch.from_numpy(q), torch.from_numpy(p), k, strategy=strategy)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-4)


def test_overrides_equal_jax():
    """``--resgcn_fast`` sets JAX's two overrides; with another model it is
    refused with the other ``--resgcn_*`` flags."""
    import argparse

    for ns in (dict(resgcn_fast=True), dict(resgcn_fast=True, resgcn_blocks=7)):
        args = argparse.Namespace(**ns)
        assert resgcn_overrides(args) == jax_overrides(args)
    args = attack_cli._parser().parse_args(["--model", "pointnet2", "--resgcn_fast"])
    with pytest.raises(SystemExit, match="--resgcn_\\* with --model pointnet2"):
        attack_cli._refuse_unported(args)


@pytest.fixture(scope="module")
def log(tmp_path_factory):
    """Synthetic rooms and a seeded 3-block ResGCN (8 filters, k = 4) as
    a port checkpoint."""
    root = tmp_path_factory.mktemp("resgcn_fast")
    make_synthetic_rooms(str(root / "data"), points_per_room=3000, seed=0)
    torch.manual_seed(0)
    save_checkpoint(str(root / "log"), DenseDeepGCN(n_blocks=3, n_filters=8, k=4).state_dict())
    return root


SMALL_FLAGS = ["--model", "resgcn", "--resgcn_blocks", "3", "--resgcn_filters", "8",
               "--resgcn_k", "4", "--device", "cpu", "--num_point", "128"]


def _spy(monkeypatch) -> list:
    calls = []
    real = DynConv._subsample_graph
    monkeypatch.setattr(DynConv, "_subsample_graph",
                        lambda self, x: calls.append(self.dilation) or real(self, x))
    return calls


@pytest.mark.parametrize("cli", ["attack", "eval"])
def test_cli_runs_resgcn_fast(log, cli, monkeypatch):
    """``cli.attack --attack nb`` and ``cli.eval`` with ``--resgcn_fast``, no
    longer refused: the model they build searches block 1's stride-2
    candidates in every forward; the metrics are finite."""
    calls = _spy(monkeypatch)
    common = SMALL_FLAGS + ["--data_root", str(log / "data"), "--log_dir", str(log / "log"),
                            "--resgcn_fast"]
    if cli == "attack":
        clean, adv = attack_cli.main(common + ["--attack", "nb", "--max_blocks", "4",
                                               "--batch_size", "4"])
        assert np.isfinite(adv.accuracy) and np.isfinite(clean.accuracy)
        assert (log / "log" / "resgcn_nb_area5.tsv").exists()
    else:
        metrics = eval_cli.main(common + ["--num_votes", "1", "--batch_size", "8"])
        assert np.isfinite(metrics.accuracy)
    assert calls and set(calls) == {2}
