"""Parity of the port's kNN and wide-row bottom-k with the JAX package, on
the CPU.

Same numpy inputs through the jitted JAX op and its port; the port runs
its kernels' plain versions (CPU tensors). Indices must be equal and
distances bit-equal (the port's ``square_distance`` rounds as the jitted
JAX op does on the CPU). The plain versions are also held against the
Pallas kernel bodies (``_knn_kernel``, ``_chunked_kernel``) run by the
Pallas interpreter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pointsecguard_tpu import ops as jops
from pointsecguard_tpu.ops.pallas import bottomk as jbk
from pointsecguard_tpu.ops.pallas import knn as jknn
from pointsecguard_tpu.ops.selection import bottom_k_indices as jax_bottom_k_indices
from pointsecguard_tpu_torch import ops as tops
from pointsecguard_tpu_torch.ops import cuda as tcuda
from pointsecguard_tpu_torch.ops.cuda import bottomk_chunked as tbkc
from pointsecguard_tpu_torch.ops.cuda import knn as tknn


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cloud(kind: str, B: int, N: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.random((B, N, 3)) * 3).astype(np.float32)
    if kind == "rounded":  # exactly tied distances
        x = np.round(x * 4) / 4
    elif kind == "duplicated":  # the sampler's up-sampled repeats
        x[:, N // 2 :] = x[:, : N - N // 2]
    return x


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _chunked_interpret(vals: np.ndarray, k: int):
    """bottom_k_pallas_chunked with interpret=True (the TPU kernel body)."""
    B, S, N = vals.shape
    n_pad = -(-N // jbk._W) * jbk._W
    v = jnp.pad(jnp.asarray(vals), ((0, 0), (0, 0), (0, n_pad - N)),
                constant_values=jbk._BIG)
    C = n_pad // jbk._W
    k_sel = min(k, C)
    R = jbk._row_block_chunked(S, n_pad, k_sel)
    spec = pl.BlockSpec((1, R, k), lambda b, s: (b, s, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(jbk._chunked_kernel, k, k_sel),
        grid=(B, S // R),
        in_specs=[pl.BlockSpec((1, R, C, jbk._W), lambda b, s: (b, s, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((B, S, k), jnp.float32),
                   jax.ShapeDtypeStruct((B, S, k), jnp.int32)),
        interpret=True,
    )(v.reshape(B, S, C, jbk._W))
    return np.asarray(out[0]), np.asarray(out[1])


def _knn_interpret(q: np.ndarray, p: np.ndarray, k: int):
    """knn_pallas with interpret=True: its own host preparation, the
    ``_knn_kernel`` body run by the interpreter."""
    B, S, D = q.shape
    N = p.shape[1]
    n_pad = -(-N // jbk._W) * jbk._W
    s2 = jnp.sum(jnp.asarray(q) ** 2, axis=-1)[..., None]
    d2 = jnp.pad(jnp.sum(jnp.asarray(p) ** 2, axis=-1)[:, None, :],
                 ((0, 0), (0, 0), (0, n_pad - N)), constant_values=jbk._BIG)
    pt = jnp.swapaxes(jnp.pad(jnp.asarray(p), ((0, 0), (0, n_pad - N), (0, 0))), 1, 2)
    k_sel = min(k, n_pad // jbk._W)
    R = 8
    spec = pl.BlockSpec((1, R, k), lambda b, s: (b, s, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(jknn._knn_kernel, k, k_sel),
        grid=(B, S // R),
        in_specs=[
            pl.BlockSpec((1, R, D), lambda b, s: (b, s, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, D, n_pad), lambda b, s: (b, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, R, 1), lambda b, s: (b, s, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, n_pad), lambda b, s: (b, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((B, S, k), jnp.float32),
                   jax.ShapeDtypeStruct((B, S, k), jnp.int32)),
        interpret=True,
    )(jnp.asarray(q), pt, s2, d2)
    return np.asarray(out[0]), np.asarray(out[1])


@pytest.mark.parametrize("tile", [None, 128])
@pytest.mark.parametrize("N,S,k", [(512, 512, 16), (512, 128, 1), (2048, 2048, 16)])
@pytest.mark.parametrize("kind", ["uniform", "rounded", "duplicated"])
def test_knn_matches_jax(kind, N, S, k, tile):
    pts = _cloud(kind, 2, N, seed=N + k)
    q = pts[:, :S]
    wv, wi = jax.jit(lambda a, b: jops.knn(a, b, k, tile=tile))(q, pts)
    for strategy in ("auto", "pallas"):  # the fused and the tiled route
        gv, gi = tops.knn(_t(q), _t(pts), k, tile=tile, strategy=strategy)
        assert gi.dtype == torch.int32 and gv.dtype == torch.float32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("k_eff,k", [(3, 16), (8, 16), (16, 16), (20, 16), (1, 4)])
def test_repeat_pad_k_matches_jax(k_eff, k):
    idx = np.random.default_rng(k_eff).integers(0, 50, (2, 7, k_eff)).astype(np.int32)
    np.testing.assert_array_equal(tops.repeat_pad_k(_t(idx), k).numpy(),
                                  np.asarray(jops.repeat_pad_k(jnp.asarray(idx), k)))


@pytest.mark.parametrize("kind,N,k", [("uniform", 700, 8), ("rounded", 700, 16),
                                      ("uniform", 300, 1)])
def test_knn_plain_matches_pallas_kernel_body(kind, N, k):
    pts = _cloud(kind, 2, N, seed=7)
    q = pts[:, :16]
    wv, wi = _knn_interpret(q, pts, k)
    gv, gi = tknn.knn_plain(_t(q), _t(pts), k)
    np.testing.assert_array_equal(gi.numpy(), wi)
    if kind == "rounded":  # quarter-grid coordinates: every step is exact
        np.testing.assert_array_equal(gv.numpy(), wv)
    else:  # the interpreter's dot may round the cross term differently
        np.testing.assert_allclose(gv.numpy(), wv, atol=1e-5)


@pytest.mark.parametrize("B,S,N,k", [
    (1, 8, 512, 4),
    (2, 16, 1000, 16),  # N padded to whole chunks
    (1, 8, 256, 20),  # k above the chunk count: every chunk is gathered
    (1, 8, 8200, 48),  # wide row, k at its limit
    (1, 8, 9000, 16),  # wide row, padded
])
def test_chunked_plain_matches_pallas_kernel_body(B, S, N, k):
    rng = np.random.default_rng(B * 1000 + N + k)
    # coarse rounding: many duplicates, so the tie-break paths run
    x = (np.round(rng.standard_normal((B, S, N)) * 20) / 20).astype(np.float32)
    wv, wi = _chunked_interpret(x, k)
    gv, gi = tbkc.bottom_k_chunked(_t(x), k)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gv.numpy(), wv)


def test_chunked_plain_coverage_adversarial():
    """All bottom-k values packed into one chunk plus ties across chunks:
    the worst case of the chunk-superset argument."""
    x = np.full((1, 8, 1024), 5.0, np.float32)
    x[0, :, 130:138] = 0.25  # all k minima inside chunk 1
    x[0, :, 0] = 0.25  # a tie in chunk 0 must win the first slot
    x[0, 4, 900:916] = np.arange(16) * 1e-3  # a spread row
    wv, wi = _chunked_interpret(x, 8)
    gv, gi = tbkc.bottom_k_chunked(_t(x), 8)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gv.numpy(), wv)


def test_wide_rows_route_to_the_chunked_kernel_and_match_jax(monkeypatch):
    x = np.round(np.random.default_rng(4).random((2, 8, 8193)) * 50).astype(np.float32)
    routes = []
    monkeypatch.setattr("pointsecguard_tpu_torch.ops.selection.bottom_k_chunked",
                        lambda v, k: routes.append(v.shape) or tbkc.bottom_k_chunked(v, k))
    gv, gi = tops.bottom_k_indices(_t(x), 16)
    wv, wi = jax.jit(lambda v: jax_bottom_k_indices(v, 16))(x)
    assert routes == [(2, 8, 8193)]
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("strategy", ["approx", "iterative", "twostage", "topk"])
def test_knn_refuses_unported_strategies(strategy):
    pts = _t(_cloud("uniform", 1, 64, 0))
    with pytest.raises(ValueError, match="not ported"):
        tops.knn(pts, pts, 4, strategy=strategy)


@pytest.mark.parametrize("N,k", [(64, 49), (8, 9), (8, 0)])
def test_knn_refuses_k_outside_its_bounds(N, k):
    pts = _t(_cloud("uniform", 1, N, 0))
    with pytest.raises(ValueError, match="outside"):
        tops.knn(pts, pts, k)


def test_wrappers_take_plain_on_cpu_and_count_no_launch():
    tcuda.reset_launch_counts()
    pts = _t(_cloud("uniform", 1, 300, 1))
    tops.knn(pts, pts, 16)
    tbkc.bottom_k_chunked(torch.rand(2, 9000), 16)
    assert tcuda.launch_counts() == {"fps": 0, "bottom_k": 0, "bottom_k_chunked": 0,
                                     "knn": 0, "attentive_fwd": 0, "attentive_bwd": 0}
    # neither a CPU nor a CUDA tensor: raise, never fall back
    with pytest.raises(ValueError):
        tknn.knn(pts.to("meta"), pts.to("meta"), 16)
    with pytest.raises(ValueError):
        tbkc.bottom_k_chunked(torch.rand(2, 9000, device="meta"), 16)
    assert sum(tcuda.launch_counts().values()) == 0
