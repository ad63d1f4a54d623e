"""Parity of the port's fused attentive pooling with the JAX package, on
the CPU.

``attentive_pool_fused_plain`` (what the CPU runs, and what the CUDA
kernels are held against on the card) against the JAX
``attentive_pool_fused`` run by the Pallas interpreter: the forward at
JAX's own gate (rtol 2e-5, atol 2e-6, ``tests/test_pallas_gates.py``),
the gradients (dfn, dfx, dw) at 1e-8 + 1e-4·max|g|
(``tests/test_models.py``), both float reassociation only. The wrapper
takes the plain version for CPU tensors and counts no launch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.ops.pallas import attentive as jatt
from pointsecguard_tpu_torch.ops import attentive as tatt
from pointsecguard_tpu_torch.ops import cuda as tcuda
from pointsecguard_tpu_torch.ops.cuda import attentive as tcatt

# K × D cases; M = 70 is a multiple of neither the Pallas row tile (64 at
# K = 16, 256 at K = 4) nor the kernels' rows per block
CASES = [(k, d) for k in (4, 16) for d in (8, 32, 63)]
M = 70


def _inputs(K, D, seed):
    rng = np.random.default_rng(seed)
    fn = rng.standard_normal((K, M, D)).astype(np.float32)
    fx = rng.standard_normal((K, M, D)).astype(np.float32)
    w = (rng.standard_normal((2 * D, 2 * D)) / np.sqrt(2 * D)).astype(np.float32)
    g1 = rng.standard_normal((M, D)).astype(np.float32)
    g2 = rng.standard_normal((M, D)).astype(np.float32)
    return fn, fx, w, g1, g2


@jax.jit
def _jax_fused_and_vjp(fn, fx, w, g1, g2):
    out, vjp = jax.vjp(lambda a, b, c: jatt.attentive_pool_fused(a, b, c, True), fn, fx, w)
    return out, vjp((g1, g2))


@functools.lru_cache(maxsize=None)
def _case(K, D):
    """The inputs of one case and the JAX outputs and gradients on them
    (one interpreted program for both tests of the case)."""
    args = _inputs(K, D, seed=K * 100 + D)
    out, grads = _jax_fused_and_vjp(*args)
    return args, [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("K,D", CASES)
def test_plain_forward_matches_the_pallas_kernel(K, D):
    (fn, fx, w, _, _), want, _ = _case(K, D)
    got = tatt.attentive_pool_fused_plain(*map(torch.from_numpy, (fn, fx, w)))
    for g, j in zip(got, want):
        assert g.shape == (M, D)
        np.testing.assert_allclose(g.numpy(), j, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("K,D", CASES)
def test_plain_gradients_match_the_pallas_vjp(K, D):
    (fn, fx, w, g1, g2), _, want = _case(K, D)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (fn, fx, w)]
    afn, afx = tatt.attentive_pool_fused_plain(*leaves)
    got = torch.autograd.grad((afn, afx), leaves,
                              (torch.from_numpy(g1), torch.from_numpy(g2)))
    for name, g, j in zip(("dfn", "dfx", "dw"), got, want):
        np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                   atol=1e-8 + 1e-4 * np.abs(j).max(), err_msg=name)


def test_plain_equals_the_unfused_composition():
    """The quadrant order (tt, bt, tb, bb) against Dense(concat([fn, fx])):
    a transposed quadrant gives plausible numbers and fails only here."""
    fn, fx, w, _, _ = _inputs(16, 8, seed=3)
    x = np.concatenate([fn.transpose(1, 0, 2), fx.transpose(1, 0, 2)], axis=-1)
    ref = tatt.attentive_pool_reference(torch.from_numpy(x), torch.from_numpy(w))
    got = torch.cat(tatt.attentive_pool_fused_plain(
        *map(torch.from_numpy, (fn, fx, w))), dim=-1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-6)
    want = jatt.attentive_pool_reference(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


def test_fused_supported_is_the_jax_rule():
    for c in (2, 16, 64, 126, 127, 128, 130, 256):
        assert tatt.fused_supported(16, c) == jatt.fused_supported(16, c)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    tcuda.reset_launch_counts()
    fn, fx, w, g1, g2 = _inputs(4, 8, seed=9)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (fn, fx, w)]
    afn, afx = tcatt.attentive_pool_fused(*leaves)
    want = tatt.attentive_pool_fused_plain(*leaves)
    assert torch.equal(afn, want[0]) and torch.equal(afx, want[1])
    grads = torch.autograd.grad((afn, afx), leaves,
                                (torch.from_numpy(g1), torch.from_numpy(g2)))
    assert all(torch.isfinite(g).all() for g in grads)
    counts = tcuda.launch_counts()
    assert counts["attentive_fwd"] == 0 and counts["attentive_bwd"] == 0


def test_wrapper_rejects_bad_shapes_and_mixed_devices():
    fn = torch.zeros(4, 5, 8)
    with pytest.raises(ValueError, match=r"want fn, fx \[K, M, D\]"):
        tcatt.attentive_pool_fused(fn, torch.zeros(4, 5, 7), torch.zeros(16, 16))
    with pytest.raises(ValueError, match="want fn, fx"):
        tcatt.attentive_pool_fused(fn, fn, torch.zeros(16, 8))
    with pytest.raises(ValueError, match="unsupported devices"):
        tcatt.attentive_pool_fused(fn, fn, torch.zeros(16, 16, device="meta"))
