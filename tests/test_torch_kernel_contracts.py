"""What the redesigned bottom-k and attentive wrappers take and refuse.

The CUDA kernels cannot run here, so these tests hold what a CPU can
see: the argument checks that stand before every launch
(`check_kernel_args`, which the wrappers call for a CUDA tensor) still
refuse what the contract refuses and pass every shape it allows, and on
CPU tensors the wrappers return the plain version's result at those
shapes without counting a launch.
"""

import numpy as np
import pytest
import torch

from pointsecguard_tpu_torch.ops.attentive import attentive_pool_fused_plain
from pointsecguard_tpu_torch.ops.cuda import attentive, bottomk


def _att(K, M, D, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    fn = torch.from_numpy(rng.standard_normal((K, M, D))).to(dtype)
    fx = torch.from_numpy(rng.standard_normal((K, M, D))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((2 * D, 2 * D)) / np.sqrt(2 * D)).to(dtype)
    return fn, fx, w


@pytest.mark.parametrize("shape,k,dtype,match", [
    ((2, 8193), 4, torch.float32, "N=8193 outside"),
    ((2, 16), 0, torch.float32, "k=0 outside"),
    ((2, 16), 17, torch.float32, "k=17 outside"),
    ((2, 16), 4, torch.float64, "want float32"),
    ((2, 16), 4, torch.int32, "want float32"),
    ((2, 0), 1, torch.float32, "N=0 outside"),
])
def test_bottom_k_refuses(shape, k, dtype, match):
    with pytest.raises(ValueError, match=match):
        bottomk.check_kernel_args(torch.zeros(shape, dtype=dtype), k)


@pytest.mark.parametrize("shape,k", [
    ((3, 8192), 8192),   # k == N at the limit (the sorting kernel)
    ((3, 8192), 1), ((3, 8192), 48),
    ((4, 5, 1), 1),      # N = 1
    ((2, 4099), 16),     # N off 4: the scalar-load kernel
    ((2, 130), 33),      # just above the warp kernel's k
    ((7, 32), 32),
])
def test_bottom_k_takes_and_cpu_equals_plain(shape, k):
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(np.round(rng.standard_normal(shape) * 4).astype(np.float32) / 4)
    bottomk.check_kernel_args(vals, k)
    before = bottomk.launches
    got_v, got_i = bottomk.bottom_k(vals, k)
    want = np.argsort(vals.numpy(), axis=-1, kind="stable")[..., :k]
    assert bottomk.launches == before
    assert got_i.dtype == torch.int32 and got_v.shape == (*shape[:-1], k)
    np.testing.assert_array_equal(got_i.numpy(), want)
    np.testing.assert_array_equal(got_v.numpy(),
                                  np.take_along_axis(vals.numpy(), want, axis=-1))


@pytest.mark.parametrize("K,M,D,dtype,match", [
    (8, 16, 8, torch.float32, "K=8"),
    (1, 16, 8, torch.float32, "K=1"),
    (16, 16, 64, torch.float32, "D=64"),
    (16, 16, 8, torch.float64, "want float32"),
    (16, 16, 8, torch.float16, "want float32"),
])
def test_attentive_refuses(K, M, D, dtype, match):
    with pytest.raises(ValueError, match=match):
        attentive.check_kernel_args(*_att(K, M, D, dtype))


def test_attentive_refuses_mismatched_shapes():
    fn, fx, w = _att(16, 8, 8)
    with pytest.raises(ValueError, match="want fn, fx"):
        attentive.check_kernel_args(fn, fx[:, :4], w)
    with pytest.raises(ValueError, match="want fn, fx"):
        attentive.check_kernel_args(fn, fx, w[:8])


@pytest.mark.parametrize("K,M,D", [
    (16, 0, 8),     # M = 0
    (16, 1, 8),
    (4, 37, 5),     # D off 4: the padded layout
    (16, 33, 1), (4, 9, 63), (16, 9, 12), (16, 65, 32),
])
def test_attentive_takes_and_cpu_equals_plain(K, M, D):
    fn, fx, w = _att(K, M, D, seed=2)
    attentive.check_kernel_args(fn, fx, w)
    before = (attentive.fwd_launches, attentive.bwd_launches)
    leaves = [t.clone().requires_grad_(True) for t in (fn, fx, w)]
    got = attentive.attentive_pool_fused(*leaves)
    want = attentive_pool_fused_plain(fn, fx, w)
    assert (attentive.fwd_launches, attentive.bwd_launches) == before
    for g, x in zip(got, want):
        assert g.shape == (M, D)
        torch.testing.assert_close(g, x, rtol=0, atol=0)
    grads = torch.autograd.grad([g.sum() for g in got], leaves, allow_unused=True)
    assert [tuple(g.shape) for g in grads] == [(K, M, D), (K, M, D), (2 * D, 2 * D)]
    assert all(torch.isfinite(g).all() for g in grads)
