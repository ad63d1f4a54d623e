"""What the redesigned kernels' wrappers take and refuse.

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
from pointsecguard_tpu_torch.ops.cuda import attentive, bottomk, fps, knn


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


@pytest.mark.parametrize("shape,dtype,npoint,start_shape,match", [
    ((1, 8193, 3), torch.float32, 4, (1,), "N=8193 outside"),
    ((2, 0, 3), torch.float32, 4, (2,), "N=0 outside"),
    ((2, 16, 3), torch.float64, 4, (2,), "want float32"),
    ((2, 16, 3), torch.float16, 4, (2,), "want float32"),
    ((2, 16, 2), torch.float32, 4, (2,), "want float32 .B, N, 3."),
    ((16, 3), torch.float32, 4, (2,), "want float32 .B, N, 3."),
    ((2, 16, 3), torch.float32, 0, (2,), "npoint=0"),
    ((2, 16, 3), torch.float32, 4, (3,), "start must be"),
    ((2, 16, 3), torch.float32, 4, (2, 1), "start must be"),
])
def test_fps_refuses_on_the_cpu_what_the_card_refuses(shape, dtype, npoint, start_shape, match):
    before = fps.launches
    with pytest.raises(ValueError, match=match):
        fps.fps(torch.zeros(shape, dtype=dtype), npoint,
                torch.zeros(start_shape, dtype=torch.int32))
    assert fps.launches == before


@pytest.mark.parametrize("n,npoint,start", [
    (8192, 8, 8191),  # N at the limit, the start at N - 1
    (1, 4, 0),        # N = 1: every pick is index 0
    (1000, 64, 7),    # N off 32
    (33, 40, 32),     # npoint > N: wraps onto index 0
])
def test_fps_takes_and_cpu_equals_plain(n, npoint, start):
    rng = np.random.default_rng(n)
    xyz = torch.from_numpy(np.round(rng.random((2, n, 3)) * 8).astype(np.float32) / 8)
    st = torch.full((2,), start, dtype=torch.int32)
    before = fps.launches
    got = fps.fps(xyz, npoint, st)
    assert fps.launches == before
    assert got.dtype == torch.int32 and got.shape == (2, npoint)
    assert torch.equal(got, fps.fps_plain(xyz, npoint, st))
    assert (got[:, 0] == start).all() and (got < n).all() and (got >= 0).all()
    if npoint > n:  # once every point is chosen all distances are 0
        assert (got[:, n:] == 0).all()


@pytest.mark.parametrize("q_shape,p_shape,k,match", [
    ((2, 8, 3), (2, 16, 3), 17, "k=17 outside"),
    ((2, 8, 3), (2, 64, 3), 49, "k=49 outside"),
    ((2, 8, 3), (2, 16, 3), 0, "k=0 outside"),
    ((2, 8, 3), (3, 16, 3), 4, "want query"),
    ((2, 8, 3), (2, 16, 4), 4, "want query"),
    ((8, 3), (2, 16, 3), 4, "want query"),
])
def test_knn_refuses(q_shape, p_shape, k, match):
    before = knn.launches
    with pytest.raises(ValueError, match=match):
        knn.knn(torch.zeros(q_shape), torch.zeros(p_shape), k)
    assert knn.launches == before


@pytest.mark.parametrize("S,N,D,k", [
    (1, 1, 3, 1),        # one query, one point
    (7, 16, 3, 16),      # k == N
    (100, 4099, 3, 16),  # N off every tile and group of the kernel
    (33, 300, 3, 48),    # k at its limit
    (5, 40, 64, 8),      # a feature-space search
])
def test_knn_takes_and_cpu_equals_plain(S, N, D, k):
    rng = np.random.default_rng(S + N)
    pts = torch.from_numpy(np.round(rng.random((2, N, D)) * 4).astype(np.float32) / 4)
    q = pts[:, :S].contiguous()
    before = knn.launches
    gv, gi = knn.knn(q, pts, k)
    assert knn.launches == before
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    assert gv.shape == gi.shape == (2, S, k)
    d = ((q[:, :, None, :].double() - pts[:, None, :, :].double()) ** 2).sum(-1)
    want = np.argsort(d.numpy(), axis=-1, kind="stable")[..., :k]
    # quarter-grid coordinates: every distance is exact, so ties are exact
    np.testing.assert_array_equal(gi.numpy(), want)
    np.testing.assert_array_equal(gv.numpy(), np.take_along_axis(d.numpy(), want, -1))
