"""Parity of the port's point ops with the JAX package, on the CPU.

Same numpy inputs through the jitted JAX op (the reference runs jitted:
XLA's CPU backend then fuses Σx² into FMAs, which the port's distance
reproduces) and its port; the port runs its kernels' plain versions (CPU
tensors). Selection ops must give the same
indices exactly (FPS: except where JAX's own top-two gap at the first
difference is ≤ 4 ulp); the plain versions are also held against the
Pallas kernel bodies run by the Pallas interpreter.
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
from pointsecguard_tpu.ops.pallas import fps as jfps
from pointsecguard_tpu_torch import ops as tops
from pointsecguard_tpu_torch.ops import cuda as tcuda
from pointsecguard_tpu_torch.ops.cuda import bottomk as tbk
from pointsecguard_tpu_torch.ops.cuda import fps as tfps


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
    x = rng.random((B, N, 3)).astype(np.float32)
    if kind == "rounded":  # exact duplicates and exactly tied distances
        x = np.round(x * 4) / 4
    elif kind == "padded":  # WholeSceneBlocks-style repeated points
        x[:, N // 2 :] = x[:, : N - N // 2]
    return x


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ulps(a: np.float32, b: np.float32) -> float:
    return abs(float(a) - float(b)) / float(np.spacing(np.float32(max(abs(a), abs(b)))))


def _fps_first_gap_ulps(xyz, j_idx, t_idx):
    """Per cloud where JAX and port differ: JAX's running min-distance of
    its pick vs the port's pick at the first differing step, in ulps."""
    gaps = []
    for b in np.nonzero((j_idx != t_idx).any(axis=1))[0]:
        s = int(np.argmax(j_idx[b] != t_idx[b]))
        chosen = xyz[b, j_idx[b, :s]]
        d = np.asarray(jnp.sum((xyz[b][:, None] - chosen[None]) ** 2, -1))
        md = d.min(axis=1)
        gaps.append(_ulps(md[j_idx[b, s]], md[t_idx[b, s]]))
    return gaps


def _fps_interpret(xyz: np.ndarray, npoint: int, start: np.ndarray):
    """fps_pallas with interpret=True (the TPU kernel body, on the CPU)."""
    B, N, _ = xyz.shape
    R = 8 if N % 8 == 0 else 1
    C = N // R
    xyz_t = jnp.swapaxes(jnp.asarray(xyz), 1, 2).reshape(B, 3, R, C)
    out = pl.pallas_call(
        functools.partial(jfps._fps_kernel, npoint),
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, 3, R, C), lambda b: (b, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 1), lambda b: (b, 0, 0),
                         memory_space=pltpu.SMEM),
        ],
        out_specs=pl.BlockSpec((1, 1, npoint), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, 1, npoint), jnp.int32),
        scratch_shapes=[pltpu.VMEM((R, C), jnp.float32)],
        interpret=True,
    )(xyz_t, jnp.asarray(start, jnp.int32).reshape(B, 1, 1))
    return np.asarray(out[:, 0, :])


def _bottomk_interpret(vals: np.ndarray, k: int):
    """bottom_k_pallas with interpret=True."""
    B, S, N = vals.shape
    R = jbk._row_block(S, N)
    spec = pl.BlockSpec((1, R, k), lambda b, s: (b, s, 0),
                        memory_space=pltpu.VMEM)
    v, i = pl.pallas_call(
        functools.partial(jbk._bottomk_kernel, k),
        grid=(B, S // R),
        in_specs=[pl.BlockSpec((1, R, N), lambda b, s: (b, s, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=(spec, spec),
        out_shape=(jax.ShapeDtypeStruct((B, S, k), jnp.float32),
                   jax.ShapeDtypeStruct((B, S, k), jnp.int32)),
        scratch_shapes=[pltpu.VMEM((R, N), jnp.float32)],
        interpret=True,
    )(jnp.asarray(vals))
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("kind", ["uniform", "rounded"])
def test_square_distance_bit_equal(kind):
    src, dst = _cloud(kind, 2, 300, 1), _cloud(kind, 2, 70, 2)
    want = np.asarray(jax.jit(jops.square_distance)(src, dst))
    got = tops.square_distance(_t(src), _t(dst)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_points():
    pts = np.random.default_rng(0).random((2, 50, 5)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, 50, (2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.gather_points(_t(pts), _t(idx)).numpy(),
        np.asarray(jax.jit(jops.gather_points)(pts, idx)),
    )


@pytest.mark.parametrize(
    "kind,N,npoint,start",
    [
        ("uniform", 256, 64, 0),
        ("rounded", 200, 50, 0),
        ("padded", 128, 96, 5),
        ("uniform", 40, 100, 3),  # npoint > N: wraps onto index 0
        ("rounded", 16, 48, 0),
    ],
)
def test_fps_matches_jax(kind, N, npoint, start):
    xyz = _cloud(kind, 3, N, N + npoint)
    st = np.full(3, start, np.int32)
    want = np.asarray(jax.jit(
        lambda x, s: jops.farthest_point_sample(x, npoint, start_idx=s))(xyz, st))
    got = tops.farthest_point_sample(_t(xyz), npoint, start_idx=_t(st)).numpy()
    assert got.dtype == np.int32 and got.shape == (3, npoint)
    assert all(g <= 4 for g in _fps_first_gap_ulps(xyz, want, got))
    if kind == "rounded":  # exact arithmetic: no rounding to differ on
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,npoint", [(64, 32), (32, 80), (24, 10)])
def test_fps_plain_matches_pallas_kernel_body(N, npoint):
    xyz = _cloud("rounded", 2, N, N)
    start = np.array([0, 7], np.int32)
    want = _fps_interpret(xyz, npoint, start)
    got = tfps.fps_plain(_t(xyz), npoint, _t(start)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fps_random_start_from_generator():
    xyz = _t(_cloud("uniform", 4, 50, 3))
    a = tops.farthest_point_sample(xyz, 8, generator=torch.Generator().manual_seed(5))
    b = tops.farthest_point_sample(xyz, 8, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert ((a[:, 0] >= 0) & (a[:, 0] < 50)).all()


@pytest.mark.parametrize(
    "shape,k,rounded",
    [
        ((2, 16, 100), 3, False),
        ((2, 16, 100), 32, True),
        # k == N (the ball query's sentinel padding) without ties: lax.top_k
        # on the CPU does not keep first-occurrence order among ties when k
        # nears N, so the tie order there is held against the Pallas
        # kernel body below
        ((1, 8, 40), 40, False),
        ((2, 8, 300), 48, True),
        ((1, 8, 64), 60, False),  # k > 48: the plain sort route
    ],
)
def test_bottom_k_matches_jax(shape, k, rounded):
    x = np.random.default_rng(k).standard_normal(shape).astype(np.float32)
    if rounded:
        x = np.round(x * 4) / 4
    wv, wi = jax.jit(lambda v: jops.selection.bottom_k_indices(v, k))(x)
    gv, gi = tops.bottom_k_indices(_t(x), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi.dtype == torch.int32


@pytest.mark.parametrize("S,N,k", [(8, 64, 3), (16, 128, 32), (8, 32, 32),
                                   (8, 40, 39)])
def test_bottom_k_plain_matches_pallas_kernel_body(S, N, k):
    x = np.round(np.random.default_rng(N).standard_normal((2, S, N)) * 3) / 3
    x = x.astype(np.float32)
    wv, wi = _bottomk_interpret(x, k)
    gv, gi = tbk.bottom_k_plain(_t(x), k)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


@pytest.mark.parametrize(
    "kind,N,S,radius,nsample",
    [
        ("uniform", 256, 32, 0.2, 32),
        ("rounded", 128, 16, 0.3, 32),
        ("padded", 100, 20, 0.15, 16),
        ("uniform", 20, 8, 0.5, 32),  # nsample > N: sentinel-N padding
    ],
)
def test_ball_query_matches_jax(kind, N, S, radius, nsample):
    xyz = _cloud(kind, 2, N, N)
    centers = xyz[:, :S]
    want = np.asarray(jax.jit(
        lambda a, b: jops.ball_query(radius, nsample, a, b))(xyz, centers))
    got = tops.ball_query(radius, nsample, _t(xyz), _t(centers)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["uniform", "rounded", "padded"])
def test_three_nn_plan_matches_jax(kind):
    dst, src = _cloud(kind, 2, 200, 3), _cloud(kind, 2, 50, 4)
    if kind == "padded":  # duplicate centres, as FPS wrap-around makes
        src[:, 25:] = src[:, :25]
    wi, ww = jax.jit(jops.three_nn_plan)(dst, src)
    gi, gw = tops.three_nn_plan(_t(dst), _t(src))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=1e-5)
    feats = np.random.default_rng(5).random((2, 50, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tops.apply_three_nn(_t(feats), gi, gw).numpy(),
        np.asarray(jax.jit(jops.apply_three_nn)(feats, wi, ww)), rtol=1e-5, atol=1e-7,
    )


@pytest.mark.parametrize("with_feats", [True, False])
def test_sample_and_group_matches_jax(with_feats):
    xyz = _cloud("padded", 2, 96, 9)
    feats = (np.random.default_rng(2).random((2, 96, 4)).astype(np.float32)
             if with_feats else None)
    jc, jg = jax.jit(
        lambda x, f: jops.sample_and_group(40, 0.3, 16, x, f))(xyz, feats)
    tc, tg = tops.sample_and_group(40, 0.3, 16, _t(xyz),
                                   None if feats is None else _t(feats))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_wrappers_take_plain_on_cpu_and_count_only_launches():
    tcuda.reset_launch_counts()
    xyz = _t(_cloud("uniform", 1, 32, 0))
    tfps.fps(xyz, 8, torch.zeros(1, dtype=torch.int32))
    tbk.bottom_k(torch.rand(1, 8, 32), 4)
    assert tcuda.launch_counts() == {"fps": 0, "fps_cluster": 0, "fps_stream": 0, "bottom_k": 0,
                                     "bottom_k_chunked": 0,
                                     "knn": 0, "attentive_fwd": 0, "attentive_bwd": 0}
    # neither a CPU nor a CUDA tensor: raise, never fall back
    with pytest.raises(ValueError):
        tfps.fps(xyz.to("meta"), 8, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tbk.bottom_k(torch.rand(1, 8, 32, device="meta"), 4)
    assert tcuda.launch_counts() == {"fps": 0, "fps_cluster": 0, "fps_stream": 0, "bottom_k": 0,
                                     "bottom_k_chunked": 0,
                                     "knn": 0, "attentive_fwd": 0, "attentive_bwd": 0}
