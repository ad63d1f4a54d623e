"""The logic of the FPS kernel's argmax, on the CPU.

``csrc/fps.cu`` finds each step's farthest point with integer warp
reductions: a running min-distance is >= 0 and a padding slot -1, so the
float's bits order as a signed int; a warp takes the max of the bits, then
the min index among the lanes that hold it; lane 0 of each warp writes
that pair, and every warp reduces the pairs the same way. The kernel
cannot run here. These tests hold the arithmetic it rests on — the bits'
order, the two-level reduction with the kernel's layout (point i on
thread i % T, slot i // T) — equal to ``torch.argmax``'s first occurrence,
and a whole FPS run through that argmax equal to ``fps_plain``.
"""

import numpy as np
import pytest
import torch

from pointsecguard_tpu_torch.ops.cuda import fps as tfps

INT_MAX = np.iinfo(np.int32).max
PAD = np.float32(-1.0)


def _bits_argmax(md: torch.Tensor) -> int:
    """Max of the bits as int32, then the lowest index that holds it."""
    bits = md.view(torch.int32)
    m = bits.max()
    return int(torch.nonzero(bits == m)[0, 0])


def _kernel_argmax(md: np.ndarray, threads: int) -> int:
    """The kernel's argmax of one cloud's min-distances: per thread over
    its slots (strict >, ascending index), per warp, then over the warps."""
    n = len(md)
    slots = -(-n // threads)
    padded = np.full(slots * threads, PAD, np.float32)
    padded[:n] = md
    per_thread = padded.reshape(slots, threads)  # [slot, thread]: i = s * T + t
    bv = np.full(threads, PAD, np.float32)
    bi = np.full(threads, INT_MAX, np.int64)
    for s in range(slots):
        better = per_thread[s] > bv
        bv = np.where(better, per_thread[s], bv)
        bi = np.where(better, s * threads + np.arange(threads), bi)

    def warp_argmax(bits, idx):
        m = bits.max()
        return m, np.where(bits == m, idx, INT_MAX).min()

    bits = bv.view(np.int32)
    partial = [warp_argmax(bits[w:w + 32], bi[w:w + 32]) for w in range(0, threads, 32)]
    if len(partial) == 1:
        return int(partial[0][1])
    pb = np.full(32, PAD.view(np.int32), np.int32)
    pi = np.full(32, INT_MAX, np.int64)
    pb[:len(partial)] = [p[0] for p in partial]
    pi[:len(partial)] = [p[1] for p in partial]
    return int(warp_argmax(pb, pi)[1])


def _row(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random(n).astype(np.float32)
    if kind == "ties":  # few distinct values: the maximum is held many times
        return (rng.integers(0, 4, n) / 4).astype(np.float32)
    if kind == "zeros":  # every point chosen: the wrap onto index 0
        return np.zeros(n, np.float32)
    if kind == "initial":  # the first step: 1e10 everywhere
        return np.full(n, 1e10, np.float32)
    if kind == "tiny":  # denormals and zeros: bits still order as the values
        return (rng.integers(0, 3, n) * np.float32(1e-42)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["uniform", "ties", "zeros", "initial", "tiny"])
def test_signed_int_bits_order_as_the_floats(kind):
    md = torch.from_numpy(_row(kind, 1000, seed=3))
    assert _bits_argmax(md) == int(torch.argmax(md))
    # with the kernel's padding (-1, below every real distance) behind it
    padded = torch.cat([md, torch.full((24,), -1.0)])
    assert _bits_argmax(padded) == int(torch.argmax(md))
    assert torch.tensor(-1.0).view(torch.int32) < torch.tensor(0.0).view(torch.int32)


@pytest.mark.parametrize("threads", [32, 64, 128, 512])
@pytest.mark.parametrize("kind,n", [("uniform", 4096), ("ties", 4096), ("ties", 1000),
                                    ("zeros", 1000), ("initial", 33), ("tiny", 517),
                                    ("ties", 1), ("uniform", 31)])
def test_two_level_argmax_equals_first_occurrence(kind, n, threads):
    md = _row(kind, n, seed=n + threads)
    assert _kernel_argmax(md, threads) == int(torch.argmax(torch.from_numpy(md)))


@pytest.mark.parametrize("kind,n,npoint,start", [
    ("uniform", 200, 64, 0), ("rounded", 200, 64, 199), ("same", 64, 16, 5),
    ("uniform", 30, 40, 29),  # npoint > N: wraps onto index 0
])
def test_fps_through_the_kernels_argmax_equals_plain(kind, n, npoint, start):
    rng = np.random.default_rng(n + npoint)
    xyz = rng.random((n, 3)).astype(np.float32)
    if kind == "rounded":
        xyz = np.round(xyz * 4) / 4
    elif kind == "same":
        xyz[:] = xyz[0]
    md = np.full(n, 1e10, np.float32)
    far, got = start, []
    for _ in range(npoint):
        got.append(far)
        d = xyz - xyz[far]
        md = np.minimum(md, d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
        far = _kernel_argmax(md, threads=64)
    want = tfps.fps_plain(torch.from_numpy(xyz)[None], npoint,
                          torch.tensor([start], dtype=torch.int32))
    np.testing.assert_array_equal(np.array(got, np.int32), want[0].numpy())
