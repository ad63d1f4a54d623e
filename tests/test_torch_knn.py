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
import re
from pathlib import Path

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


def _features(kind: str, B: int, N: int, D: int, seed: int) -> np.ndarray:
    """[B, N, D] float32 features: uniform in [0, 1), or (``rounded``) on the
    quarter grid, where every product and sum of a distance is exact."""
    x = np.random.default_rng(seed).random((B, N, D)).astype(np.float32)
    return np.round(x * 4) / 4 if kind == "rounded" else x


@pytest.mark.parametrize("kind,N,k,D", [
    pytest.param("uniform", 700, 8, 3, id="uniform-700-8"),
    pytest.param("rounded", 700, 16, 3, id="rounded-700-16"),
    pytest.param("uniform", 300, 1, 3, id="uniform-300-1"),
    # feature space: the any-D kernel's inputs (ResGCN's graphs are D = 64)
    pytest.param("rounded", 700, 16, 9, id="rounded-700-16-D9"),
    pytest.param("rounded", 700, 48, 9, id="rounded-700-48-D9"),
    pytest.param("rounded", 700, 16, 64, id="rounded-700-16-D64"),
    pytest.param("rounded", 700, 48, 64, id="rounded-700-48-D64"),
    pytest.param("uniform", 700, 16, 9, id="uniform-700-16-D9"),
    pytest.param("uniform", 700, 48, 9, id="uniform-700-48-D9"),
    pytest.param("uniform", 700, 16, 64, id="uniform-700-16-D64"),
    pytest.param("uniform", 700, 48, 64, id="uniform-700-48-D64"),
])
def test_knn_plain_matches_pallas_kernel_body(kind, N, k, D):
    pts = _cloud(kind, 2, N, seed=7) if D == 3 else _features(kind, 2, N, D, seed=7 + D)
    q = pts[:, :16]
    wv, wi = _knn_interpret(q, pts, k)
    gv, gi = tknn.knn_plain(_t(q), _t(pts), k)
    np.testing.assert_array_equal(gi.numpy(), wi)
    if kind == "rounded":  # quarter-grid coordinates: every step is exact
        np.testing.assert_array_equal(gv.numpy(), wv)
    elif D == 3:  # the interpreter's dot may round the cross term differently
        np.testing.assert_allclose(gv.numpy(), wv, atol=1e-5)
    else:
        # ... by a few float32 ulps of the distance's scale, |q|² + |p|²
        # (up to 128 at D = 64 on [0, 1) coordinates)
        scale = (q**2).sum(-1).max() + (pts**2).sum(-1).max()
        atol = 4 * np.finfo(np.float32).eps * scale
        np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=atol)


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


def _ball_query_rows(kind: str, S: int = 8, N: int = 10000, k: int = 32) -> np.ndarray:
    """[1, S, N] index values as the ball query makes them: column j holds
    j inside the radius and the sentinel N outside; row r of kind "many"
    holds 40 + 60 r points in radius at random columns, "few" k // 2 - r,
    "run" a run of 300 columns (the bottom k in a few chunks below T = N),
    "none" no point; "equal" rows hold one value throughout."""
    rng = np.random.default_rng(len(kind) + S)
    x = np.full((1, S, N), float(N), np.float32)
    if kind == "equal":
        x[0] = np.arange(S, dtype=np.float32)[:, None] * 0.5
        return x
    for r in range(S):
        if kind == "none":
            continue
        if kind == "run":
            cols = np.arange(700 * r, 700 * r + 300)
        else:
            n = 40 + 60 * r if kind == "many" else max(k // 2 - r, 1)
            cols = rng.choice(N, n, replace=False)
        x[0, r, cols] = cols
    return x


@pytest.mark.parametrize("kind", ["few", "none", "many", "run", "equal"])
def test_chunked_plain_matches_pallas_on_ball_query_rows(kind):
    """The 10,000-point classifier's ball query (k = 32, sentinel N = 10000):
    fewer than k in radius (T = N, the sentinel tied across the row), none,
    many, a run of columns, and all-equal rows; bottom_k_plain equal to the
    TPU kernel's body run by the interpreter."""
    x = _ball_query_rows(kind)
    wv, wi = _chunked_interpret(x, 32)
    gv, gi = tbkc.bottom_k_chunked(_t(x), 32)
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
    """JAX's opt-in strategies, once refused, are taken (exact, as JAX's are
    on the CPU; tests/test_torch_resgcn_fast.py holds them to JAX's): the
    result of "auto"; a name JAX does not have is refused."""
    pts = _t(_cloud("uniform", 1, 64, 0))
    want = tops.knn(pts, pts, 4)
    got = tops.knn(pts, pts, 4, strategy=strategy)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    with pytest.raises(ValueError, match="unknown strategy"):
        tops.knn(pts, pts, 4, strategy=strategy + "_x")


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
    assert tcuda.launch_counts() == {"fps": 0, "fps_cluster": 0, "fps_stream": 0, "bottom_k": 0,
                                     "bottom_k_chunked": 0,
                                     "knn": 0, "attentive_fwd": 0, "attentive_bwd": 0}
    # neither a CPU nor a CUDA tensor: raise, never fall back
    with pytest.raises(ValueError):
        tknn.knn(pts.to("meta"), pts.to("meta"), 16)
    with pytest.raises(ValueError):
        tbkc.bottom_k_chunked(torch.rand(2, 9000, device="meta"), 16)
    assert sum(tcuda.launch_counts().values()) == 0


# --- the fused kernel's deferred insertion, emulated -----------------------
#
# The CUDA kernel cannot run here; what a CPU can hold is its selection
# logic. The emulation below does what a warp of ``csrc/knn.cu`` does with
# one row of distances per lane: groups of ``unroll`` points are compared
# with each lane's k-th value as it stood at the last flush (stale, never
# below the current one), hits are appended to the lane's queue in index
# order, and when any lane's queue could overflow in the next group all
# lanes flush: each re-tests its queued pairs in order against its current
# k-th value and inserts the survivors after any equal values.


def _insert(vals, idx, d, i):
    """d < vals[-1]: d goes after every value <= d; the last one drops out."""
    pos = int(np.searchsorted(vals, d, side="right"))
    vals[pos + 1:] = vals[pos:-1].copy()
    idx[pos + 1:] = idx[pos:-1].copy()
    vals[pos], idx[pos] = d, i


def _deferred_knn(dist: np.ndarray, k: int, queue: int, unroll: int):
    """Bottom-k of each row of ``dist`` [lanes, N] as one warp finds it."""
    lanes, N = dist.shape
    vals = np.full((lanes, k), np.inf, np.float32)
    idx = np.full((lanes, k), np.iinfo(np.int32).max, np.int64)
    queues = [[] for _ in range(lanes)]
    stale = vals[:, -1].copy()
    flushes = 0

    def flush():
        for lane, q in enumerate(queues):
            for d, i in q:  # oldest first
                if d < vals[lane, -1]:
                    _insert(vals[lane], idx[lane], d, i)
            q.clear()
        stale[:] = vals[:, -1]

    for j0 in range(0, N, unroll):
        group = dist[:, j0:j0 + unroll]
        hits = group < stale[:, None]
        if not hits.any():  # the warp vote: nothing else happens
            continue
        for lane in range(lanes):
            for r in np.flatnonzero(hits[lane]):
                queues[lane].append((group[lane, r], j0 + r))
            assert len(queues[lane]) <= queue
        if max(len(q) for q in queues) > queue - unroll:
            flush()
            flushes += 1
    flush()
    return vals, idx.astype(np.int32), flushes


def _stress_cloud(kind: str, N: int, seed: int):
    """(query [1, 8, 3], points [1, N, 3]) float32."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((1, N, 3)) * 3).astype(np.float32)
    q = pts[:, :8].copy()
    if kind == "rounded":
        pts = np.round(pts * 4) / 4
        q = pts[:, :8].copy()
    elif kind == "duplicated":
        pts[:, N // 2:] = pts[:, : N - N // 2]
        q = pts[:, :8].copy()
    elif kind == "constant":
        pts[:] = 0.75
        q = pts[:, :8].copy()
    elif kind in ("far_to_near", "near_to_far"):
        centre = np.full(3, 1.5, np.float32)
        q = (centre + 1e-3 * rng.standard_normal((1, 8, 3))).astype(np.float32)
        order = np.argsort(((pts[0] - centre) ** 2).sum(-1))
        pts = pts[:, order[::-1] if kind == "far_to_near" else order]
    return np.ascontiguousarray(q), np.ascontiguousarray(pts)


@pytest.mark.parametrize("queue,unroll", [(16, 8), (8, 4), (32, 8), (8, 8), (1, 1)])
@pytest.mark.parametrize("kind", ["uniform", "rounded", "duplicated", "constant",
                                  "far_to_near", "near_to_far"])
def test_deferred_insertion_equals_knn_plain(kind, queue, unroll):
    q, pts = _stress_cloud(kind, 203, seed=len(kind) + queue)  # N off every group size
    dist = tops.square_distance(_t(q), _t(pts))[0].numpy()
    for k in (1, 5, 16):
        wv, wi = tknn.knn_plain(_t(q), _t(pts), k)
        gv, gi, flushes = _deferred_knn(dist, k, queue, unroll)
        np.testing.assert_array_equal(gi, wi[0].numpy())
        np.testing.assert_array_equal(gv, wv[0].numpy())
        if kind == "far_to_near" and k > 1 and queue < 203:
            # nearly every point is a hit: the queue fills again and again
            assert flushes >= 203 // queue - 1


def test_deferred_insertion_constant_cloud_keeps_the_first_indices():
    q, pts = _stress_cloud("constant", 100, seed=0)
    dist = tops.square_distance(_t(q), _t(pts))[0].numpy()
    _, gi, _ = _deferred_knn(dist, 16, 16, 8)
    np.testing.assert_array_equal(gi, np.broadcast_to(np.arange(16, dtype=np.int32), (8, 16)))


def test_knn_same_tensor_and_distinct_query_agree():
    pts = _t(_cloud("duplicated", 2, 300, 3))
    a = tknn.knn(pts, pts, 16)
    b = tknn.knn(pts.clone(), pts, 16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# --- the any-D kernel's tile walk, emulated --------------------------------
#
# ``knn_tiled_kernel`` of ``csrc/knn.cu`` forms a [queries, PT] block of
# distances a tile and then selects: each query marks the points of its
# row below its k-th value as it stood at the tile's start, and the lanes of
# a warp walk their marks together, lowest index first, re-testing each
# against the current k-th value and inserting the survivors after equal
# values. The emulation does that with one row per lane.

_KNN_CU = Path(__file__).resolve().parents[1] / "pointsecguard_tpu_torch" / "csrc" / "knn.cu"


def _kernel_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _KNN_CU.read_text())
    assert m, f"{name} not found in {_KNN_CU}"
    return int(m.group(1))


def _tile_walk(dist: np.ndarray, k: int, pt: int):
    """Bottom-k of each row of ``dist`` [lanes, N] as the tiled kernel's
    warp finds it, tile by tile; also the walk's steps (the largest mark
    count of the lanes, summed over the tiles)."""
    lanes, N = dist.shape
    vals = np.full((lanes, k), np.inf, np.float32)
    idx = np.full((lanes, k), np.iinfo(np.int32).max, np.int64)
    steps = 0
    for base in range(0, N, pt):
        block = np.full((lanes, pt), np.inf, np.float32)  # +inf past N
        block[:, : min(pt, N - base)] = dist[:, base : base + pt]
        marks = [np.flatnonzero(row < kth) for row, kth in zip(block, vals[:, -1])]
        walk = max(len(m) for m in marks)
        for step in range(walk):  # the lanes walk their marks together
            for lane, m in enumerate(marks):
                if step < len(m):
                    d = block[lane, m[step]]
                    if d < vals[lane, -1]:
                        _insert(vals[lane], idx[lane], d, base + m[step])
        steps += walk
    return vals, idx.astype(np.int32), steps


def _lift(x: np.ndarray, D: int) -> np.ndarray:
    """[..., 3] → [..., D], coordinates repeated in turn: every distance is
    a sum of the 3-D squared differences, so the cloud's ties and its
    order from the queries carry over exactly on a quarter grid."""
    return np.ascontiguousarray(x[..., np.arange(D) % 3])


_KERNEL_PT = _kernel_constant("kWP")


@pytest.mark.parametrize("pt", [_KERNEL_PT, 1, 8])
@pytest.mark.parametrize("D", [9, 64, 65])
@pytest.mark.parametrize("kind", ["uniform", "rounded", "duplicated", "constant",
                                  "far_to_near"])
def test_tile_walk_equals_knn_plain(kind, D, pt):
    q, pts = _stress_cloud(kind, 203, seed=D + pt)  # N off every tile
    q, pts = _t(_lift(q, D)), _t(_lift(pts, D))
    dist = tops.square_distance(q, pts)[0].numpy()
    for k in (1, 16, 17, 48):
        wv, wi = tknn.knn_plain(q, pts, k)
        gv, gi, steps = _tile_walk(dist, k, pt)
        np.testing.assert_array_equal(gi, wi[0].numpy())
        np.testing.assert_array_equal(gv, wv[0].numpy())
        if kind == "far_to_near":  # most points are marks: the walk's worst case
            assert steps > 203 // 2


@pytest.mark.parametrize("kind", ["uniform", "rounded", "far_to_near"])
def test_tile_walk_equals_knn_plain_at_a_graphs_width(kind):
    """N = 4099 (off the tile) at D = 64 with the kernel's tile: the walk
    takes far fewer steps than points once the lists have filled."""
    q, pts = _stress_cloud(kind, 4099, seed=3)
    q, pts = _t(_lift(q, 64)), _t(_lift(pts, 64))
    dist = tops.square_distance(q, pts)[0].numpy()
    for k in (16, 48):
        wv, wi = tknn.knn_plain(q, pts, k)
        gv, gi, steps = _tile_walk(dist, k, _KERNEL_PT)
        np.testing.assert_array_equal(gi, wi[0].numpy())
        np.testing.assert_array_equal(gv, wv[0].numpy())
        if kind == "uniform":
            assert steps < 4099 // 4


@pytest.mark.parametrize("N,k", [(16, 16), (48, 48), (65, 48)])
def test_tile_walk_k_equals_n_and_constant_cloud(N, k):
    """k == N (every point kept, in index order among ties) and a constant
    cloud at D = 65 (indices 0..k-1)."""
    q, pts = _stress_cloud("constant", N, seed=N)
    q, pts = _t(_lift(q, 65)), _t(_lift(pts, 65))
    dist = tops.square_distance(q, pts)[0].numpy()
    wv, wi = tknn.knn_plain(q, pts, k)
    gv, gi, _ = _tile_walk(dist, k, _KERNEL_PT)
    np.testing.assert_array_equal(gi, wi[0].numpy())
    np.testing.assert_array_equal(gv, wv[0].numpy())
    np.testing.assert_array_equal(gi, np.broadcast_to(np.arange(k, dtype=np.int32), (8, k)))
