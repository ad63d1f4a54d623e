"""The wide-row bottom-k kernel's selection, emulated on the CPU.

``csrc/bottomk_chunked.cu`` cannot run here, so its steps are written out
in numpy, a warp's 32 lanes as a slice: the chunk minima, the k chunks of
smallest (minimum, chunk), their ids sorted, the one thresholded pass over
them with its ballots (entries below T, the first k equal to T) into a
short list of ``list_capacity(k)`` pairs, the exact branch when the list
would outgrow it (sort, cut to k, the k-th value the new threshold), and
the final sort. The emulation must equal ``bottom_k_plain`` on the rows
that stress the threshold: ball-query rows with the sentinel N out of
radius (fewer than k, none and many in radius; in-radius points in one
run of columns), all-equal rows, rows of ties, ±inf, ±0, N off the chunk,
fewer chunks than k, and N = 2²². Where it takes the exact branch must
agree with ``overflow_rows_plain``, which ``chip_smoke.py`` holds the
kernel's own count to.
"""

import numpy as np
import pytest
import torch

from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked as tbkc

W = tbkc.CHUNK


def _emulate(row: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray, bool]:
    """One warp's row through the kernel's steps → (values, columns,
    whether the exact branch ran)."""
    N = row.shape[0]
    C = -(-N // W)
    padded = np.full(C * W, np.inf, np.float32)
    padded[:N] = row
    mins = padded.reshape(C, W).min(1)
    k_sel = min(k, C)
    # (2) k_sel lexicographic argmins of (minimum, chunk), each after the last
    chunks = np.arange(C)
    chosen, pv, pi = [], -np.inf, -1
    for _ in range(k_sel):
        after = (mins > pv) | ((mins == pv) & (chunks > pi))
        m = mins[after].min()
        c = chunks[after & (mins == m)].min()
        chosen.append(c)
        pv, pi = m, c
    # (3) ascending ids; (4) the thresholded pass
    thr, ties, n_ties = (pv if k_sel == k else np.float32(np.inf)), True, 0
    cap = tbkc.list_capacity(k)
    lv, lc, overflowed = np.empty(0, np.float32), np.empty(0, np.int64), False

    def first_k(v, c, n):
        order = np.lexsort((c, v))[:n]  # by value, then column
        return v[order], c[order]

    for c in sorted(chosen):
        for t in range(W // 32):
            j = c * W + 32 * t + np.arange(32)
            inside = j < N
            v = padded[j]
            eq = ties & inside & (v == thr)
            before_me = np.cumsum(eq) - eq  # ties of lower lanes in the ballot
            keep = (inside & (v < thr)) | (eq & (n_ties + before_me < k))
            n_ties += int(eq.sum())
            if len(lv) + keep.sum() > cap:  # the exact branch
                lv, lc = first_k(lv, lc, k)
                thr, ties, overflowed = lv[k - 1], False, True
                keep = inside & (v < thr)
            lv, lc = np.concatenate([lv, v[keep]]), np.concatenate([lc, j[keep]])
    # (5) the final sort
    lv, lc = first_k(lv, lc, k)
    return lv, lc, overflowed


def _ball_rows(N: int, in_radius: list, seed: int) -> np.ndarray:
    """Index-valued rows as the ball query makes them: column j holds j in
    radius and the sentinel N outside. ``in_radius``: per row, a count of
    points drawn at random columns, or a (start, length) run."""
    rng = np.random.default_rng(seed)
    rows = np.full((len(in_radius), N), float(N), np.float32)
    for r, spec in enumerate(in_radius):
        cols = (np.arange(spec[0], spec[0] + spec[1]) if isinstance(spec, tuple)
                else rng.choice(N, spec, replace=False))
        rows[r, cols] = cols
    return rows


def _rows(kind: str, N: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((3, N), dtype=np.float32)
    if kind == "rounded":  # few distinct values: ties across chunks
        return (np.round(rng.standard_normal((3, N)) * 4) / 4).astype(np.float32)
    if kind == "constant":
        return np.full((2, N), 0.5, np.float32)
    if kind == "inf":  # ±inf and -0.0 / +0.0 among ordinary values
        x = (np.round(rng.standard_normal((3, N)) * 2) / 2).astype(np.float32)
        x[0, rng.choice(N, N // 2, replace=False)] = np.inf
        x[1, :] = np.inf
        x[1, rng.choice(N, 5, replace=False)] = -np.inf
        x[2, rng.choice(N, N // 3, replace=False)] = -0.0
        return x
    if kind == "descending":  # the bottom k at the row's end
        return np.tile(np.arange(N, 0, -1, dtype=np.float32), (2, 1))
    raise ValueError(kind)


def _check(rows: np.ndarray, k: int) -> list:
    want_v, want_i = bottomk.bottom_k_plain(torch.from_numpy(rows), k)
    branch = []
    for r in range(rows.shape[0]):
        v, c, over = _emulate(rows[r], k)
        np.testing.assert_array_equal(c, want_i[r].numpy())
        np.testing.assert_array_equal(v, want_v[r].numpy())
        branch.append(over)
    plain = tbkc.overflow_rows_plain(torch.from_numpy(rows), k).tolist()
    assert branch == plain
    assert tbkc.overflow_rows(torch.from_numpy(rows), k) == sum(plain)
    return branch


@pytest.mark.parametrize("k", [1, 16, 32, 48])
def test_ball_query_rows(k):
    """[.., 10000] index rows with the sentinel 10000: fewer than k in
    radius (T = N, the sentinel tied across the row), none, exactly k,
    many at random columns, and runs of columns that hold the bottom k in
    one or two chunks."""
    rows = _ball_rows(10000, [0, 1, k - 1, k, k + 1, 100, 400, 3000,
                              (0, 3 * k), (250, 400), (9990, 10)], seed=k)
    branch = _check(rows, k)
    assert not any(branch[:5])  # ≤ k + 1 in radius: the list never fills
    # 400 in radius over 5 chunks: T = N and all 400 below it, the exact
    # branch (at k = 1 the one chunk of smallest minimum has T = 250)
    assert branch[-2] == (k > 1)


@pytest.mark.parametrize("N,k", [(8193, 1), (8193, 32), (8193, 48), (10000, 32),
                                 (40960, 16), (1000, 48), (300, 16)])
@pytest.mark.parametrize("kind", ["uniform", "rounded", "constant", "inf", "descending"])
def test_rows_that_stress_the_threshold(kind, N, k):
    """N off the chunk (8193), fewer chunks than k (N = 1000 at k = 48,
    300 at 16: T is +inf and the list takes the exact branch), ties in
    every chunk, all-equal rows, ±inf and ±0."""
    branch = _check(_rows(kind, N, seed=N + k), k)
    if -(-N // W) < k and kind != "inf":  # every chunk chosen, T = +inf: every
        assert all(branch)                  # finite entry is a candidate
    elif kind == "constant":  # the first k columns, no branch: k ties kept
        assert not any(branch)


def test_exact_branch_repeats_and_stays_exact():
    """Every chunk's minimum is 0 but for the eight that hold a run of 1000
    values below it: T = 0, and those values fill the list several times
    over; the result is still the stable bottom-k."""
    N, k = 40960, 16
    row = np.linspace(1.0, 2.0, N, dtype=np.float32)[::-1].copy()
    row[::128] = 0.0  # every chunk's minimum ties at 0: T = 0
    row[5000:6000] = -np.arange(1000, dtype=np.float32)
    assert _check(row[None], k) == [True]


def test_max_n_row():
    """One row of N = 2²² (the ceiling: 32,768 chunks) at k = 1, 32, 48."""
    rng = np.random.default_rng(22)
    row = (np.round(rng.random(tbkc.MAX_N) * 1e5)).astype(np.float32)[None]
    for k in (1, 32, 48):
        _check(row, k)


def test_list_capacity_leaves_room_for_a_ballot():
    for k in range(1, tbkc.MAX_K + 1):
        cap = tbkc.list_capacity(k)
        assert cap & (cap - 1) == 0 and cap >= 4 * k and cap >= k + 32
