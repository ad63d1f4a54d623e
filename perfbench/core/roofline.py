"""A frozen copy of the port's ``ops/cuda/bounds.py``: the least time an
H100 could take for one call of each of the port's kernels.

Bytes and operations of a call from its shapes alone, and the bound in
milliseconds from the two published peaks of the H100 SXM: 3.35 TB/s of
device memory and 67 TFLOP/s in float32 outside the tensor cores
(NVIDIA's data sheet, at the 700 W power limit). Every input byte is read
once and every output byte written once, whatever the kernel reads
again; the bound is the larger of bytes / memory rate and operations /
arithmetic rate. ``Work`` values add, so the bound of many calls is the
bound of their sum. The benchmark keeps its own copy so that the
yardstick does not move with the program.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOAT32_PER_S = 67e12


@dataclass(frozen=True)
class Work:
    """What one or more calls must move and compute."""

    bytes_in: int = 0
    bytes_out: int = 0
    operations: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes_in + other.bytes_in, self.bytes_out + other.bytes_out,
                    self.operations + other.operations)

    @property
    def bytes(self) -> int:
        return self.bytes_in + self.bytes_out

    @property
    def bytes_ms(self) -> float:
        return 1e3 * self.bytes / PEAK_BYTES_PER_S

    @property
    def operations_ms(self) -> float:
        return 1e3 * self.operations / PEAK_FLOAT32_PER_S

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.operations_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.operations_ms else "operations"


def total(works) -> Work:
    return sum(works, Work())


def bottom_k(rows: int, n: int, k: int) -> Work:
    """[rows, n] float32 in; k float32 values and k int32 indices per row
    out; one comparison per element (against the k-th best so far)."""
    return Work(4 * rows * n, 8 * rows * k, rows * n)


bottom_k_chunked = bottom_k  # the same function on wider rows


def fps(b: int, n: int, npoint: int) -> Work:
    """[b, n, 3] points and b start indices in, [b, npoint] int32 out; per
    step and point 3 subtractions, 3 multiply-adds' worth of squares
    (5 flop), a minimum and the arg-max comparison: 10 operations."""
    return Work(4 * b * n * 3 + 4 * b, 4 * b * npoint, 10 * b * n * npoint)


def knn(b: int, s: int, n: int, d: int, k: int) -> Work:
    """Queries [b, s, d], points [b, n, d] and their squared norms in; k
    distances and indices per query out; per pair a d-term dot product
    (2d flop), |q|² + |p|² − 2 q·p (3) — the list insertion is not
    counted."""
    return Work(4 * b * (s + n) * (d + 1), 8 * b * s * k, b * s * n * (2 * d + 3))


def _attentive_elementwise(k: int, m: int, d: int) -> int:
    # softmax over k (max, subtract, exp, add, scale: 5 per score) and the
    # weighted sum (2 per score), on 2·k·m·d scores
    return 14 * k * m * d


def attentive_fwd(k: int, m: int, d: int) -> Work:
    """fn, fx [k, m, d] and w [2d, 2d] in, two [m, d] out; the score
    product is 8·k·m·d² flop."""
    return Work(4 * (2 * k * m * d + 4 * d * d), 4 * 2 * m * d,
                8 * k * m * d * d + _attentive_elementwise(k, m, d))


def attentive_bwd(k: int, m: int, d: int, dw: bool = False) -> Work:
    """fn, fx, w and the two [m, d] cotangents in; dfn, dfx [k, m, d] (and
    dW [2d, 2d]) out. The scores are formed again (8·k·m·d²), ds costs
    about 8 per score, ds·Wᵀ is another 8·k·m·d², and dW a third."""
    products = (3 if dw else 2) * 8 * k * m * d * d
    return Work(4 * (2 * k * m * d + 4 * d * d + 2 * m * d),
                4 * (2 * k * m * d + (4 * d * d if dw else 0)),
                products + _attentive_elementwise(k, m, d) + 16 * k * m * d)
