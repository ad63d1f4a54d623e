"""What every driver shares: the run's settings, its window, and the
comparison of the port's outputs with the reference's."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class Run:
    """One run of a cell. ``hooks`` maps a name of the timed path's calls
    (``attack``, ``step``) to a wrapper of the port's function: empty in a
    benchmark run; the tests and ``calibrate.py`` plant faults there.
    ``precision`` None runs the configuration's own."""

    device: torch.device
    seed: int
    seconds: float
    trace: bool
    started: float
    precision: str | None = None
    hooks: dict = dataclasses.field(default_factory=dict)

    def hook(self, name: str, fn: Callable) -> Callable:
        wrap = self.hooks.get(name)
        return fn if wrap is None else wrap(fn)

    def rng(self, stream: int) -> np.random.Generator:
        """A host generator of the seed, one stream per use."""
        return np.random.default_rng([self.seed, stream])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Marks:
    """Seconds of each part of set-up: ``marks(name)`` closes the part
    that began at the previous mark (the first at the process's start)."""

    def __init__(self, started: float):
        self.last, self.parts = started, {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now


def window(run: Run, unit: Callable[[int], None], estimate_s: float) -> list[tuple[float, float]]:
    """Units 0, 1, … back to back, one in flight; a unit starts only if the
    estimate says it ends within ``run.seconds`` of the first one's start.
    → each unit's (start, end) on the host clock."""
    spans = []
    while True:
        now = time.perf_counter()
        if spans and now - spans[0][0] + estimate_s > run.seconds:
            return spans
        unit(len(spans))
        spans.append((now, time.perf_counter()))


def sample_units(run: Run, expected: int, count: int) -> list[int]:
    """``count`` unit ordinals drawn from the seed among the first four
    fifths of the units the window is expected to run, or among all of
    them where that leaves fewer than ``count``."""
    top = max(1, min(expected, max(count, int(0.8 * expected))))
    return sorted(run.rng(2).choice(top, size=min(count, top), replace=False).tolist())


def pred_gap(ref_out: torch.Tensor, pred: torch.Tensor) -> float:
    """The widest gap by which the reference's output at the port's
    predicted class lies below the reference's best."""
    best = ref_out.max(dim=-1).values
    at = torch.gather(ref_out, -1, pred.long().to(ref_out.device)[..., None])[..., 0]
    return float((best - at).max())


def mismatch_share(port: list[torch.Tensor], ref: list[torch.Tensor]) -> float:
    """The share of entries that differ, over lists of tensors (all of a
    tensor's where its shape differs, or where the port gives none)."""
    if len(port) != len(ref):
        return 1.0
    diff = sum(int((a.to(b.device, b.dtype) != b).sum()) if a.shape == b.shape else b.numel()
               for a, b in zip(port, ref))
    return diff / max(1, sum(b.numel() for b in ref))


def worst_leaf_gap(port: dict, ref: dict) -> float:
    """The widest |‖port leaf‖ − ‖ref leaf‖| over the leaves of ``ref``,
    each over the larger of its reference norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    median = float(np.median(list(norms.values())))
    gaps = [abs(float(torch.linalg.vector_norm(port[k].double())) - n) / max(n, median, 1e-30)
            for k, n in norms.items()]
    return max(gaps) if gaps else math.nan


class Span:
    """Device time of a region on the card: CUDA events (read ``ms``
    after a sync)."""

    def __init__(self, device: torch.device):
        self.start_ev = torch.cuda.Event(enable_timing=True)
        self.end_ev = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self.start_ev.record()
        return self

    def __exit__(self, *exc):
        self.end_ev.record()

    @property
    def ms(self) -> float:
        return self.start_ev.elapsed_time(self.end_ev)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory, taken in stream order without
    waiting for it (pinned memory; read it after a sync), so that what a
    check keeps neither holds device memory nor stalls the window."""
    if t.device.type != "cuda":
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t.detach(), non_blocking=True)


def reserve_host(like: list[torch.Tensor]) -> None:
    """Take pinned memory for ``to_host`` copies of tensors of these sizes
    and hand it back to torch's cache of pinned blocks, which later
    copies reuse, so that copies in the window do not allocate. Host
    tensors ask for nothing."""
    blocks = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in like
              if t.is_pinned()]
    del blocks


def verdict(checks: dict) -> bool:
    """Every number within its limit (a number that is not finite fails)."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
