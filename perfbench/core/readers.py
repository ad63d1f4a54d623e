"""What the metric readers share. A reader takes the run's record and
returns its number, or None where the record holds nothing to read."""

from __future__ import annotations

import statistics

PEAK_FLOAT32_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def rate(rec: dict) -> float:
    """Samples completed over the window's seconds."""
    return rec["samples_per_unit"] * len(rec["units"]) / rec["window_s"]


def span_median(rec: dict, name: str) -> float | None:
    spans = rec.get("spans_ms", {}).get(name)
    return statistics.median(spans) if spans else None


def traced(rec: dict, key: str) -> float | None:
    t = rec.get("trace")
    return None if not t or t.get("busy_s", 0.0) <= 0 else t[key]


def busy_share(rec: dict, key: str) -> float | None:
    """``key``'s device seconds as a percentage of the traced busy time."""
    part = traced(rec, key)
    return None if part is None else 100.0 * part / rec["trace"]["busy_s"]


def idle_share(rec: dict) -> float | None:
    busy = traced(rec, "busy_s")
    return None if busy is None else 100.0 * (1.0 - busy / rec["trace"]["window_s"])


def roofline_share(rec: dict) -> float | None:
    """Σ least time of the traced ``psg::`` calls over Σ device time of the
    port's kernels, as a percentage; None without a costed call."""
    t = rec.get("trace")
    if (not t or not t.get("port_calls") or t.get("port_calls_uncosted")
            or t.get("port_kernel_s", 0.0) <= 0):
        return None
    return 100.0 * t["port_bound_s"] / t["port_kernel_s"]


def mfu(rec: dict) -> float:
    """The window's model FLOPs over its seconds, as a percentage of the
    card's float32 peak."""
    flops = rec["flops_per_unit"] * len(rec["units"])
    return 100.0 * flops / rec["window_s"] / PEAK_FLOAT32_PER_S
