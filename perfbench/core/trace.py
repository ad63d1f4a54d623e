"""What the traced run reads from ``torch.profiler``, in two segments
after the window (``Traced``): one of the device alone, which gives the
device's busy time as the union of its operations' intervals (the rule of
the port's ``cli/profile_randla.py:_busy_ms``) over that segment's own
length on the same timeline, the operations that took longest and the
library's sort and top-k kernels; then one of host and device with the
calls' shapes, which gives the ``psg::`` calls' least time beside their
kernels' device time, and the longest idle gaps by what the host was
doing.
"""

from __future__ import annotations

import torch

from perfbench.core import kernels


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0]


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _gaps_by_host(cpu, gaps, top: int = 500) -> dict:
    """Seconds of the ``top`` longest idle gaps ([start, end) in µs) by the
    innermost host operation running at each gap's middle; the rest of
    the gaps' time under "shorter gaps"."""
    import numpy as np

    starts = np.array([e.time_range.start for e in cpu], dtype=np.float64)
    ends = np.array([e.time_range.end for e in cpu], dtype=np.float64)
    names = [e.name for e in cpu]
    out = {}
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for a, b in gaps[:top]:
        t = 0.5 * (a + b)
        inside = np.flatnonzero((starts <= t) & (t < ends))
        name = (names[inside[np.argmin(ends[inside] - starts[inside])]] if inside.size
                else "no host operation")
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    rest = sum(b - a for a, b in gaps[top:]) * 1e-6
    if rest > 0:
        out["shorter gaps"] = rest
    return out


def _ranked(d: dict, top: int) -> list:
    return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def summarize(dev_prof, host_prof, top: int = 10) -> dict:
    """The traced part's figures, in seconds. ``dev_prof`` traced the
    device alone (the profiler then adds next to nothing to the host's
    time): the busy time, the window from its first device operation to
    its last, the device operations by time, the sort and top-k kernels.
    ``host_prof`` traced host and device with the calls' shapes, which
    slows the host: the ``psg::`` calls' least time and their kernels'
    device time, and the idle gaps by the host operation running in each
    (device figures 0 where no device operation was traced, as on the
    CPU)."""
    dev = _device_events(dev_prof)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = _union(spans)
    by_name, select_s = {}, 0.0
    for e in dev:
        d = e.time_range.elapsed_us() * 1e-6
        by_name[e.name] = by_name.get(e.name, 0.0) + d
        if kernels.is_select_kernel(e.name):
            select_s += d
    out = {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (busy[-1][1] - busy[0][0]) * 1e-6 if busy else 0.0,
        "select_s": select_s,
        "device_ops": _ranked(by_name, top),
    }
    host_dev = _device_events(host_prof)
    cpu = [e for e in host_prof.events() if e.device_type == torch.autograd.DeviceType.CPU
           and not e.name.startswith("cuda")]
    out["port_kernel_s"] = sum(e.time_range.elapsed_us() * 1e-6 for e in host_dev
                               if kernels.is_port_kernel(e.name))
    bound_s, calls, uncosted = 0.0, 0, 0
    for e in cpu:
        if e.name.startswith("psg::"):
            w = kernels.work(e.name, e.input_shapes, getattr(e, "concrete_inputs", None) or [])
            if w is None:
                uncosted += 1
            else:
                bound_s += w.bound_ms * 1e-3
                calls += 1
    out.update(port_bound_s=bound_s, port_calls=calls, port_calls_uncosted=uncosted)
    hbusy = _union([(e.time_range.start, e.time_range.end) for e in host_dev])
    edges = [x for iv in hbusy for x in iv]
    gaps = [(a, b) for a, b in zip(edges[1::2], edges[2::2]) if b > a]
    out["idle_gaps"] = _ranked(_gaps_by_host(cpu, gaps), top) if gaps else []
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiler(device, host: bool):
    """A profiler of the device alone, or with ``host`` of host and device
    with the calls' shapes and scalar arguments (on the CPU: the host)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not acts:
        acts = [ProfilerActivity.CPU] + acts
    return profile(activities=acts, record_shapes=host)


class Traced:
    """The two profiled segments of a traced run: ``"device"`` (the device
    alone) and then ``"host"`` (host and device with shapes)."""

    def __init__(self, device):
        self.device = device
        self.profs = {"device": profiler(device, False), "host": profiler(device, True)}

    def start(self, which: str) -> None:
        _sync(self.device)
        self.profs[which].start()

    def stop(self, which: str) -> None:
        _sync(self.device)
        self.profs[which].stop()

    def summary(self) -> dict:
        return summarize(self.profs["device"], self.profs["host"])


def warm_profiler(device) -> None:
    """Start and stop both profilers once over a small device operation, so
    that their start-up falls in set-up and not in the traced part."""
    for host in (False, True):
        with profiler(device, host):
            torch.ones(1, device=device).add_(1)
            _sync(device)
