"""``cli.train --profile DIR`` (port of ``pointsecguard_tpu/utils/profiling.py``:
``maybe_trace``): a ``torch.profiler`` trace of the enclosed block, the
host's operators and, on a card, its kernels, written under ``DIR`` as a
Chrome trace (``chrome://tracing``, Perfetto)."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None, device: torch.device, name: str = "trace"):
    """Trace the enclosed block into ``trace_dir/<name>.json`` if
    ``trace_dir`` is set (CUDA activity too on a CUDA ``device``)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
