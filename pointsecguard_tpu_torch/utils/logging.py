"""Experiment logging of the trainer (port of
``pointsecguard_tpu/utils/logging.py:30-51, 92-117``): a JSONL event
stream and optional TensorBoard scalars."""

from __future__ import annotations

import json
import os
import time

import numpy as np


class EventLog:
    """Append-only JSONL event log with wall-clock stamps."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._t0 = time.time()

    def write(self, event: str, **fields) -> None:
        rec = {"t": round(time.time() - self._t0, 3), "event": event}
        for k, v in fields.items():
            if isinstance(v, (np.floating, np.integer, np.bool_)):
                v = v.item()
            elif isinstance(v, np.ndarray):
                v = v.tolist()
            rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class SummaryLogger:
    """TensorBoard scalars (`utils/tf_logger.py:17-111`) through
    ``torch.utils.tensorboard`` where the ``tensorboard`` package is
    installed; without it every call is a no-op, so headless runs never
    fail."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._w = None
        else:
            self._w = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def scalars(self, step: int, **tags) -> None:
        for tag, value in tags.items():
            self.scalar(tag, value, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
