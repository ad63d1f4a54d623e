"""Experiment logging (port of ``pointsecguard_tpu/utils/logging.py:18-117``):
a JSONL event stream, optional TensorBoard scalars, and the reference's
``.xyzrgb`` visual dumps (`NB_nontarget_test_semseg.py:131-136,250-268`),
byte-equal to the JAX package's for the same arrays."""

from __future__ import annotations

import json
import os
import time

import numpy as np

# `indoor3d_util.py:29` g_label2color — class → RGB for visual dumps
LABEL2COLOR = np.array(
    [
        [0, 255, 0], [0, 0, 255], [0, 255, 255], [255, 255, 0],
        [255, 0, 255], [100, 100, 255], [200, 200, 100], [170, 120, 200],
        [255, 0, 0], [200, 100, 100], [10, 200, 100], [200, 200, 200],
        [50, 50, 50],
    ],
    np.uint8,
)


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


def write_xyzrgb(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Dump an N×6 ``.xyzrgb`` text cloud (the reference's visual format);
    colours in [0, 1] are scaled to 0–255."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 and rgb.max() <= 1.0 + 1e-6:
        rgb = (rgb * 255).astype(np.uint8)
    np.savetxt(
        path,
        np.concatenate([np.asarray(xyz), rgb.astype(np.float64)], axis=1),
        fmt="%f %f %f %d %d %d",
    )


def label_palette(num_classes: int) -> np.ndarray:
    """Class → RGB palette of at least ``num_classes`` rows: the first 13
    are the reference's S3DIS colours (`indoor3d_util.py:29`), further ones
    a golden-ratio hue walk so that every class stays distinct."""
    n = max(int(num_classes), len(LABEL2COLOR))
    if n == len(LABEL2COLOR):
        return LABEL2COLOR
    import colorsys

    extra = []
    for i in range(len(LABEL2COLOR), n):
        hue = (i * 0.61803398875) % 1.0
        r, g, b = colorsys.hsv_to_rgb(hue, 0.75, 0.95)
        extra.append([round(r * 255), round(g * 255), round(b * 255)])
    return np.concatenate([LABEL2COLOR, np.array(extra, np.uint8)], axis=0)


def write_label_cloud(path: str, xyz: np.ndarray, labels: np.ndarray) -> None:
    """Dump a cloud coloured by class label (prediction / ground truth)."""
    labels = np.asarray(labels).astype(int)
    write_xyzrgb(path, xyz, label_palette(labels.max() + 1)[labels])


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
