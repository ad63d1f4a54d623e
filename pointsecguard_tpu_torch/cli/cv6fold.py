"""6-fold cross-validation aggregation of the port (port of
``pointsecguard_tpu/cli/cv6fold.py``; the reference `RandLA-Net/utils/6_fold_cv.py`).

Scores the per-cloud prediction PLYs of ``cli.eval --model randla
--save_preds`` (field ``pred``) against the full-resolution clouds of
``cli.prepare`` (``original_ply``, field ``class``) in one confusion
matrix of S3DIS's 13 classes:

  python -m pointsecguard_tpu_torch.cli.cv6fold --results_dir <preds> \
      --original_dir <full-res plys>

Prints each cloud's accuracy, then the eval accuracy, mIoU, the per-class
IoU and mAcc. numpy only.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser("cv6fold")
    ap.add_argument("--results_dir", required=True,
                    help="per-cloud prediction .ply files (field 'pred')")
    ap.add_argument("--original_dir", required=True,
                    help="original full-resolution .ply clouds (field 'class')")
    args = ap.parse_args(argv)

    from pointsecguard_tpu_torch.data.ply import read_ply
    from pointsecguard_tpu_torch.data.s3dis import S3DIS_CLASSES
    from pointsecguard_tpu_torch.utils.metrics import metrics_from_confusion

    cm = np.zeros((13, 13), np.float64)
    total_correct = total_seen = 0
    for path in sorted(glob.glob(os.path.join(args.results_dir, "*.ply"))):
        pred = np.asarray(read_ply(path)["pred"], np.int64)
        orig = read_ply(os.path.join(args.original_dir, os.path.basename(path)))
        labels = np.asarray(orig["class"], np.int64)
        correct = int((pred == labels).sum())
        print(f"{os.path.basename(path)[:-4]}_acc: {correct / len(labels):.4f}")
        total_correct += correct
        total_seen += len(labels)
        np.add.at(cm, (labels, pred), 1.0)

    m = metrics_from_confusion(cm)
    per_class_acc = np.diag(cm) / np.maximum(cm.sum(axis=1), 1)
    print(f"eval accuracy: {total_correct / total_seen:.4f}")
    print(f"mean IOU: {m.miou:.4f}")
    for cls, iou in zip(S3DIS_CLASSES, m.class_iou):
        print(f"  {cls:12s}: {iou:.4f}")
    print(f"mAcc: {per_class_acc.mean():.4f}")
    return m


if __name__ == "__main__":
    main()
