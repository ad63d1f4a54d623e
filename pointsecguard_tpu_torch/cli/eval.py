"""Whole-scene evaluation CLI of the port (port of
``pointsecguard_tpu/cli/eval.py:13-239``, the reference's `test_semseg.py`):

  python -m pointsecguard_tpu_torch.cli.eval --model pointnet2 \
      --data_root data/stanford_indoor3d --log_dir log/pointnet2 [--num_votes 5]

Ported: ``--model pointnet2`` with ``--num_votes``, ``--num_point``
(0 → 4096), ``--batch_size`` (0 → 16), ``--seed`` and ``--adv_set`` (a
saved adversarial set from ``cli.attack --save_adv``). The checkpoint is
the port's own (``<log_dir>/checkpoints/``: the best one, else the
latest). It runs on the GPU; ``--device cpu`` runs the plain PyTorch
path by request. Every other flag of the JAX CLI is accepted by name and
stops the run with "not ported yet".
"""

from __future__ import annotations

import argparse
import logging
import os

_MODELS = ["pointnet2", "pointnet2_msg", "pointnet", "randla", "resgcn",
           "pointnet_cls", "pointnet2_cls", "pointnet2_cls_msg",
           "pointnet_part_seg", "pointnet2_part_seg", "pointnet2_part_seg_msg"]
PORTED_MODELS = ("pointnet2",)
_UNPORTED_DEFAULTS = {
    "num_category": 40, "resgcn_blocks": 0, "resgcn_k": 0, "resgcn_filters": 0,
    "resgcn_block_type": "", "resgcn_conv": "", "resgcn_epsilon": 0.0,
    "randla_dir": "data/randla_input_0.040", "randla_dataset": "s3dis",
    "num_clouds": 200, "randla_points": 0, "save_preds": None, "devices": 1,
    "shard_points": 1, "precision": "float32",
}
_UNPORTED_SWITCHES = ("no_normals", "resgcn_fast", "visual")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("eval")
    ap.add_argument("--model", default="pointnet2", choices=_MODELS)
    ap.add_argument("--adv_set", default=None,
                    help="evaluate a saved adversarial set (.npz from "
                         "cli.attack --save_adv) instead of the dataset: "
                         "attack under one checkpoint, re-evaluate under "
                         "another")
    ap.add_argument("--data_root", default="data/stanford_indoor3d")
    ap.add_argument("--log_dir", default="log/run")
    ap.add_argument("--test_area", type=int, default=5)
    ap.add_argument("--num_point", type=int, default=0,
                    help="points per block (0 = 4096)")
    ap.add_argument("--batch_size", type=int, default=0, help="0 = 16")
    ap.add_argument("--num_votes", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) needs a card and raises without "
                         "one; cpu runs the plain PyTorch path")
    for name, default in _UNPORTED_DEFAULTS.items():
        flags = [f"--{name}"] + (["-d"] if name == "devices" else [])
        kind = type(default) if default is not None else str
        ap.add_argument(*flags, type=kind, default=default)
    for name in _UNPORTED_SWITCHES:
        ap.add_argument(f"--{name}", action="store_true")
    return ap


def _refuse_unported(args) -> None:
    refused = [f"--model {args.model}"] if args.model not in PORTED_MODELS else []
    refused += [f"--{name} {getattr(args, name)}"
                for name, default in _UNPORTED_DEFAULTS.items()
                if getattr(args, name) != default]
    refused += [f"--{name}" for name in _UNPORTED_SWITCHES if getattr(args, name)]
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def _padded_batches(n: int, batch_size: int):
    """(indices [batch_size], number valid) over ``range(n)``; the last
    batch is filled up with index 0 to the fixed size."""
    import numpy as np

    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        valid = len(idx)
        if valid < batch_size:
            idx = np.concatenate([idx, np.zeros(batch_size - valid, int)])
        yield idx, valid


def main(argv=None):
    args = _parser().parse_args(argv)
    _refuse_unported(args)

    import numpy as np

    from pointsecguard_tpu_torch.data import S3DIS_CLASSES, RoomSet
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG
    from pointsecguard_tpu_torch.train.evaluator import evaluate_whole_scenes
    from pointsecguard_tpu_torch.train.trainer import make_eval_step
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.metrics import (
        confusion_matrix,
        metrics_from_confusion,
    )
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(message)s", force=True)
    log = logging.getLogger("eval")
    args.batch_size = args.batch_size or 16
    args.num_point = args.num_point or 4096

    model = PointNet2SemSegSSG()
    model.load_state_dict(load_checkpoint(args.log_dir))
    model.to(device).eval().requires_grad_(False)
    predict = make_eval_step(model, device)

    if args.adv_set:
        # saved adversarial set: batched forward over the stored blocks,
        # confusion-based metrics; the .npz is self-contained
        adv_npz = np.load(args.adv_set)
        pts_all = adv_npz["points"].astype(np.float32)
        labs_all = adv_npz["labels"].astype(np.int32)
        cm = np.zeros((13, 13))
        for idx, v in _padded_batches(len(pts_all), args.batch_size):
            preds = predict(pts_all[idx])[:v]
            cm += confusion_matrix(labs_all[idx[:v]], preds, 13)
        m = metrics_from_confusion(cm)
        log.info("---- class IoU ----")
        for cls, iou in zip(S3DIS_CLASSES, m.class_iou):
            log.info("%12s: %.4f", cls, iou)
        log.info(
            "ADVSET %s: %d blocks  mIoU %.4f  acc %.4f",
            os.path.basename(args.adv_set), len(pts_all), m.miou, m.accuracy,
        )
        return m

    rooms = RoomSet.load(args.data_root, "test", args.test_area)
    total, per_room = evaluate_whole_scenes(
        predict, rooms, batch_size=args.batch_size, num_votes=args.num_votes,
        block_points=args.num_point, rng=np.random.default_rng(args.seed),
    )
    for name, m in zip(rooms.names, per_room):
        log.info("%s: mIoU %.4f acc %.4f", name, m.miou, m.accuracy)
    log.info("---- class IoU ----")
    for cls, iou in zip(S3DIS_CLASSES, total.class_iou):
        log.info("%12s: %.4f", cls, iou)
    log.info("TOTAL mIoU %.4f  acc %.4f", total.miou, total.accuracy)
    return total


if __name__ == "__main__":
    main()
