"""Whole-scene evaluation CLI of the port (port of
``pointsecguard_tpu/cli/eval.py:13-239``, the reference's `test_semseg.py`):

  python -m pointsecguard_tpu_torch.cli.eval --model pointnet2 \
      --data_root data/stanford_indoor3d --log_dir log/pointnet2 [--num_votes 5]
  python -m pointsecguard_tpu_torch.cli.eval --model resgcn \
      --data_root data/stanford_indoor3d --log_dir log/resgcn [--num_votes 5]
  python -m pointsecguard_tpu_torch.cli.eval --model randla \
      --randla_dir data/randla_input_0.040 --log_dir log/randla [--num_clouds 200]
  python -m pointsecguard_tpu_torch.cli.eval --model pointnet2_cls \
      --data_root data/modelnet40_normal_resampled --log_dir log/cls [--num_votes 3]

Ported: ``--model pointnet2``, ``pointnet2_msg`` and ``pointnet`` with
``--num_votes``, ``--num_point`` (0 → 4096), ``--batch_size`` (0 → 16),
``--seed`` and ``--adv_set`` (a saved adversarial set from
``cli.attack --save_adv``), and so ``--model resgcn`` with the
``--resgcn_*`` model flags; ``--model randla``
(whole-cloud voting, ``_eval_randla``) with ``--randla_dataset
s3dis|semantickitti|semantic3d``, ``--randla_dir``, ``--randla_points``
(0 → the preset's 40960, 45056 or 65536), ``--num_clouds``,
``--batch_size`` (0 → the preset's val_batch_size 1, 20 or 16),
``--seed``, ``--adv_set`` and
``--save_preds`` (per-cloud prediction PLYs); ``--model pointnet2_cls``,
``pointnet2_cls_msg`` and ``pointnet_cls`` (ModelNet instance and class
accuracy, ``_eval_cls``) with ``--data_root``, ``--num_category``,
``--no_normals``, ``--num_point`` (0 → 1024), ``--batch_size`` (0 → 16),
``--num_votes`` and ``--seed``. ``--visual`` writes the
per-room (per-cloud) prediction and ground-truth label clouds and an HTML
viewer under ``<log_dir>/visual`` for every model. The
checkpoint is the port's own (``<log_dir>/checkpoints/``: the best one,
else the latest). It runs on the GPU; ``--device cpu`` runs the plain
PyTorch path by request. Every other flag of the JAX CLI is accepted by
name and stops the run with "not ported yet".
"""

from __future__ import annotations

import argparse
import logging
import os

from pointsecguard_tpu_torch.cli.train import CLS_MODELS, cls_refusals
from pointsecguard_tpu_torch.configs import (
    add_resgcn_arguments,
    resgcn_overrides,
    resgcn_refusals,
)

_MODELS = ["pointnet2", "pointnet2_msg", "pointnet", "randla", "resgcn",
           "pointnet_cls", "pointnet2_cls", "pointnet2_cls_msg",
           "pointnet_part_seg", "pointnet2_part_seg", "pointnet2_part_seg_msg"]
PORTED_MODELS = ("pointnet2", "pointnet2_msg", "pointnet", "randla", "resgcn", *CLS_MODELS)
_UNPORTED_DEFAULTS = {"devices": 1, "shard_points": 1, "precision": "float32"}
_UNPORTED_SWITCHES = ("resgcn_fast",)


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
                    help="points per sample (0 = 4096 a block, 1024 a ModelNet shape)")
    ap.add_argument("--batch_size", type=int, default=0,
                    help="0 = 16 (the PointNet family, resgcn, the classifiers), "
                         "the config's val_batch_size 1 (randla)")
    ap.add_argument("--num_category", type=int, default=40,
                    help="classifiers: ModelNet10 or ModelNet40 lists")
    ap.add_argument("--no_normals", action="store_true",
                    help="classifiers: xyz only (no normal channels)")
    ap.add_argument("--num_votes", type=int, default=5)
    ap.add_argument("--randla_dir", default="data/randla_input_0.040",
                    help="randla: the prepared tree (cli.prepare)")
    ap.add_argument("--randla_dataset",
                    choices=["s3dis", "semantickitti", "semantic3d"],
                    default="s3dis",
                    help="randla: dataset preset (`helper_tool.py:18-100` "
                         "configs) over the cli.prepare artifact tree; "
                         "kitti scores held-out seq 08, sem3d the labeled "
                         "validation clouds (label 0 ignored)")
    ap.add_argument("--num_clouds", type=int, default=200,
                    help="randla: spatially-regular samples to vote over")
    ap.add_argument("--randla_points", type=int, default=0,
                    help="randla: points per cloud (0 = the preset config's 40960, "
                         "45056 semantickitti, 65536 semantic3d)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--visual", action="store_true",
                    help="write per-room (randla: per-cloud) prediction / GT "
                         "label clouds (.xyzrgb + HTML viewer) to "
                         "<log_dir>/visual (`test_semseg.py:101-174`)")
    ap.add_argument("--save_preds", default=None,
                    help="randla: save per-cloud prediction PLYs here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) needs a card and raises without "
                         "one; cpu runs the plain PyTorch path")
    add_resgcn_arguments(ap)
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
    if args.save_preds and args.model != "randla":
        refused.append(f"--save_preds with --model {args.model} (randla only)")
    refused += cls_refusals(args)
    refused += resgcn_refusals(args)
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def _adv_set_metrics(predict, path: str, batch_size: int, num_classes: int,
                     reduce=None):
    """Metrics of a saved adversarial set (``cli.attack --save_adv``): a
    batched forward over the stored blocks or clouds; the .npz is
    self-contained. ``reduce(labels, preds)`` maps stored raw labels to the
    scored class space (RandLA's ignored labels)."""
    import numpy as np

    from pointsecguard_tpu_torch.train.object_eval import _padded_batches
    from pointsecguard_tpu_torch.utils.metrics import (
        confusion_matrix,
        metrics_from_confusion,
    )

    adv_npz = np.load(path)
    pts_all = adv_npz["points"].astype(np.float32)
    labs_all = adv_npz["labels"].astype(np.int32)
    cm = np.zeros((num_classes, num_classes))
    for idx, v in _padded_batches(len(pts_all), batch_size):
        labels, preds = labs_all[idx[:v]], predict(pts_all[idx])[:v]
        if reduce is not None:
            labels, preds = reduce(labels, preds)
        cm += confusion_matrix(labels, preds, num_classes)
    return len(pts_all), metrics_from_confusion(cm)


def _eval_randla(args, log):
    """RandLA whole-cloud evaluation (``pointsecguard_tpu/cli/eval.py:358-575``):
    the evaluation-mode softmax of ``--num_clouds`` spatially-regular
    samples is voted into one float64 pool per sub-cloud at the sampler's
    point indices (``np.add.at``, the JAX order of the sums), then the
    argmax is reprojected onto the full-resolution cloud through the
    prepared ``<name>_proj.pkl``. Clouds never sampled are skipped; where
    ``_proj.pkl`` is missing (SemanticKITTI's seq-08 scans keep theirs per
    sequence) or its lengths differ, the sub-cloud labels are scored.
    ``--randla_dataset`` picks the preset: its ignored labels (label 0 of
    SemanticKITTI and Semantic3D) are left out of every score and the rest
    reduced to the valid classes the model predicts (`RandLANet.py:103-124`).
    ``--save_preds`` writes each reprojected prediction as a PLY;
    ``--visual`` the sub-cloud's label clouds and viewer."""
    import pickle

    import numpy as np
    import torch

    from pointsecguard_tpu_torch.data.ply import write_ply
    from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
    from pointsecguard_tpu_torch.models import RandLANet
    from pointsecguard_tpu_torch.train.trainer import randla_family
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.metrics import metrics_from_confusion
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    preset = randla_dataset_preset(args.randla_dataset)
    cfg, K = preset.cfg, preset.num_classes

    def _reduced(raw_labels, preds):
        """(valid raw labels → contiguous index, matching preds)."""
        valid, y = preset.reduce(np.asarray(raw_labels).reshape(-1))
        return y[valid], np.asarray(preds).reshape(-1)[valid]

    device = resolve_device(args.device)
    B = args.batch_size or cfg.val_batch_size
    model = RandLANet(num_classes=K, d_out=cfg.d_out, d_in=6 if preset.has_colors else 3)
    model.load_state_dict(load_checkpoint(args.log_dir))
    model.to(device).eval().requires_grad_(False)
    family = randla_family(cfg)

    @torch.no_grad()
    def probs_fn(feats: np.ndarray) -> np.ndarray:
        f = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(device)
        return torch.softmax(family.apply(model, f, family.plan(f)), dim=-1).cpu().numpy()

    if args.adv_set:
        n, m = _adv_set_metrics(lambda f: np.argmax(probs_fn(f), axis=-1), args.adv_set,
                                B, K, reduce=_reduced)
        log.info("ADVSET %s: %d clouds  mIoU %.4f  acc %.4f",
                 os.path.basename(args.adv_set), n, m.miou, m.accuracy)
        return m

    num_points = args.randla_points or cfg.num_points
    sampler = preset.make_sampler(args.randla_dir, "test", num_points,
                                  np.random.default_rng(args.seed),
                                  test_area=args.test_area)
    # per-sub-cloud vote pools; --num_clouds counts samples, not batches
    pools = [np.zeros((len(c.labels), K), np.float64) for c in sampler.clouds]
    for _, feats, _, idx, cloud_idx in sampler.batches(B, -(-args.num_clouds // B)):
        probs = probs_fn(feats)
        for b in range(B):
            np.add.at(pools[int(cloud_idx[b])], idx[b], probs[b])

    cm = np.zeros((K, K), np.float64)
    if args.save_preds:
        os.makedirs(args.save_preds, exist_ok=True)
    n_scored = 0
    for ci, cloud in enumerate(sampler.clouds):
        if not pools[ci].any():
            # never sampled: an all-zero pool would score every point class 0
            continue
        n_scored += 1
        sub_pred = pools[ci].argmax(axis=1)
        y, p = cloud.labels, sub_pred  # sub-cloud resolution, the fallback
        proj_path = os.path.join(args.randla_dir, cloud.name + "_proj.pkl")
        if os.path.exists(proj_path):
            with open(proj_path, "rb") as f:
                proj_idx, full_labels = pickle.load(f)
            proj_idx = np.asarray(proj_idx).reshape(-1)
            full_labels = np.asarray(full_labels, np.int64).reshape(-1)
            if len(proj_idx) == len(full_labels):
                y, p = full_labels, sub_pred[proj_idx]
                if args.save_preds:
                    write_ply(os.path.join(args.save_preds, cloud.name + ".ply"),
                              [p.astype(np.int32)], ["pred"])
            else:
                # the reference's Semantic3D prep pickles proj indices over
                # the 0.01-grid points beside raw-cloud labels
                # (`data_prepare_semantic3d.py:56-59`); cli.prepare writes
                # matched pairs
                log.warning("%s: proj/labels length mismatch (%d vs %d) — scoring at "
                            "sub-cloud resolution", cloud.name, len(proj_idx),
                            len(full_labels))
        np.add.at(cm, _reduced(y, p), 1.0)
        if args.visual:
            # per-cloud pred / gt label clouds + HTML at the sub-cloud
            # resolution; gt in the predictions' reduced class space, the
            # ignored points in the palette's slot K
            from pointsecguard_tpu_torch.utils.logging import write_label_cloud
            from pointsecguard_tpu_torch.utils.viz import export_html_viewer

            vis_dir = os.path.join(args.log_dir, "visual")
            os.makedirs(vis_dir, exist_ok=True)
            base = os.path.join(vis_dir, cloud.name)
            valid, gt_disp = preset.reduce(np.asarray(cloud.labels).astype(int))
            gt_disp[~valid] = K
            write_label_cloud(base + "_pred.xyzrgb", cloud.xyz, sub_pred)
            write_label_cloud(base + "_gt.xyzrgb", cloud.xyz, gt_disp)
            export_html_viewer(base + "_pred.html", cloud.xyz, labels=sub_pred,
                               title=f"{cloud.name} predictions")
    if n_scored < len(sampler.clouds):
        log.info("scored %d/%d clouds (raise --num_clouds to cover all)",
                 n_scored, len(sampler.clouds))
    m = metrics_from_confusion(cm)
    for cls, iou in zip(preset.class_names, m.class_iou):
        log.info("%18s: %.4f", cls, iou)
    log.info("RANDLA mIoU %.4f acc %.4f", m.miou, m.accuracy)
    return m


def _eval_cls(args, log):
    """ModelNet classification (``pointsecguard_tpu/cli/eval.py:244-316``,
    ``_restore_object_state`` and ``_eval_cls``): the test split through
    ``evaluate_cls`` with ``--num_votes`` votes pooled in softmax space
    (vote 0 the first N points, later votes random subsets from
    ``--seed``); logs the instance and the mean class accuracy."""
    import numpy as np

    from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset
    from pointsecguard_tpu_torch.train.object_eval import evaluate_cls
    from pointsecguard_tpu_torch.train.trainer import cls_model, make_logp_step
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    use_normals = not args.no_normals
    ds = ModelNetDataset(args.data_root, "test", num_point=args.num_point or 1024,
                         num_category=args.num_category, use_normals=use_normals)
    model, family = cls_model(args.model, ds.num_classes, use_normals)
    model.load_state_dict(load_checkpoint(args.log_dir))
    model.to(device).eval().requires_grad_(False)
    inst_acc, class_acc, _ = evaluate_cls(make_logp_step(model, device, family), ds,
                                          batch_size=args.batch_size,
                                          num_votes=args.num_votes,
                                          rng=np.random.default_rng(args.seed))
    log.info("CLS instance accuracy %.4f  class accuracy %.4f (%d shapes, %d votes)",
             inst_acc, class_acc, len(ds), args.num_votes)
    return inst_acc, class_acc


def main(argv=None):
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    logging.basicConfig(level=logging.INFO, format="%(message)s", force=True)
    log = logging.getLogger("eval")
    if args.model == "randla":
        return _eval_randla(args, log)
    if args.model in CLS_MODELS:
        if args.visual or args.adv_set:
            raise SystemExit(
                "--visual and --adv_set cover the segmentation models; a "
                "classifier has no scene to render and no saved block set")
        args.batch_size = args.batch_size or 16
        return _eval_cls(args, log)

    import numpy as np

    from pointsecguard_tpu_torch.data import S3DIS_CLASSES, RoomSet
    from pointsecguard_tpu_torch.models import DenseDeepGCN
    from pointsecguard_tpu_torch.train.evaluator import evaluate_whole_scenes
    from pointsecguard_tpu_torch.train.trainer import (
        POINTNET_MODELS,
        make_eval_step,
        resgcn_family,
    )
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    args.batch_size = args.batch_size or 16
    args.num_point = args.num_point or 4096

    # ResGCN: block evaluation of the dense GCN (`ResGCN/sem_seg_dense/
    # test.py:40-66`); whole-scene voting at num_votes=1 is the same pass
    if args.model == "resgcn":
        model, family = DenseDeepGCN(**resgcn_overrides(args)), resgcn_family()
    else:
        model_cls, family = POINTNET_MODELS[args.model]
        model = model_cls()
    model.load_state_dict(load_checkpoint(args.log_dir))
    model.to(device).eval().requires_grad_(False)
    predict = make_eval_step(model, device, family)

    if args.adv_set:
        n, m = _adv_set_metrics(predict, args.adv_set, args.batch_size, 13)
        log.info("---- class IoU ----")
        for cls, iou in zip(S3DIS_CLASSES, m.class_iou):
            log.info("%12s: %.4f", cls, iou)
        log.info("ADVSET %s: %d blocks  mIoU %.4f  acc %.4f",
                 os.path.basename(args.adv_set), n, m.miou, m.accuracy)
        return m

    rooms = RoomSet.load(args.data_root, "test", args.test_area)
    total, per_room = evaluate_whole_scenes(
        predict, rooms, batch_size=args.batch_size, num_votes=args.num_votes,
        block_points=args.num_point, rng=np.random.default_rng(args.seed),
        visual_dir=os.path.join(args.log_dir, "visual") if args.visual else None,
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
