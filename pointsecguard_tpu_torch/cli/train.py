"""Training CLI of the port (port of ``pointsecguard_tpu/cli/train.py``):

  python -m pointsecguard_tpu_torch.cli.train --model pointnet2 \
      --data_root data/stanford_indoor3d --log_dir log/pointnet2 [--epochs 32]
  python -m pointsecguard_tpu_torch.cli.train --model randla \
      --randla_dir data/randla_input_0.040 --log_dir log/randla [--epochs 32]
  python -m pointsecguard_tpu_torch.cli.train --model randla \
      --randla_dataset semantic3d --randla_dir data/semantic3d/input_0.060 \
      --log_dir log/randla_sem3d
  python -m pointsecguard_tpu_torch.cli.train --model resgcn \
      --data_root data/stanford_indoor3d --log_dir log/resgcn [--epochs 32]
  python -m pointsecguard_tpu_torch.cli.train --model pointnet2_cls \
      --data_root data/modelnet40_normal_resampled --log_dir log/cls

Ported: ``--model pointnet2``, ``pointnet2_msg`` and ``pointnet``
(PointNet++ SSG and MSG, PointNet on S3DIS blocks through the host
sampler) with ``--data_root``, ``--log_dir``, ``--test_area``,
``--epochs``, ``--batch_size`` (0 → 32), ``--npoint`` (0 → 4096),
``--min_block_points``, ``--learning_rate`` (0 → 0.001), ``--seed``,
``--prefetch`` and ``--eval_every``; ``--model randla`` (RandLA-Net on
the tree ``cli.prepare`` wrote) with ``--randla_dataset
s3dis|semantickitti|semantic3d`` (the preset: config, label space, loader;
SemanticKITTI trains on xyz-only features), ``--randla_dir``,
``--randla_points`` (0 → the preset's 40960, 45056 or 65536),
``--steps_per_epoch`` (0 → 500), ``--val_steps`` (0 → 100),
``--batch_size`` (0 → the preset's 6, 6 or 4),
``--learning_rate`` (0 → 1e-2), ``--log_dir``, ``--test_area``,
``--epochs``, ``--seed`` and ``--prefetch``; RandLA validates after every
epoch; ``--model resgcn`` (ResGCN-28 on S3DIS blocks through the host
sampler, no evaluation in the loop, ``latest.pt`` kept) with
``--data_root``, ``--log_dir``, ``--test_area``, ``--epochs``,
``--batch_size`` (0 → 8), ``--npoint`` (0 → 4096), ``--min_block_points``,
``--learning_rate`` (0 → 1e-3), ``--seed``, ``--prefetch`` and the
``--resgcn_*`` model flags; ``--model pointnet2_cls``, ``pointnet2_cls_msg``
and ``pointnet_cls`` (the ModelNet classifiers, ``train_cls``) with
``--data_root`` (a ModelNet tree), ``--num_category``, ``--no_normals``,
``--npoint`` (0 → 1024), ``--batch_size`` (0 → 24), ``--learning_rate``
(0 → 1e-3), ``--eval_every``, ``--log_dir``, ``--epochs``, ``--seed`` and
``--prefetch``. It runs on the GPU; ``--device cpu`` runs the plain PyTorch path
by request. Every other flag of the JAX CLI is accepted by name and stops
the run with "not ported yet" instead of being ignored.
"""

from __future__ import annotations

import argparse
import logging
import time

from pointsecguard_tpu_torch.configs import add_resgcn_arguments, resgcn_refusals

_MODELS = ["pointnet2", "pointnet2_msg", "pointnet", "randla", "resgcn",
           "pointnet_cls", "pointnet2_cls", "pointnet2_cls_msg",
           "pointnet_part_seg", "pointnet2_part_seg", "pointnet2_part_seg_msg"]
CLS_MODELS = ("pointnet_cls", "pointnet2_cls", "pointnet2_cls_msg")
PORTED_MODELS = ("pointnet2", "pointnet2_msg", "pointnet", "randla", "resgcn", *CLS_MODELS)
# the classifiers' data flags: taken with a classifier, refused with any
# other model (the JAX CLI would ignore them there)
CLS_DEFAULTS = {"num_category": 40, "no_normals": False}
# JAX CLI flags this port does not implement yet, with the one value
# (the JAX default) that is accepted
_UNPORTED_DEFAULTS = {
    "precision": "float32", "steps_per_call": 1,
    "profile": None, "devices": 1, "shard_points": 1, "adv_train": "none",
    "adv_eps": 0.1, "adv_alpha": 0.05, "adv_iters": 5, "adv_rand_init": 0.0,
}
_UNPORTED_SWITCHES = ("remat", "device_sampler", "device_sampler_exact")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("train")
    ap.add_argument("--model", default="pointnet2", choices=_MODELS)
    ap.add_argument("--data_root", default="data/stanford_indoor3d")
    ap.add_argument("--log_dir", default="log/run")
    ap.add_argument("--test_area", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=0,
                    help="0 = 32 (pointnet2, pointnet2_msg, pointnet), the "
                         "config's 6 (randla), 8 (resgcn), 24 (the classifiers)")
    ap.add_argument("--npoint", type=int, default=0,
                    help="points per sample (0 = 4096 a block, 1024 a ModelNet shape)")
    ap.add_argument("--num_category", type=int, default=40,
                    help="classifiers: ModelNet10 or ModelNet40 lists")
    ap.add_argument("--no_normals", action="store_true",
                    help="classifiers: xyz only (no normal channels)")
    ap.add_argument("--min_block_points", type=int, default=1024,
                    help="block sampler: accept training blocks with more "
                         "than this many raw points (`S3DISDataLoader.py:52-60`)")
    ap.add_argument("--learning_rate", type=float, default=0.0,
                    help="0 = 0.001 (the PointNet family), the config's 1e-2 (randla), "
                         "its 1e-3 (resgcn)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches staged ahead by the background host "
                         "pipeline (sample + augment + copy to the device); "
                         "0 = synchronous")
    ap.add_argument("--eval_every", type=int, default=1)
    ap.add_argument("--randla_dir", default="data/randla_input_0.040",
                    help="randla: the prepared tree (cli.prepare)")
    ap.add_argument("--randla_dataset",
                    choices=["s3dis", "semantickitti", "semantic3d"],
                    default="s3dis",
                    help="randla only: dataset preset + prepared-tree "
                         "layout (`helper_tool.py:18-100` configs; "
                         "kitti/sem3d read cli.prepare artifact trees)")
    ap.add_argument("--randla_points", type=int, default=0,
                    help="randla: points per cloud (0 = the preset config's 40960, "
                         "45056 semantickitti, 65536 semantic3d)")
    ap.add_argument("--steps_per_epoch", type=int, default=0,
                    help="randla: optimizer steps per epoch (0 = the config's 500)")
    ap.add_argument("--val_steps", type=int, default=0,
                    help="randla: validation clouds per epoch (0 = the config's 100)")
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
    refused += cls_refusals(args)
    refused += resgcn_refusals(args)
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def cls_refusals(args) -> list[str]:
    """The classifiers' data flags away from their defaults with another
    model."""
    if args.model in CLS_MODELS:
        return []
    return [f"--{name}" + ("" if isinstance(d, bool) else f" {getattr(args, name)}")
            + f" (with --model {args.model})"
            for name, d in CLS_DEFAULTS.items() if getattr(args, name) != d]


def main(argv=None):
    args = _parser().parse_args(argv)
    _refuse_unported(args)

    from pointsecguard_tpu_torch.train.loops import (
        train_cls,
        train_pointnet_family,
        train_randla,
        train_resgcn,
    )
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(message)s",
        force=True,
        handlers=[
            logging.StreamHandler(),
            logging.FileHandler(f"{args.log_dir.rstrip('/')}.train.log", delay=True),
        ],
    )
    t0 = time.time()
    if args.model == "randla":
        result = train_randla(args, device)
    elif args.model == "resgcn":
        result = train_resgcn(args, device)
    elif args.model in CLS_MODELS:
        result = train_cls(args, device)  # npoint 0 → the loop's 1024
    else:
        args.npoint = args.npoint or 4096
        result = train_pointnet_family(args, device)
    logging.info("total wall time %.1f s", time.time() - t0)
    return result


if __name__ == "__main__":
    main()
