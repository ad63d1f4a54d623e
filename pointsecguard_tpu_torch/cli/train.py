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
  python -m pointsecguard_tpu_torch.cli.train --model pointnet2_part_seg \
      --data_root data/shapenetcore_partanno_segmentation_benchmark_v0_normal \
      --log_dir log/partseg

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
``--prefetch``; ``--model pointnet2_part_seg``, ``pointnet2_part_seg_msg``
and ``pointnet_part_seg`` (the ShapeNetPart part-seg nets,
``train_partseg``) with ``--data_root`` (a ShapeNetPart tree),
``--no_normals``, ``--npoint`` (0 → 2048), ``--batch_size`` (0 → 16) and
the classifiers' other flags. The training extras: ``--steps_per_call``
(every model), ``--device_sampler`` and ``--device_sampler_exact`` (the
PointNet family and resgcn), ``--adv_train nb`` with ``--adv_eps``,
``--adv_alpha``, ``--adv_iters`` and ``--adv_rand_init`` (the PointNet
family, resgcn, randla on s3dis or semantic3d), ``--remat`` (resgcn) and
``--profile DIR`` (the PointNet family). ``--precision bfloat16`` (every
model) runs the Linear products in bf16 with float32 parameters. It runs on
the GPU; ``--device
cpu`` runs the plain PyTorch path by request. ``--devices N`` trains
data-parallel on N ranks (``parallel/``: one card each over NCCL, or N
processes over gloo with ``--device cpu``), ``--shard_points P`` (the
semseg families) splits each cloud's points over P of them, and the run
computes what ``--devices 1`` computes on the whole batch;
``--device_sampler`` takes ``--devices`` but not ``--shard_points``, as in
JAX. An extra with a model that does not read it (which the JAX CLI would
ignore) is accepted by name and stops the run with "not ported yet"
instead of being ignored.
"""

from __future__ import annotations

import argparse
import logging
import time

from pointsecguard_tpu_torch.configs import (
    add_parallel_arguments,
    add_precision_argument,
    add_resgcn_arguments,
    resgcn_refusals,
)

_MODELS = ["pointnet2", "pointnet2_msg", "pointnet", "randla", "resgcn",
           "pointnet_cls", "pointnet2_cls", "pointnet2_cls_msg",
           "pointnet_part_seg", "pointnet2_part_seg", "pointnet2_part_seg_msg"]
CLS_MODELS = ("pointnet_cls", "pointnet2_cls", "pointnet2_cls_msg")
PART_SEG_MODELS = ("pointnet_part_seg", "pointnet2_part_seg", "pointnet2_part_seg_msg")
POINTNET_FAMILY = ("pointnet2", "pointnet2_msg", "pointnet")
PORTED_MODELS = (*POINTNET_FAMILY, "randla", "resgcn", *CLS_MODELS, *PART_SEG_MODELS)
# the object tasks' data flags with the models that read them: refused with
# any other model (the JAX CLI would ignore them there)
CLS_DEFAULTS = {"num_category": 40, "no_normals": False}
_FLAG_MODELS = {"num_category": CLS_MODELS, "no_normals": CLS_MODELS + PART_SEG_MODELS}
# the training extras that not every loop reads, with the models whose
# loops read them (JAX `train/loops.py`; --steps_per_call is read by every
# loop); the adv_* budget is read under --adv_train nb
_ADV_BUDGET = ("adv_eps", "adv_alpha", "adv_iters", "adv_rand_init")
_EXTRA_MODELS = {
    "profile": POINTNET_FAMILY,
    "adv_train": (*POINTNET_FAMILY, "resgcn", "randla"),
    "remat": ("resgcn",), "device_sampler": (*POINTNET_FAMILY, "resgcn"),
    "device_sampler_exact": (*POINTNET_FAMILY, "resgcn"),
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("train")
    ap.add_argument("--model", default="pointnet2", choices=_MODELS)
    ap.add_argument("--data_root", default="data/stanford_indoor3d")
    ap.add_argument("--log_dir", default="log/run")
    ap.add_argument("--test_area", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=0,
                    help="0 = 32 (pointnet2, pointnet2_msg, pointnet), the "
                         "config's 6 (randla), 8 (resgcn), 24 (the classifiers), "
                         "16 (the part-seg nets)")
    ap.add_argument("--npoint", type=int, default=0,
                    help="points per sample (0 = 4096 a block, 1024 a ModelNet shape, "
                         "2048 a ShapeNetPart shape)")
    ap.add_argument("--num_category", type=int, default=40,
                    help="classifiers: ModelNet10 or ModelNet40 lists")
    ap.add_argument("--no_normals", action="store_true",
                    help="classifiers and part-seg nets: xyz only (no normal channels)")
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
    add_precision_argument(ap)
    add_resgcn_arguments(ap)
    add_parallel_arguments(ap)
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="optimizer steps a call, on batches stacked that deep")
    ap.add_argument("--device_sampler", action="store_true",
                    help="pointnet family, resgcn: stage the rooms on the device and "
                         "draw the training blocks there (data/device_sampler.py)")
    ap.add_argument("--device_sampler_exact", action="store_true",
                    help="with --device_sampler: draw a block's points without "
                         "replacement where it holds enough (Gumbel top-k)")
    ap.add_argument("--adv_train", default="none",
                    help="nb: train on batches crafted by the NB colour attack against "
                         "the current parameters (pointnet family, resgcn, randla "
                         "s3dis / semantic3d)")
    ap.add_argument("--adv_eps", type=float, default=0.1, help="--adv_train: L-inf budget")
    ap.add_argument("--adv_alpha", type=float, default=0.05, help="--adv_train: step size")
    ap.add_argument("--adv_iters", type=int, default=5, help="--adv_train: PGD iterations")
    ap.add_argument("--adv_rand_init", type=float, default=0.0,
                    help="--adv_train: uniform random start inside the ball (0 = clean)")
    ap.add_argument("--remat", action="store_true",
                    help="resgcn: recompute each backbone block in the backward")
    ap.add_argument("--profile", default=None,
                    help="pointnet family: a torch.profiler trace of the first epoch's "
                         "training, written under this directory")
    return ap


def _refuse_unported(args) -> None:
    if args.shard_points > 1 and args.model in CLS_MODELS + PART_SEG_MODELS:
        # JAX `cli/train.py:185-191`
        raise SystemExit("--shard_points covers the semseg families "
                         "(pointnet/pointnet2[_msg]/randla/resgcn)")
    if args.device_sampler and args.shard_points > 1:
        # JAX `train/loops.py:148-152`
        raise SystemExit("--device_sampler composes with --devices (DP) but not "
                         "--shard_points; use the host pipeline for SP")
    refused = [f"--model {args.model}"] if args.model not in PORTED_MODELS else []
    refused += extra_refusals(args)
    refused += cls_refusals(args)
    refused += resgcn_refusals(args)
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def extra_refusals(args) -> list[str]:
    """The training extras with a model (or a dataset, or without the flag)
    that does not read them, and ``--adv_train`` values other than nb."""
    defaults = _parser()

    def flag(name):
        value = getattr(args, name)
        return f"--{name}" if isinstance(value, bool) else f"--{name} {value}"

    def given(name):
        return getattr(args, name) != defaults.get_default(name)

    refused = [f"{flag(name)} (with --model {args.model})"
               for name, models in _EXTRA_MODELS.items()
               if given(name) and args.model not in models]
    if args.adv_train not in ("none", "nb"):
        refused.append(f"--adv_train {args.adv_train}")
    elif (args.adv_train == "nb" and args.model == "randla"
          and args.randla_dataset == "semantickitti"):
        # JAX `train/loops.py:359-368`: the attack perturbs colours
        refused.append("--adv_train nb (with --randla_dataset semantickitti: xyz-only "
                       "features)")
    if args.adv_train == "none":
        refused += [f"{flag(name)} (without --adv_train nb)" for name in _ADV_BUDGET
                    if given(name)]
    if args.device_sampler_exact and not args.device_sampler:
        refused.append("--device_sampler_exact (without --device_sampler)")
    return refused


def cls_refusals(args) -> list[str]:
    """The object tasks' data flags away from their defaults with a model
    that does not read them."""
    return [f"--{name}" + ("" if isinstance(d, bool) else f" {getattr(args, name)}")
            + f" (with --model {args.model})"
            for name, d in CLS_DEFAULTS.items()
            if getattr(args, name) != d and args.model not in _FLAG_MODELS[name]]


def main(argv=None):
    """Parse, refuse, and train on one device or on the ranks of
    ``--devices`` (``parallel.run_cli``); returns the loop's result (rank
    0's best metric, its state only without ranks)."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    from pointsecguard_tpu_torch.parallel import run_cli

    return run_cli(_train, args, device=args.device)


def _train(args, ctx=None):
    """One process's training: the whole run, or rank ``ctx.rank`` of it
    (only rank 0 writes the log file)."""
    from pointsecguard_tpu_torch.parallel import is_main
    from pointsecguard_tpu_torch.train.loops import (
        train_cls,
        train_partseg,
        train_pointnet_family,
        train_randla,
        train_resgcn,
    )
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    device = ctx.device if ctx is not None else resolve_device(args.device)
    handlers = [logging.StreamHandler()]
    if is_main(ctx):
        handlers.append(
            logging.FileHandler(f"{args.log_dir.rstrip('/')}.train.log", delay=True))
    logging.basicConfig(level=logging.INFO if is_main(ctx) else logging.WARNING,
                        format="%(asctime)s %(message)s", force=True, handlers=handlers)
    t0 = time.time()
    rank = {} if ctx is None else {"ctx": ctx}  # a loop's ctx, under --devices
    if args.model == "randla":
        result = train_randla(args, device, **rank)
    elif args.model == "resgcn":
        result = train_resgcn(args, device, **rank)
    elif args.model in CLS_MODELS:
        result = train_cls(args, device, **rank)  # npoint 0 → the loop's 1024
    elif args.model in PART_SEG_MODELS:
        result = train_partseg(args, device, **rank)  # npoint 0 → the loop's 2048
    else:
        args.npoint = args.npoint or 4096
        result = train_pointnet_family(args, device, **rank)
    logging.info("total wall time %.1f s", time.time() - t0)
    return result


if __name__ == "__main__":
    main()
