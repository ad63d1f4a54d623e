"""Attacks on the object-task models in the coordinate domain: the
ModelNet classifiers and the ShapeNetPart part-seg nets (port of
``pointsecguard_tpu/cli/attack_object.py``):

  python -m pointsecguard_tpu_torch.cli.attack_object --model pointnet2_cls \
      --data_root data/modelnet40_normal_resampled --log_dir log/cls --attack nb
  python -m pointsecguard_tpu_torch.cli.attack_object --model pointnet2_part_seg \
      --data_root data/shapenetcore_partanno_segmentation_benchmark_v0_normal \
      --log_dir log/partseg --attack tar_nb --origin 12 --target 13

The PGD and C&W engines of ``cli.attack`` with the perturbation domain
moved from the colours to the coordinates: channels (0, 3), no clip (the
shapes are normalised into the unit sphere, so C&W's tanh box is (−1, 1));
the normals, when given, do not move. The classifier's [B, K]
log-probabilities are wrapped as [B, 1, K] one-point clouds, so the
per-point engines score one prediction per shape; a part-seg net is
per-point as the segmentation victims are, its category one-hot riding
with every forward (2048 points and batch 8 by default). Under
``tar_nb`` / ``tar_nu`` with ``--origin`` ≥ 0 only the points of part
``--origin`` move (``make_target_labels``, the semantic-segmentation
targeted protocol on part labels).

By default the geometry (FPS and ball query on the FPS and bottom-k
kernels) is built again in every forward of the attack: the points move,
and the neighbourhoods with them, and the centres carry their gradient
(``models.pointnet2_cls.moving_geometry``; a part-seg net's 3-NN weights
too, ``moving_geometry_partseg``). ``--fixed_geometry`` freezes it
at the clean shape instead (faster; the neighbourhoods then stop following
the points). ``--defense sor|srs`` deploys statistical outlier removal
(kNN kernel, k + 1 neighbours) or random subsampling; every reported
prediction (clean, adversarial, control) is the deployed defense's, and
the attacker differentiates through it (with ``--eot K``, the mean over K
fixed SRS draws). ``--control`` adds the equal-norm random control.

Per shape one TSV row in ``<log_dir>/<model>_<attack>_object.tsv``
(classifiers: ``idx, label, clean_pred, adv_pred, l2[, rand_pred]``;
part-seg: ``idx, category, clean_miou, adv_miou, l2[, rand_miou]``, the
mIoU over the category's parts, a row that a defense replaced scored
against its own label), and the JAX CLI's summary line. ``--precision
bfloat16`` runs the model's Linear products in bf16. It runs on the
GPU; ``--device cpu`` runs the plain PyTorch path by request.
``--devices N`` attacks data-parallel on N ranks (``parallel/``; no points
axis, as in JAX): each rank attacks its rows of every batch, the results
are gathered and rank 0 writes the TSV.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

from pointsecguard_tpu_torch.cli.train import CLS_MODELS, PART_SEG_MODELS
from pointsecguard_tpu_torch.configs import add_parallel_arguments, add_precision_argument


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("attack_object")
    ap.add_argument("--model", default="pointnet2_cls", choices=[*CLS_MODELS, *PART_SEG_MODELS])
    ap.add_argument("--attack", default="nb", choices=["nb", "nu", "tar_nb", "tar_nu", "random"])
    ap.add_argument("--data_root", default="data/modelnet40_normal_resampled")
    ap.add_argument("--log_dir", default="log/run")
    ap.add_argument("--num_point", type=int, default=0,
                    help="0 = 1024 a ModelNet shape, 2048 a ShapeNetPart shape")
    ap.add_argument("--batch_size", type=int, default=0,
                    help="0 = 16 (classifiers), 8 (part-seg nets)")
    ap.add_argument("--num_category", type=int, default=40)
    ap.add_argument("--no_normals", action="store_true")
    ap.add_argument("--max_shapes", type=int, default=0, help="0 = all")
    ap.add_argument("--seed", type=int, default=0)
    # norm-bounded budget (an L∞ ball on the xyz)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=0.005)
    ap.add_argument("--iters", type=int, default=50)
    # norm-unbounded (C&W) budget
    ap.add_argument("--c", type=float, default=0.1, help="C&W distortion-term coefficient")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--kappa", type=float, default=0.0)
    ap.add_argument("--smooth", type=float, default=0.0,
                    help="C&W kNN smoothness coefficient on the moved points")
    ap.add_argument("--target", type=int, default=0,
                    help="the target class (part-seg: the target part)")
    ap.add_argument("--noise_norm", type=float, default=1.0,
                    help="--attack random: per-shape L2 of the noise")
    ap.add_argument("--control", action="store_true",
                    help="also score equal-norm random noise")
    ap.add_argument("--fixed_geometry", action="store_true",
                    help="freeze the FPS / ball-query plan at the clean shape")
    ap.add_argument("--defense", default="none", choices=["none", "sor", "srs"])
    ap.add_argument("--defense_knn", type=int, default=10,
                    help="sor: neighbours per point for the mean-distance statistic")
    ap.add_argument("--defense_alpha", type=float, default=1.1,
                    help="sor: outlier threshold mu + alpha*sigma")
    ap.add_argument("--defense_ratio", type=float, default=0.875,
                    help="srs: fraction of points kept")
    ap.add_argument("--eot", type=int, default=1,
                    help="srs: average the attack gradient over this many draws")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) needs a card and raises without one; cpu "
                         "runs the plain PyTorch path")
    add_parallel_arguments(ap, shard_points=False)
    add_precision_argument(ap)
    ap.add_argument("--origin", type=int, default=-1,
                    help="part-seg tar_*: only the points of this part move "
                         "(-1: every point)")
    return ap


def _refuse_unported(args) -> None:
    refused = []
    if args.origin >= 0 and args.model in CLS_MODELS:
        refused.append(f"--origin {args.origin} (with --model {args.model}: part-seg only)")
    if args.num_category != 40 and args.model in PART_SEG_MODELS:
        refused.append(f"--num_category {args.num_category} (with --model {args.model})")
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def defense_wrapper(args):
    """``--defense`` / ``--eot``: None or ``(eval_wrap, attack_wrap)``
    (the contract of ``cli._attack_common.defense_wrapper``). SOR is
    deterministic; SRS's deployed draw and its EoT draws come from
    ``--seed`` + 99 on the CPU."""
    from pointsecguard_tpu_torch.attacks import (
        randomized_defense_wraps,
        seeded_draws,
        simple_random_subsample,
        srs_donors,
        statistical_outlier_removal,
    )

    if args.eot > 1 and args.defense != "srs":
        raise SystemExit("--eot requires the randomized srs defense; sor is deterministic "
                         "(the attacker already sees it exactly)")
    if args.defense == "none":
        return None
    if args.defense == "sor":
        def wrap(f):
            return lambda p: f(statistical_outlier_removal(p, args.defense_knn,
                                                           args.defense_alpha))
        return wrap, wrap
    ratio = args.defense_ratio
    return randomized_defense_wraps(
        lambda p, d: simple_random_subsample(p, ratio, donor=d),
        seeded_draws(lambda shape, g: srs_donors(shape, ratio, g), args.seed + 99),
        args.eot)


def attack_config(args, num_classes: int):
    """The engine's config of ``--attack`` (None for random) on the
    coordinates."""
    from pointsecguard_tpu_torch.attacks import CWConfig, PGDConfig

    targeted = args.attack.startswith("tar_")
    if args.attack in ("nb", "tar_nb"):
        return PGDConfig(eps=args.eps, alpha=args.alpha, iters=args.iters, loss="ce",
                         ce_reduction="mean", targeted=targeted, target=args.target,
                         num_classes=num_classes, channels=(0, 3), clip=None)
    if args.attack in ("nu", "tar_nu"):
        return CWConfig(steps=args.steps, lr=args.lr, kappa=args.kappa, flavor="torch",
                        f_coeff=1.0, smooth_coeff=args.smooth, l2_coeff=args.c,
                        targeted=targeted, target=args.target, num_classes=num_classes,
                        success_acc=1.0 / num_classes, channels=(0, 3), box=(-1.0, 1.0))
    return None


def main(argv=None):
    """Parse, refuse, and attack on one device or on the ranks of
    ``--devices`` (``parallel.run_cli``); returns rank 0's summary."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    from pointsecguard_tpu_torch.parallel import run_cli

    return run_cli(_attack_object, args, device=args.device)


def _attack_object(args, ctx=None):
    from pointsecguard_tpu_torch.parallel import gather_rows, is_main, make_batch_put

    logging.basicConfig(level=logging.INFO if is_main(ctx) else logging.WARNING,
                        format="%(message)s", force=True)
    log = logging.getLogger("attack_object")

    import numpy as np
    import torch

    from pointsecguard_tpu_torch.attacks import (
        PGDConfig,
        cw_color_attack,
        equal_norm_color_noise,
        make_target_labels,
        pgd_color_attack,
    )
    from pointsecguard_tpu_torch.train.object_eval import _padded_batches, shape_part_ious
    from pointsecguard_tpu_torch.train.trainer import cls_model
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.runtime import model_dtype, resolve_device

    device = ctx.device if ctx is not None else resolve_device(args.device)
    use_normals = not args.no_normals
    part = args.model in PART_SEG_MODELS
    B = args.batch_size or (8 if part else 16)
    rows = make_batch_put(ctx, batch_size=B, device=device)  # this rank's rows
    if part:
        from pointsecguard_tpu_torch.data.shapenet_part import (
            NUM_OBJECT_CLASSES,
            NUM_PART_CLASSES,
            ShapeNetPartDataset,
        )

        dataset = ShapeNetPartDataset(args.data_root, "test", num_point=args.num_point or 2048,
                                      use_normals=use_normals)
        num_classes = NUM_PART_CLASSES
    else:
        from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset

        dataset = ModelNetDataset(args.data_root, "test", num_point=args.num_point or 1024,
                                  num_category=args.num_category, use_normals=use_normals)
        num_classes = dataset.num_classes
    model, _ = cls_model(args.model, num_classes, use_normals, model_dtype(args.precision))
    model.load_state_dict(load_checkpoint(args.log_dir))
    model.to(device).eval().requires_grad_(False)
    build = getattr(model, "build_geometry", None)
    if args.fixed_geometry and build is None:
        log.info("%s has no point-group geometry; --fixed_geometry is a no-op", args.model)

    def make_outputs_fn(pts, one_hot=None):
        """Part-seg: [B, N, 50] log-probabilities of ``one_hot``'s
        categories; classifiers: [B, 1, K]. The geometry fixed at ``pts``
        with --fixed_geometry, else built in every forward."""
        kw = {"geometry": build(pts[..., :3])} if args.fixed_geometry and build else {}
        if part:
            return lambda p: model(p, one_hot, **kw)[0]
        return lambda p: model(p, **kw)[0][:, None, :]

    eval_wrap, attack_wrap = defense_wrapper(args) or (lambda f: f, lambda f: f)
    cfg = attack_config(args, num_classes)
    if args.attack == "random" and args.control:
        # the attack is the equal-norm noise itself
        log.info("--control is a no-op with --attack random; ignoring")
        args.control = False
    targeted = args.attack.startswith("tar_")
    xyz = {"channels": (0, 3), "clip": None, "centered": True}
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def run(pts, labels, one_hot=None):
        """(clean, adversarial, control outputs, per-shape L2): every output
        under the deployed defense (no gradient), the attack through
        ``attack_wrap``. ``labels`` [B, N] (part-seg) or [B, 1]; under
        tar_* with --origin ≥ 0 only the part's points move."""
        f = make_outputs_fn(pts, one_hot)  # --fixed_geometry: built once a batch
        f_eval, f_att = eval_wrap(f), attack_wrap(f)
        mask = None
        if part and targeted and args.origin >= 0:
            _, mask = make_target_labels(labels, args.origin, args.target)
        with torch.no_grad():
            clean = f_eval(pts)
        if cfg is None:
            l2 = torch.full((len(pts),), args.noise_norm, device=device)
            adv = equal_norm_color_noise(pts, l2, mask=mask, generator=gen, **xyz)
        else:
            attack = pgd_color_attack if isinstance(cfg, PGDConfig) else cw_color_attack
            res = attack(f_att, pts, labels, cfg, mask=mask)
            adv, l2 = res.points_adv, res.l2_dist
        with torch.no_grad():
            rand = clean
            if args.control:
                rand = f_eval(equal_norm_color_noise(pts, l2, mask=mask, generator=gen, **xyz))
            return clean, f_eval(adv), rand, l2

    os.makedirs(args.log_dir, exist_ok=True)
    tsv_path = os.path.join(args.log_dir, f"{args.model}_{args.attack}_object.tsv")
    n = min(len(dataset), args.max_shapes) if args.max_shapes else len(dataset)
    if part:
        columns = ("category", "clean_miou", "adv_miou", "l2", "rand_miou")
    else:
        columns = ("label", "clean_pred", "adv_pred", "l2", "rand_pred")
    scores = {c: np.zeros(n, np.float64 if part or c == "l2" else np.int64)
              for c in columns[1:]}
    batch_ms = []
    with open(tsv_path if is_main(ctx) else os.devnull, "w") as tsv:
        tsv.write("\t".join(("idx",) + columns[:4 + args.control]) + "\n")
        for idx, n_valid in _padded_batches(n, B):
            loaded = [dataset.load(int(i)) for i in idx]
            pts = rows(np.stack([l[0] for l in loaded]))
            if part:
                seg = np.stack([l[2] for l in loaded]).astype(np.int64)
                labels = rows(seg)
                one_hot = rows(np.eye(NUM_OBJECT_CLASSES, dtype=np.float32)[
                    [l[1] for l in loaded]])
            else:
                labs = np.array([l[1] for l in loaded], np.int64)
                labels, one_hot = rows(labs[:, None]), None  # [b, 1]: the rank's rows
            t0 = time.perf_counter()
            out = run(pts, labels, one_hot)
            if not part:  # the predictions, on the card
                out = (*(torch.argmax(o, dim=-1)[:, 0] for o in out[:3]), out[3])
            # one read of the batch's results, the ranks' rows gathered
            clean, adv, rand, l2 = (gather_rows(t, ctx).cpu().numpy() for t in out)
            batch_ms.append(1e3 * (time.perf_counter() - t0))
            for j in range(n_valid):
                i = int(idx[j])
                if part:
                    cat = dataset.categories[i]
                    mc, ma, mr = (float(np.mean(shape_part_ious(o[j], seg[j], cat)))
                                  for o in (clean, adv, rand))
                    values = (mc, ma, l2[j], mr)
                    cells = [cat, f"{mc:.4f}", f"{ma:.4f}", f"{l2[j]:.6f}", f"{mr:.4f}"]
                else:
                    values = (clean[j], adv[j], l2[j], rand[j])
                    cells = [str(v) for v in (labs[j], clean[j], adv[j])]
                    cells += [f"{l2[j]:.6f}", str(rand[j])]
                for c, v in zip(columns[1:], values):
                    scores[c][i] = v
                tsv.write("\t".join([str(i), *cells[:4 + args.control]]) + "\n")
    l2_mean = float(scores["l2"].mean())
    if part:
        result = {"clean_miou": float(scores["clean_miou"].mean()),
                  "adv_miou": float(scores["adv_miou"].mean()),
                  "rand_miou": float(scores["rand_miou"].mean()) if args.control else None}
        msg = (f"DATASET clean instance mIoU {result['clean_miou']:.4f} | adv instance mIoU "
               f"{result['adv_miou']:.4f} | mean L2 {l2_mean:.4f}")
        if args.control:
            msg += f" | rand-noise mIoU {result['rand_miou']:.4f}"
    else:
        labels_all = np.asarray(dataset.labels, np.int64)[:n]
        result = {k: float((scores[c] == labels_all).mean()) for k, c in (
            ("clean_acc", "clean_pred"), ("adv_acc", "adv_pred"), ("rand_acc", "rand_pred"))}
        msg = (f"DATASET clean acc {result['clean_acc']:.4f} | adv acc {result['adv_acc']:.4f} "
               f"| mean L2 {l2_mean:.4f}")
        if targeted:
            # shapes whose label is the target would "succeed" with no effort
            eligible = labels_all != args.target
            sr = (float((scores["adv_pred"][eligible] == args.target).mean())
                  if eligible.any() else 0.0)
            msg += f" | target success {sr:.4f} ({int(eligible.sum())} eligible)"
        if args.control:
            msg += f" | rand-noise acc {result['rand_acc']:.4f}"
        else:
            result["rand_acc"] = None
    log.info(msg)
    log.info("%d batches of %d, ms a batch: %s", len(batch_ms), B,
             " ".join(f"{t:.1f}" for t in batch_ms))
    log.info("per-shape TSV: %s", tsv_path)
    return {"tsv": tsv_path, **result, "l2_mean": l2_mean, "batch_ms": batch_ms}


if __name__ == "__main__":
    main()
