"""Attacks on the ModelNet classifiers in the coordinate domain (port of
``pointsecguard_tpu/cli/attack_object.py:40-393``, its classification half):

  python -m pointsecguard_tpu_torch.cli.attack_object --model pointnet2_cls \
      --data_root data/modelnet40_normal_resampled --log_dir log/cls --attack nb

The PGD and C&W engines of ``cli.attack`` with the perturbation domain
moved from the colours to the coordinates: channels (0, 3), no clip (the
shapes are normalised into the unit sphere, so C&W's tanh box is (−1, 1));
the normals, when given, do not move. The classifier's [B, K]
log-probabilities are wrapped as [B, 1, K] one-point clouds, so the
per-point engines score one prediction per shape.

By default the geometry (FPS and ball query on the FPS and bottom-k
kernels) is built again in every forward of the attack: the points move,
and the neighbourhoods with them, and the centres carry their gradient
(``models.pointnet2_cls.moving_geometry``). ``--fixed_geometry`` freezes it
at the clean shape instead (faster; the neighbourhoods then stop following
the points). ``--defense sor|srs`` deploys statistical outlier removal
(kNN kernel, k + 1 neighbours) or random subsampling; every reported
prediction (clean, adversarial, control) is the deployed defense's, and
the attacker differentiates through it (with ``--eot K``, the mean over K
fixed SRS draws). ``--control`` adds the equal-norm random control.

Per shape one TSV row ``idx, label, clean_pred, adv_pred, l2[, rand_pred]``
in ``<log_dir>/<model>_<attack>_object.tsv``, and the JAX driver's summary
line. It runs on the GPU; ``--device cpu`` runs the plain PyTorch path by
request. Accepted by name and stopped with "not ported yet": the
part-segmentation models (``--model *_part_seg*``, and ``--origin`` with
them), ``--devices`` other than 1 and ``--precision bfloat16``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

from pointsecguard_tpu_torch.cli.train import CLS_MODELS

PART_SEG_MODELS = ("pointnet_part_seg", "pointnet2_part_seg", "pointnet2_part_seg_msg")
_UNPORTED_DEFAULTS = {"devices": 1, "precision": "float32", "origin": -1}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("attack_object")
    ap.add_argument("--model", default="pointnet2_cls", choices=[*CLS_MODELS, *PART_SEG_MODELS])
    ap.add_argument("--attack", default="nb", choices=["nb", "nu", "tar_nb", "tar_nu", "random"])
    ap.add_argument("--data_root", default="data/modelnet40_normal_resampled")
    ap.add_argument("--log_dir", default="log/run")
    ap.add_argument("--num_point", type=int, default=0, help="0 = 1024 a shape")
    ap.add_argument("--batch_size", type=int, default=0, help="0 = 16")
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
    ap.add_argument("--target", type=int, default=0, help="the target class")
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
    ap.add_argument("--devices", "-d", type=int, default=1)
    ap.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--origin", type=int, default=-1, help="part-seg only")
    return ap


def _refuse_unported(args) -> None:
    refused = [f"--model {args.model} (part segmentation)"] if args.model in PART_SEG_MODELS \
        else []
    refused += [f"--{name} {getattr(args, name)}"
                for name, default in _UNPORTED_DEFAULTS.items()
                if getattr(args, name) != default]
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
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    logging.basicConfig(level=logging.INFO, format="%(message)s", force=True)
    log = logging.getLogger("attack_object")

    import numpy as np
    import torch

    from pointsecguard_tpu_torch.attacks import (
        PGDConfig,
        cw_color_attack,
        equal_norm_color_noise,
        pgd_color_attack,
    )
    from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset
    from pointsecguard_tpu_torch.train.object_eval import _padded_batches
    from pointsecguard_tpu_torch.train.trainer import cls_model
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    use_normals = not args.no_normals
    B = args.batch_size or 16
    dataset = ModelNetDataset(args.data_root, "test", num_point=args.num_point or 1024,
                              num_category=args.num_category, use_normals=use_normals)
    num_classes = dataset.num_classes
    model, _ = cls_model(args.model, num_classes, use_normals)
    model.load_state_dict(load_checkpoint(args.log_dir))
    model.to(device).eval().requires_grad_(False)
    build = getattr(model, "build_geometry", None)
    if args.fixed_geometry and build is None:
        log.info("%s has no point-group geometry; --fixed_geometry is a no-op", args.model)

    def make_outputs_fn(pts):
        """[B, 1, K] log-probabilities; the geometry fixed at ``pts`` with
        --fixed_geometry, else built in every forward."""
        if args.model == "pointnet_cls":
            return lambda p: model(p)[0][:, None, :]
        geo = build(pts[..., :3]) if args.fixed_geometry else None
        return lambda p: model(p, geometry=geo)[0][:, None, :]

    eval_wrap, attack_wrap = defense_wrapper(args) or (lambda f: f, lambda f: f)
    cfg = attack_config(args, num_classes)
    if args.attack == "random" and args.control:
        # the attack is the equal-norm noise itself
        log.info("--control is a no-op with --attack random; ignoring")
        args.control = False
    xyz = {"channels": (0, 3), "clip": None, "centered": True}
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def predict(f, p):
        with torch.no_grad():
            return torch.argmax(f(p), dim=-1)[:, 0]

    def run(pts, labels):
        """(clean, adversarial, control predictions, per-shape L2): every
        prediction under the deployed defense, the attack through
        ``attack_wrap``."""
        f = make_outputs_fn(pts)  # --fixed_geometry: built once a batch
        f_eval, f_att = eval_wrap(f), attack_wrap(f)
        clean = predict(f_eval, pts)
        if cfg is None:
            l2 = torch.full((len(pts),), args.noise_norm, device=device)
            adv = equal_norm_color_noise(pts, l2, generator=gen, **xyz)
        elif isinstance(cfg, PGDConfig):
            res = pgd_color_attack(f_att, pts, labels[:, None], cfg)
            adv, l2 = res.points_adv, res.l2_dist
        else:
            res = cw_color_attack(f_att, pts, labels[:, None], cfg)
            adv, l2 = res.points_adv, res.l2_dist
        rand = clean
        if args.control:
            rand = predict(f_eval, equal_norm_color_noise(pts, l2, generator=gen, **xyz))
        return clean, predict(f_eval, adv), rand, l2

    os.makedirs(args.log_dir, exist_ok=True)
    tsv_path = os.path.join(args.log_dir, f"{args.model}_{args.attack}_object.tsv")
    n = min(len(dataset), args.max_shapes) if args.max_shapes else len(dataset)
    labels_all = np.asarray(dataset.labels, np.int64)[:n]
    clean, advp, randp = (np.zeros(n, np.int64) for _ in range(3))
    l2s = np.zeros(n, np.float64)
    batch_ms = []
    with open(tsv_path, "w") as tsv:
        tsv.write("idx\tlabel\tclean_pred\tadv_pred\tl2"
                  + ("\trand_pred" if args.control else "") + "\n")
        for idx, n_valid in _padded_batches(n, B):
            pts = torch.from_numpy(np.stack([dataset.load(int(i))[0] for i in idx])).to(device)
            labs = labels_all[idx]
            t0 = time.perf_counter()
            out = run(pts, torch.from_numpy(labs).to(device))
            # one read of the batch's results
            cp, ap, rp, l2 = (t.cpu().numpy() for t in out)
            batch_ms.append(1e3 * (time.perf_counter() - t0))
            take = idx[:n_valid]
            clean[take], advp[take], randp[take], l2s[take] = (
                cp[:n_valid], ap[:n_valid], rp[:n_valid], l2[:n_valid])
            for j in range(n_valid):
                row = f"{take[j]}\t{labs[j]}\t{cp[j]}\t{ap[j]}\t{l2[j]:.6f}"
                tsv.write(row + (f"\t{rp[j]}" if args.control else "") + "\n")
    clean_acc = float((clean == labels_all).mean())
    adv_acc = float((advp == labels_all).mean())
    msg = (f"DATASET clean acc {clean_acc:.4f} | adv acc {adv_acc:.4f} "
           f"| mean L2 {l2s.mean():.4f}")
    if args.attack.startswith("tar_"):
        # shapes whose label is the target would "succeed" with no effort
        eligible = labels_all != args.target
        sr = float((advp[eligible] == args.target).mean()) if eligible.any() else 0.0
        msg += f" | target success {sr:.4f} ({int(eligible.sum())} eligible)"
    rand_acc = float((randp == labels_all).mean())
    if args.control:
        msg += f" | rand-noise acc {rand_acc:.4f}"
    log.info(msg)
    log.info("%d batches of %d, ms a batch: %s", len(batch_ms), B,
             " ".join(f"{t:.1f}" for t in batch_ms))
    log.info("per-shape TSV: %s", tsv_path)
    return {"tsv": tsv_path, "clean_acc": clean_acc, "adv_acc": adv_acc,
            "rand_acc": rand_acc if args.control else None, "l2_mean": float(l2s.mean()),
            "batch_ms": batch_ms}


if __name__ == "__main__":
    main()
