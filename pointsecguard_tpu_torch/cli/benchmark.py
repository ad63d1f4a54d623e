"""Attack benchmark CLI of the port (port of
``pointsecguard_tpu/cli/benchmark.py``; the ares benchmark CLIs
`ares/benchmark/{attack,distortion,iteration,prediction}_cli.py`):

  python -m pointsecguard_tpu_torch.cli.benchmark --mode attack \
      --attack_name pgd --goal ut --data_root data --log_dir log/pn2

Loads the port checkpoint of ``--log_dir`` (``best.pt``, else
``latest.pt``), batches the test set and runs one harness of
``attacks/benchmark.py``: ``attack`` (registry-driven batched evaluation,
ares' five result arrays), ``distortion`` (minimal-ε binary search, or
C&W's achieved distortion), ``iteration`` (accuracy curve along the
iteration budget), ``prediction`` (clean predictions to
``predictions.npz``) or ``worstcase`` (the union of several attacks).

``--task semseg`` for ``--model pointnet2|pointnet2_msg|pointnet|resgcn``
over the first Area-``--test_area`` room's blocks, and ``--model randla``
over spatially-regular S3DIS clouds of ``--randla_dir``; the colour threat
model. Each batch builds its plan once (PointNet++: the geometry; RandLA:
the pyramid; ResGCN rebuilds its graphs in every forward), however many
forwards the attack makes. ``--task cls`` for ``--model
pointnet2_cls|pointnet2_cls_msg|pointnet_cls`` over the ModelNet test
shapes of ``--data_root`` (``--num_category``, ``--no_normals``): the
coordinate threat model of ``cli.attack_object`` (xyz channels 0:3, no
clip, C&W's box (−1, 1)), one prediction per shape ([B, 1, K] outputs),
the geometry built again in every forward. The registry holds all eleven
names; deepfool, boundary and evolutionary (``--overshoot``,
``--init_tries``, ``--spherical_step``, ``--source_step``) need ``--task
cls``. ``--precision bfloat16`` runs the victim's Linear products in
bf16. It runs on the GPU; ``--device cpu`` runs the plain PyTorch path
by request. ``--devices N`` benchmarks data-parallel on N ranks
(``parallel/``; JAX's mesh over the batch): every rank draws the same
global batch (blocks, RandLA clouds or ModelNet shapes) and keeps its
rows, the harness gathers and pools what one process would return
(``attacks/benchmark.py``), and rank 0 alone logs and writes
``predictions.npz``. ``--batch_size`` must divide by ``--devices``.
"""

from __future__ import annotations

import argparse
import logging
import os

from pointsecguard_tpu_torch.cli.train import CLS_MODELS
from pointsecguard_tpu_torch.configs import add_parallel_arguments, add_precision_argument


def _check_batch_coverage(log, n: int, batch_size: int, unit: str) -> None:
    """The batch generators benchmark full batches only: fail when that
    means zero batches, and say so when a tail is dropped."""
    if n < batch_size:
        raise SystemExit(
            f"--batch_size {batch_size} exceeds the {n} available {unit} "
            f"— lower --batch_size (or raise --max_blocks)")
    if n % batch_size:
        log.warning(
            "benchmarking %d of %d %s (%d-%s tail is not a full batch "
            "of %d and is skipped)",
            n - n % batch_size, n, unit, n % batch_size, unit, batch_size)


def _parser() -> argparse.ArgumentParser:
    from pointsecguard_tpu_torch.configs import add_resgcn_arguments

    ap = argparse.ArgumentParser("benchmark")
    ap.add_argument("--mode", default="attack",
                    choices=["attack", "distortion", "iteration", "prediction", "worstcase"])
    ap.add_argument("--attack_names", default="pgd,cw",
                    help="worstcase mode: comma list of registry attacks; robust "
                         "accuracy against the per-point union of their successes")
    ap.add_argument("--attack_name", default="pgd",
                    choices=["fgsm", "bim", "pgd", "mim", "cw", "deepfool", "nes", "spsa",
                             "nattack", "boundary", "evolutionary"],
                    help="attack-mode registry name (`benchmark/utils.py:8-20`); "
                         "deepfool / boundary / evolutionary need --task cls")
    ap.add_argument("--samples", type=int, default=16,
                    help="nes/spsa: antithetic query pairs per iteration; "
                         "nattack: population size")
    ap.add_argument("--sigma", type=float, default=None,
                    help="nes search radius (default 0.01), nattack sampling std "
                         "(0.1); unset keeps each attack's default")
    ap.add_argument("--overshoot", type=float, default=0.02,
                    help="deepfool: boundary overshoot")
    ap.add_argument("--init_tries", type=int, default=20,
                    help="boundary/evolutionary: random-search draws for the start")
    ap.add_argument("--spherical_step", type=float, default=0.1,
                    help="boundary: initial orthogonal step (relative)")
    ap.add_argument("--source_step", type=float, default=0.1,
                    help="boundary: initial contraction step toward the original")
    ap.add_argument("--spsa_delta", type=float, default=0.01,
                    help="spsa: finite-difference radius")
    ap.add_argument("--momentum", type=float, default=0.0,
                    help="mim: gradient-momentum decay (0 = the Dong et al. default 1.0)")
    ap.add_argument("--goal", default="ut", choices=["ut", "tm", "t"])
    ap.add_argument("--distance", default="l_2", choices=["l_2", "l_inf"])
    ap.add_argument("--task", default="semseg", choices=["semseg", "cls"],
                    help="semseg: Area-5 blocks, colour threat model; cls: "
                         "ModelNet shapes, coordinate threat model")
    ap.add_argument("--model", default="pointnet2",
                    choices=["pointnet2", "pointnet2_msg", "pointnet", "resgcn", "randla",
                             "pointnet2_cls", "pointnet2_cls_msg", "pointnet_cls"])
    ap.add_argument("--data_root", default="data/stanford_indoor3d")
    ap.add_argument("--randla_dir", default="data/randla_input_0.040",
                    help="randla: prepared artifact tree")
    add_resgcn_arguments(ap)
    ap.add_argument("--log_dir", default="log/run")
    ap.add_argument("--test_area", type=int, default=5)
    ap.add_argument("--num_point", type=int, default=0,
                    help="points per sample (0 = 4096 blocks, randla the config's 40960, "
                         "cls 1024)")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--max_blocks", type=int, default=16,
                    help="blocks (randla: clouds, cls: shapes) to benchmark; 0 = all")
    ap.add_argument("--num_category", type=int, default=40,
                    help="cls: ModelNet10 or ModelNet40 lists")
    ap.add_argument("--no_normals", action="store_true", help="cls: xyz only")
    ap.add_argument("--origin", type=int, default=11)
    ap.add_argument("--target", type=int, default=7)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--alpha", type=float, default=None,
                    help="step size (default 0.05; nattack keeps its own 0.008 when unset)")
    ap.add_argument("--iters", type=int, default=None,
                    help="iteration budget (default 10; nattack keeps its own 100 when "
                         "unset)")
    ap.add_argument("--cw_steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) needs a card and raises without one; cpu runs "
                         "the plain PyTorch path")
    add_parallel_arguments(ap, shard_points=False)
    add_precision_argument(ap)
    ap.add_argument("--output", default="",
                    help="prediction mode: .npz output path (default "
                         "<log_dir>/predictions.npz)")
    return ap


def _refuse_unported(args) -> None:
    from pointsecguard_tpu_torch.configs import resgcn_refusals

    refused = resgcn_refusals(args)
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def _check_task(args) -> None:
    """The JAX CLI's checks: a model of the task, and the one-decision
    attacks on the classifiers, DeepFool untargeted, no 'tm' goal for a
    decision predicate."""
    from pointsecguard_tpu_torch.attacks.benchmark import DECISION_ATTACKS, UNTARGETED_ONLY

    is_cls = args.model in CLS_MODELS
    if is_cls != (args.task == "cls"):
        raise SystemExit(
            f"--model {args.model} is a {'classification' if is_cls else 'semseg'} model; "
            f"pass --task {'cls' if is_cls else 'semseg'} (got {args.task})")
    names = ([n.strip() for n in args.attack_names.split(",") if n.strip()]
             if args.mode == "worstcase" else
             [] if args.mode == "prediction" else [args.attack_name])
    one_decision = [n for n in names if n in UNTARGETED_ONLY | DECISION_ATTACKS]
    if one_decision and not is_cls:
        raise SystemExit(f"{', '.join(one_decision)} need one decision per shape: "
                         "--task cls with a classifier")
    for n in names:
        if args.goal != "ut" and n in UNTARGETED_ONLY:
            raise SystemExit(f"{n} is untargeted by construction; --goal {args.goal} "
                             "is not supported")
        if args.goal == "tm" and n in DECISION_ATTACKS:
            raise SystemExit(f"{n} queries a decision predicate; --goal tm (targeted "
                             "drive, untargeted scoring) is meaningless — use ut or t")


def _victim(args, device, log, ctx=None):
    """(make_outputs_fn, batches, num_classes, domain): the checkpoint's
    model as a per-batch closure factory (semseg: its plan built once a
    batch, xyz never moves; cls: the geometry in every forward, the
    coordinates move), a generator of (points, labels) device batches (on
    a rank of ``ctx``, its rows of each global batch), and the configs'
    perturbation domain (empty: the engines' colour defaults)."""
    import numpy as np
    import torch

    from pointsecguard_tpu_torch.cli._attack_blocks import load_block_model, member_factory
    from pointsecguard_tpu_torch.parallel import make_batch_put
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.runtime import model_dtype

    B = args.batch_size
    put = make_batch_put(ctx, batch_size=B, device=device)  # the rank's rows, on the device
    dtype = model_dtype(args.precision)
    if args.task == "cls":
        from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset
        from pointsecguard_tpu_torch.train.trainer import cls_model

        use_normals = not args.no_normals
        dataset = ModelNetDataset(args.data_root, "test", num_point=args.num_point or 1024,
                                  num_category=args.num_category, use_normals=use_normals)
        K = dataset.num_classes
        model, _ = cls_model(args.model, K, use_normals, dtype)
        model.load_state_dict(load_checkpoint(args.log_dir))
        model.to(device).eval().requires_grad_(False)
        n_shapes = min(len(dataset), args.max_blocks) if args.max_blocks else len(dataset)
        _check_batch_coverage(log, n_shapes, B, "shapes")

        def batches():
            for s in range(0, n_shapes - B + 1, B):
                pts = np.stack([dataset.load(i)[0] for i in range(s, s + B)])
                yield put(pts), put(dataset.labels[s:s + B].astype(np.int64)[:, None])

        # [B, K] log-probabilities as [B, 1, K] one-point clouds
        make = lambda pts: (lambda p: model(p)[0][:, None, :])
        domain = {"channels": (0, 3), "clip": None, "box": (-1.0, 1.0), "num_classes": K,
                  "success_acc": 1.0 / K}
        return make, batches, K, domain
    if args.model == "randla":
        # whole sampled clouds, where the vendored ares lived
        from pointsecguard_tpu_torch.data.randla import randla_dataset_preset
        from pointsecguard_tpu_torch.models import RandLANet
        from pointsecguard_tpu_torch.train.trainer import randla_family

        preset = randla_dataset_preset("s3dis")
        rcfg = preset.cfg
        npoint = args.num_point or rcfg.num_points
        sampler = preset.make_sampler(args.randla_dir, "test", npoint,
                                      np.random.default_rng(args.seed),
                                      test_area=args.test_area)
        model = RandLANet(num_classes=13, d_out=rcfg.d_out, dtype=dtype)
        model.load_state_dict(load_checkpoint(args.log_dir))
        model.to(device).eval().requires_grad_(False)
        family = randla_family(rcfg)
        if not args.max_blocks:
            raise SystemExit(
                "--model randla needs an explicit --max_blocks cloud "
                "count (the possibility sampler has no finite 'all')")
        # the sampler yields full batches only: round up, and say so
        n_clouds = -(-args.max_blocks // B) * B
        if n_clouds != args.max_blocks:
            log.info("benchmarking %d clouds (--max_blocks %d rounded up to "
                     "full %d-cloud batches)", n_clouds, args.max_blocks, B)

        def batches():
            for _, feats, labels, _, _ in sampler.batches(B, n_clouds // B):
                yield put(feats), put(labels.astype(np.int64))
    else:
        from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks

        model, family = load_block_model(args.model, args.log_dir, args, device)
        rooms = RoomSet.load(args.data_root, "test", args.test_area)
        scene = WholeSceneBlocks(rooms, block_points=args.num_point or 4096)
        feats, labs, _w, _i = scene.room_blocks(0, np.random.default_rng(args.seed))
        if args.max_blocks:
            feats, labs = feats[: args.max_blocks], labs[: args.max_blocks]
        _check_batch_coverage(log, len(feats), B, "blocks")

        def batches():
            for s in range(0, len(feats) - B + 1, B):
                yield put(feats[s:s + B]), put(labs[s:s + B].astype(np.int64))

    return member_factory(model, family), batches, 13, {}


def main(argv=None):
    """Parse, check, and benchmark on one device or on the ranks of
    ``--devices`` (``parallel.run_cli``); returns rank 0's result."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    _check_task(args)
    from pointsecguard_tpu_torch.parallel import run_cli

    return run_cli(_benchmark, args, device=args.device)


def _benchmark(args, ctx=None):
    import numpy as np
    import torch

    from pointsecguard_tpu_torch.attacks.benchmark import (
        DECISION_ATTACKS,
        AttackBenchmark,
        distortion_binsearch,
        iteration_curve,
        load_attack,
        worst_case_run,
    )
    from pointsecguard_tpu_torch.attacks.common import make_target_labels
    from pointsecguard_tpu_torch.parallel import gather_rows, is_main
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    logging.basicConfig(level=logging.INFO if is_main(ctx) else logging.WARNING,
                        format="%(message)s", force=True)
    log = logging.getLogger("benchmark")
    device = ctx.device if ctx is not None else resolve_device(args.device)
    B = args.batch_size
    make_outputs_fn, batches, num_classes, domain = _victim(args, device, log, ctx)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    if args.mode == "prediction":
        # ares prediction_cli (`benchmark/prediction_cli.py:1-62`): clean
        # predictions, {ys, ys_target, predictions}, the ares log format
        ys, preds = [], []
        for i_batch, (pts, labels) in enumerate(batches()):
            with torch.no_grad():
                pred = torch.argmax(make_outputs_fn(pts)(pts), dim=-1)
            pred = gather_rows(pred, ctx).cpu().numpy().astype(np.int32)
            lab = gather_rows(labels, ctx).cpu().numpy().astype(np.int32)
            ys.append(lab)
            preds.append(pred)
            log.info("n=%d..%d acc=%3f", i_batch * B, i_batch * B + B - 1,
                     (pred == lab).mean())
        ys = np.concatenate(ys)
        preds = np.concatenate(preds)
        # the fixed target-label vector of the targeted drives (`target.py:29`)
        ys_target = np.full_like(ys, args.target)
        out_path = args.output or os.path.join(args.log_dir, "predictions.npz")
        if is_main(ctx):
            np.savez(out_path, ys=ys, ys_target=ys_target, predictions=preds)
        log.info("acc=%3f", (preds == ys).mean())
        log.info("saved %s", out_path)
        return ys, ys_target, preds

    # flags that fall back to each attack's own config default when unset
    own_defaults = args.attack_name in ("deepfool", "nattack", "boundary", "evolutionary")
    extra = {} if args.sigma is None else {"sigma": args.sigma}
    if args.alpha is not None:
        extra["alpha"] = args.alpha
    elif args.attack_name != "nattack":
        extra["alpha"] = 0.05
    if args.iters is not None:
        extra["iters"] = args.iters
    elif not own_defaults:
        extra["iters"] = 10
    if args.attack_name == "mim":
        # --momentum is a mim knob: forwarded to pgd it would turn it into MIM
        extra["momentum"] = args.momentum
    if args.mode in ("attack", "worstcase"):
        kwargs = dict(eps=args.eps, steps=args.cw_steps, samples=args.samples,
                      delta=args.spsa_delta, overshoot=args.overshoot,
                      init_tries=args.init_tries, spherical_step=args.spherical_step,
                      source_step=args.source_step, **extra, **domain)
        if args.goal == "t":
            kwargs.update(origin=args.origin, target=args.target, ce_reduction="mean")
        elif args.goal == "tm":
            # targeted drive, untargeted scoring (`bim.py:80-82,144`)
            kwargs.update(target=args.target, ce_reduction="mean")
        if args.mode == "worstcase":
            names = [n.strip() for n in args.attack_names.split(",") if n.strip()]
            kwargs.pop("origin", None)
            kwargs.pop("target", None)
            return worst_case_run(
                names, make_outputs_fn, batches(), goal=args.goal,
                distance_metric=args.distance, origin=args.origin, target=args.target,
                generator=generator, logger=log, ctx=ctx, **kwargs)
        bench = AttackBenchmark(args.attack_name, make_outputs_fn, goal=args.goal,
                                distance_metric=args.distance, ctx=ctx, **kwargs)
        acc, acc_adv, total, succ, dist = bench.run(batches(), logger=log,
                                                    generator=generator)
        log.info("TOTAL acc=%.4f adv_acc=%.4f succ=%.4f dist_mean=%.4f (%d pts)",
                 acc.mean(), acc_adv.mean(), succ.sum() / max(total.sum(), 1),
                 dist.mean(), len(acc))
        return acc, acc_adv, total, succ, dist

    pts, ys = next(batches())
    if args.attack_name == "cw" and args.mode == "iteration":
        # C&W counts optimiser steps against an L2 objective, not iterations
        raise SystemExit(
            "--mode iteration needs an iteration-bounded attack; cw "
            "counts optimizer steps (use --mode attack or distortion)")
    # the sweeps take attack mode's goals; the true labels ride as labels,
    # every engine builds the targeted objective from cfg.target
    mask = None
    if args.goal != "ut":
        extra.update(targeted=True, target=args.target, ce_reduction="mean")
        if args.goal == "t" and args.attack_name not in DECISION_ATTACKS:
            _, mask = make_target_labels(ys, args.origin, args.target)
    cfg = load_attack(args.attack_name, dict(
        eps=args.eps, samples=args.samples, delta=args.spsa_delta, overshoot=args.overshoot,
        init_tries=args.init_tries, spherical_step=args.spherical_step,
        source_step=args.source_step, **extra, **domain))
    if args.mode == "distortion":
        eps, details = distortion_binsearch(
            make_outputs_fn, pts, ys, cfg, success_acc=1.0 / num_classes, mask=mask,
            success_criterion="acc" if args.goal == "tm" else "auto", generator=generator,
            ctx=ctx)
        if details.get("optimized"):
            # minimisation attack: the achieved per-sample distortion
            for d, s in zip(details["dist"], details["success"]):
                log.info("dist=%.5f success=%s", d, s)
            log.info("MEAN SUCCESSFUL DISTORTION %.5f", eps)
        else:
            for probe in details["probes"]:
                log.info("eps=%.5f acc=%.4f sr=%.4f success=%s", probe["eps"],
                         probe["acc"], probe["sr"], probe["success"])
            log.info("MINIMAL EPSILON %.5f", eps)
        return eps, details

    probes = iteration_curve(make_outputs_fn, pts, ys, cfg, mask=mask, generator=generator,
                             ctx=ctx)
    for p in probes:
        log.info("iters=%d acc=%.4f sr=%.4f l2=%.4f", p["iters"], p["acc"], p["sr"], p["l2"])
    return probes


if __name__ == "__main__":
    main()
