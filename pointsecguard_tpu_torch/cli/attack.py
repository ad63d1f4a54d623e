"""Attack evaluation CLI of the port (port of
``pointsecguard_tpu/cli/attack.py:27-230``):

  python -m pointsecguard_tpu_torch.cli.attack --model pointnet2 --attack nb \
      --data_root data/stanford_indoor3d --log_dir log/pointnet2

Ported: ``--attack nb|tar_nb`` (PGD) and ``nu|tar_nu`` (C&W) for
``--model pointnet2``, ``pointnet2_msg``, ``pointnet`` and ``resgcn``
(with the ``--resgcn_*`` model flags; targeted runs at ``--batch_size 1``,
the per-cloud gates of `sem_seg_dense/attacks.py:204-207`) over
whole-scene blocks (``cli/_attack_blocks.py``) and for ``--model randla``
over spatially-regular clouds (``cli/_attack_randla.py``) of the tree
``cli.prepare`` wrote under ``--randla_dir``, S3DIS or, with
``--randla_dataset semantic3d``, Semantic3D (its ignored label 0 masked
out; ``semantickitti`` is refused: its clouds are xyz-only); ``--fused_ap``
(``--model randla`` only) runs the narrow attentive poolings through the
fused kernels; ``--save_adv`` writes the adversarial blocks or clouds for
``cli.eval --adv_set``. The reference's protocol flags, for every model:
``--attack random`` with ``--noise_norm`` (noise of a fixed norm, no
attack engine), ``--control`` (the equal-norm random control at the
attack's measured L2, a ``rand_acc`` column), ``--log_steps`` (per-step
trajectories to ``*_steps.tsv``, no early exit), ``--visual``
(``.xyzrgb`` dumps and HTML viewers under ``<log_dir>/visual``),
``--defense bit_depth|jitter|jpeg|resample`` with ``--defense_*`` and
``--eot`` (every reported prediction under the deployed defense; the
attacker differentiates the EoT mean), and ``--resgcn_fixed_graphs``
(ResGCN's attacker on graphs frozen at the clean input; the metrics
evaluate the dynamic model), ``--resgcn_fast`` (ResGCN's subsample
dilation, ``models/resgcn.py``: 28 kNN-kernel graphs a forward), and ``--ensemble MODEL:LOG_DIR[:WEIGHT]``
(repeatable; block models only) with ``--ensemble_mode probs|log_probs``
(a weighted ensemble victim: every metric evaluates the softmax mixture,
the attack differentiates the mode's objective). The checkpoint is the port's own
(``<log_dir>/checkpoints/``: ``best.pt``, else ``latest.pt``, see
``utils/checkpoint.py``). ``--precision bfloat16`` runs every model's
Linear products in bf16, ensemble members included; the fused attentive
kernel is float32 only, so ``--fused_ap`` with it stops the run (the JAX
model quietly takes the reference pooling there). It runs on the GPU;
``--device cpu`` runs the plain PyTorch path by request. ``--devices N``
attacks data-parallel on N ranks, each attacking its rows of every batch,
the per-cloud results gathered and written by rank 0; the attack loop
holds a collective only under ``--log_steps`` (the trajectory's per-step
counts, summed over the ranks once after the loop) and with an early
exit under ``--devices`` (the ranks agree on it every step);
``--shard_points P`` splits RandLA's pyramid kNN over P of them
(``parallel/``). ``--fused_ap`` with ``--shard_points`` stops the run with
"not ported yet" (the JAX driver quietly takes the reference pooling
there).
"""

from __future__ import annotations

import argparse
import logging

from pointsecguard_tpu_torch.configs import (
    add_parallel_arguments,
    add_precision_argument,
    add_resgcn_arguments,
    resgcn_refusals,
)

_MODELS = ["pointnet2", "pointnet2_msg", "pointnet", "resgcn", "randla"]
_ATTACKS = ["nb", "nu", "tar_nb", "tar_nu", "random"]
PORTED_MODELS = ("pointnet2", "pointnet2_msg", "pointnet", "randla", "resgcn")
PORTED_ATTACKS = ("nb", "nu", "tar_nb", "tar_nu", "random")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("attack")
    ap.add_argument("--model", default="pointnet2", choices=_MODELS)
    ap.add_argument("--randla_dir", default="data/randla_input_0.040")
    ap.add_argument("--randla_dataset", default="s3dis",
                    choices=["s3dis", "semantickitti", "semantic3d"],
                    help="randla: dataset preset (`helper_tool.py:18-100`) "
                         "over the cli.prepare artifact tree; semantic3d "
                         "attacks mask out the ignored label 0, kitti is "
                         "rejected (xyz-only, no color threat surface)")
    ap.add_argument("--num_clouds", type=int, default=100,
                    help="randla: number of sampled clouds (`tester_S3DIS.py:166`)")
    ap.add_argument("--randla_points", type=int, default=0,
                    help="randla: points per cloud (0 = the config's 40960)")
    ap.add_argument("--attack", default="nb", choices=_ATTACKS)
    ap.add_argument("--data_root", default="data/stanford_indoor3d")
    ap.add_argument("--log_dir", default="log/run")
    ap.add_argument("--test_area", type=int, default=5)
    ap.add_argument("--num_point", type=int, default=4096)
    ap.add_argument("--batch_size", type=int, default=0,
                    help="0 = auto: 8 untargeted, 1 targeted (per-block "
                         "outcomes do not depend on the batch size; resgcn "
                         "targeted runs take 1 only); randla takes its "
                         "config's val_batch_size 1")
    # targeted defaults origin=11 (board) → target=7 (table)
    # (`NB_target_test_semseg.py:48-49`)
    ap.add_argument("--origin", type=int, default=11)
    ap.add_argument("--target", type=int, default=7)
    ap.add_argument("--max_blocks", type=int, default=0, help="0 = all")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) needs a card and raises without "
                         "one; cpu runs the plain PyTorch path")
    ap.add_argument("--save_adv", action="store_true",
                    help="write the adversarial blocks (clouds) and their "
                         "labels to <log_dir>/<model>_<attack>_adv_area<k>.npz "
                         "(re-evaluate with cli.eval --adv_set)")
    ap.add_argument("--fused_ap", action="store_true",
                    help="randla: fused attentive-pooling kernels for the "
                         "poolings narrower than 128 channels")
    ap.add_argument("--defense", default="none",
                    choices=["none", "bit_depth", "jitter", "jpeg", "resample"],
                    help="input-transformation defense on the model (the "
                         "attack sees the defended model, BPDA-style)")
    ap.add_argument("--defense_bits", type=int, default=4)
    ap.add_argument("--defense_sigma", type=float, default=0.02)
    ap.add_argument("--defense_quality", type=int, default=95,
                    help="jpeg defense quality (libjpeg curve)")
    ap.add_argument("--defense_knn", type=int, default=8,
                    help="resample defense: neighbours per point the random "
                         "colour pick draws from")
    ap.add_argument("--eot", type=int, default=1,
                    help="expectation over transformation for a randomized "
                         "(jitter / resample) defense: the attack "
                         "differentiates the mean of K fixed defended draws; "
                         "every reported metric evaluates the deployed draw")
    ap.add_argument("--control", action="store_true",
                    help="also evaluate the equal-norm random-noise control "
                         "at the attack's measured L2 per block "
                         "(`NUattack.py:236-254` protocol)")
    ap.add_argument("--noise_norm", type=float, default=1.0,
                    help="L2 norm for --attack random "
                         "(`sem_seg_dense/test.py:68` data_result = 1.0)")
    ap.add_argument("--log_steps", action="store_true",
                    help="write per-iteration acc / sr / L2 to *_steps.tsv "
                         "(ares `bim.py:216-237`); turns the early exit off")
    ap.add_argument("--visual", action="store_true",
                    help="dump clean / adv / pred / gt .xyzrgb clouds and HTML "
                         "viewers per room (cloud) to <log_dir>/visual")
    ap.add_argument("--resgcn_fixed_graphs", action="store_true",
                    help="resgcn: the attacker differentiates a surrogate whose "
                         "graphs are frozen at the clean input; every metric "
                         "evaluates the dynamic model")
    add_parallel_arguments(ap)
    add_precision_argument(ap)
    ap.add_argument("--ensemble", action="append", default=[],
                    metavar="MODEL:LOG_DIR[:WEIGHT]",
                    help="add this block model (pointnet2 / pointnet2_msg / pointnet / "
                         "resgcn) with its checkpoint dir to the victim, repeatable; the "
                         "primary model's weight is 1, weights are normalised; every "
                         "metric evaluates the weighted softmax mixture "
                         "(ares `model/ensemble.py:9-25`)")
    ap.add_argument("--ensemble_mode", default="probs", choices=["probs", "log_probs"],
                    help="the attacked ensemble objective: 'probs' = CE of the softmax "
                         "mixture; 'log_probs' = the weighted per-model CE direction of "
                         "ares `loss/cross_entropy.py:22-38` plus the mixture normaliser")
    add_resgcn_arguments(ap, fast_help="resgcn: dilated_mode=subsample + approx kNN "
                                       "(documented deviation, PARITY.md)")
    return ap


def _refuse_unported(args) -> None:
    refused = [f"--model {args.model}"] if args.model not in PORTED_MODELS else []
    if args.attack not in PORTED_ATTACKS:
        refused.append(f"--attack {args.attack}")
    if args.fused_ap and args.shard_points > 1:
        refused.append(f"--fused_ap with --shard_points {args.shard_points} (the fused "
                       "attentive kernel runs on whole clouds only; the JAX driver takes "
                       "the reference pooling there)")
    if args.fused_ap and args.model != "randla":
        refused.append(f"--fused_ap with --model {args.model} (RandLA-Net's "
                       "attentive pooling: --model randla only)")
    if args.fused_ap and args.precision != "float32":
        refused.append(f"--fused_ap with --precision {args.precision} (the fused "
                       "attentive kernel is float32 only)")
    if args.resgcn_fixed_graphs and args.model != "resgcn":
        refused.append(f"--resgcn_fixed_graphs with --model {args.model}")
    refused += resgcn_refusals(args)
    if refused:
        raise SystemExit("not ported yet: " + ", ".join(refused))


def main(argv=None):
    """Parse, refuse, and attack on one device or on the ranks of
    ``--devices`` (``parallel.run_cli``); returns rank 0's metrics."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.model == "randla" and args.ensemble:
        raise SystemExit("--ensemble is a block-family feature "
                         "(members share the [B,N,9] block input; "
                         "RandLA clouds have a different contract)")
    from pointsecguard_tpu_torch.parallel import run_cli

    return run_cli(_attack, args, device=args.device)


def _attack(args, ctx=None):
    from pointsecguard_tpu_torch.parallel import is_main

    logging.basicConfig(level=logging.INFO if is_main(ctx) else logging.WARNING,
                        format="%(message)s", force=True)
    log = logging.getLogger("attack")
    if args.model == "randla":
        from pointsecguard_tpu_torch.cli._attack_randla import run_randla

        return run_randla(args, log, ctx)
    # unlike the JAX CLI, resgcn's auto value is not capped at 1: that cap
    # works around a TPU compiler failure at batch 8
    if args.batch_size == 0:
        args.batch_size = 1 if args.attack.startswith("tar_") else 8
    # ResGCN's targeted gates work per cloud (`sem_seg_dense/attacks.py:
    # 204-207`): the reference's batch size, before any checkpoint work
    if args.model == "resgcn" and args.attack.startswith("tar_") and args.batch_size != 1:
        raise SystemExit("resgcn targeted attacks use --batch_size 1 "
                         "(per-cloud skip gates, `attacks.py:204-207`)")
    from pointsecguard_tpu_torch.cli._attack_blocks import run_blocks

    return run_blocks(args, log, ctx)


if __name__ == "__main__":
    main()
