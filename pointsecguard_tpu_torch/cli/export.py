"""Export a trained model as a serving artifact (port of
``pointsecguard_tpu/cli/export.py``):

  python -m pointsecguard_tpu_torch.cli.export --model pointnet2 \\
      --log_dir log/pointnet2 --output artifacts/pointnet2 [--check]

The artifact (``utils/export.py``) holds the evaluation forward traced by
``torch.export`` (``forward.pt2``), the weights as the JAX artifact's
``params.npz`` and ``meta.json``; a serving process loads it with
``utils.export.load_artifact(path, device)`` and needs no model code. The
forward is the JAX CLI's: log-probabilities for the PointNet family, the
classifiers and the part-seg nets (whose program takes the points and the
16-way category one-hot), logits for RandLA-Net (its ``build_pyramid``
inside the program) and ResGCN (its graphs built inside, as always).

All eleven models and every flag of the JAX CLI: ``--batch_size`` and the
points (``--num_point``, ``--randla_points``) baked into the program, the
ResGCN OptInit flags, ``--num_category``, ``--no_normals`` and
``--precision``. ``--platforms`` takes ``cuda`` and ``cpu`` (default both,
as JAX's default is ``tpu,cpu``): the program is traced once on the
export's device and runs on either through ``move_to_device_pass``. The
checkpoint is the port's own (``<log_dir>/checkpoints/``: the best one,
else the latest). ``--check`` reloads the artifact and holds its output on
seeded probes to the live model's at ``atol=1e-5``, on the export's
device. It runs on the GPU; ``--device cpu`` runs the plain PyTorch path
by request.
"""

from __future__ import annotations

import argparse
import logging
import os

from pointsecguard_tpu_torch.configs import add_precision_argument, add_resgcn_arguments
from pointsecguard_tpu_torch.utils.export import (
    PLATFORMS,
    export_forward,
    load_artifact,
    save_artifact,
)

MODELS = ["pointnet2", "pointnet2_msg", "pointnet", "randla", "resgcn",
          "pointnet_cls", "pointnet2_cls", "pointnet2_cls_msg", "pointnet_part_seg",
          "pointnet2_part_seg", "pointnet2_part_seg_msg"]
CHECK_ATOL = 1e-5  # JAX's round-trip tolerance (cli/export.py)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("export")
    ap.add_argument("--model", default="pointnet2", choices=MODELS)
    ap.add_argument("--log_dir", default="log/run")
    ap.add_argument("--output", required=True, help="artifact directory to write")
    ap.add_argument("--num_point", type=int, default=0,
                    help="0 = task default (4096 semseg, 1024 cls, 2048 part-seg)")
    ap.add_argument("--randla_points", type=int, default=0)
    ap.add_argument("--batch_size", type=int, default=1,
                    help="batch dimension baked into the exported program")
    ap.add_argument("--num_category", type=int, default=40,
                    help="cls: number of object classes")
    ap.add_argument("--no_normals", action="store_true",
                    help="cls/part-seg: xyz-only inputs")
    ap.add_argument("--platforms", default="cuda,cpu",
                    help="comma-separated devices the artifact runs on (cuda, cpu)")
    ap.add_argument("--check", action="store_true",
                    help="round-trip the artifact and verify outputs match the "
                         "live model on random input")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) needs a card and raises without one; cpu "
                         "runs the plain PyTorch path")
    add_precision_argument(ap)
    add_resgcn_arguments(ap)
    return ap


def parse_platforms(text: str) -> list[str]:
    """``--platforms`` → its devices; SystemExit on any other name."""
    platforms = [p.strip() for p in text.split(",") if p.strip()]
    if "tpu" in platforms:
        raise SystemExit("--platforms tpu: the port's artifacts run on cuda and cpu "
                         "(a TPU artifact is the JAX package's cli.export)")
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise SystemExit(f"--platforms {text!r}: want cuda and/or cpu")
    return platforms


def served_model(args, dtype):
    """(model, example inputs of zeros, call(model, *inputs)) of
    ``--model``: the JAX CLI's evaluation forward."""
    import torch

    B = args.batch_size
    if args.model == "randla":
        from pointsecguard_tpu_torch.configs import RandlaConfig
        from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

        cfg = RandlaConfig()
        model = RandLANet(d_out=cfg.d_out, dtype=dtype)
        example = (torch.zeros(B, args.randla_points or cfg.num_points, 6),)

        def call(m, feats):
            # the pyramid is built in the program: the artifact is self-contained
            return m(feats, build_pyramid(feats[..., :3], num_layers=cfg.num_layers,
                                          k=cfg.k_n, sub_ratios=cfg.sub_sampling_ratio))

        return model, example, call
    if args.model == "resgcn":
        from pointsecguard_tpu_torch.configs import resgcn_overrides
        from pointsecguard_tpu_torch.models import DenseDeepGCN

        model = DenseDeepGCN(dtype=dtype, **resgcn_overrides(args))
        return model, (torch.zeros(B, args.num_point or 4096, 9),), lambda m, p: m(p)
    if args.model in ("pointnet2", "pointnet2_msg", "pointnet"):
        from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS

        model = POINTNET_MODELS[args.model][0](dtype=dtype)
        return model, (torch.zeros(B, args.num_point or 4096, 9),), lambda m, p: m(p)[0]
    from pointsecguard_tpu_torch.data.shapenet_part import NUM_PART_CLASSES
    from pointsecguard_tpu_torch.train.trainer import cls_model

    part = "part_seg" in args.model
    model, _ = cls_model(args.model, NUM_PART_CLASSES if part else args.num_category,
                         not args.no_normals, dtype)
    pts = torch.zeros(B, args.num_point or (2048 if part else 1024),
                      3 if args.no_normals else 6)
    if part:
        # two-input program: points + 16-way object-class one-hot
        return model, (pts, torch.zeros(B, 16)), lambda m, p, label: m(p, label)[0]
    return model, (pts,), lambda m, p: m(p)[0]


def probes(example: tuple, seed: int = 0) -> list:
    """The JAX CLI's check inputs: uniform [0, 1) draws of the example's
    shapes from a numpy seed; a part-seg one-hot of random categories."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = [rng.random(tuple(e.shape), dtype=np.float32) for e in example]
    if len(out) > 1:
        k = out[1].shape[-1]
        out[1] = np.eye(k, dtype=np.float32)[rng.integers(0, k, size=out[1].shape[0])]
    return [torch.from_numpy(p) for p in out]


def _restore(log_dir: str) -> tuple[dict, str, int | None]:
    """(state dict, file, step) of the best checkpoint, else the latest;
    ``best.pt`` keeps no epoch, ``latest.pt`` its own."""
    from pointsecguard_tpu_torch.utils import checkpoint

    d = checkpoint.checkpoint_dir(log_dir)
    manager = checkpoint.CheckpointManager(d) if os.path.isdir(d) else None
    best = manager and manager.restore_best()
    if best is not None:
        return best, checkpoint.BEST, None
    latest = manager and manager.restore_latest()
    if latest is None:
        raise SystemExit(f"no checkpoint under {d}")
    return latest["model"], checkpoint.LATEST, int(latest["epoch"])


def main(argv=None) -> str:
    args = _parser().parse_args(argv)
    platforms = parse_platforms(args.platforms)
    import torch

    from pointsecguard_tpu_torch.utils.runtime import model_dtype, resolve_device

    logging.basicConfig(level=logging.INFO, format="%(message)s", force=True)
    log = logging.getLogger("export")
    device = resolve_device(args.device)
    state, source, step = _restore(args.log_dir)
    model, example, call = served_model(args, model_dtype(args.precision))
    model.load_state_dict(state)
    model.to(device).eval().requires_grad_(False)
    log.info("restored %s (step %s)", source, step)

    example = tuple(e.to(device) for e in example)
    exported = export_forward(model, example, call)
    save_artifact(args.output, exported, model.state_dict(),
                  {"platforms": platforms, "model": args.model, "checkpoint_step": step,
                   "precision": args.precision},
                  resgcn_conv=args.resgcn_conv or "edge")
    log.info("wrote artifact to %s (platforms=%s)", args.output, ",".join(platforms))

    if args.check:
        forward, _ = load_artifact(args.output, device)
        inputs = [p.to(device) for p in probes(example)]
        with torch.no_grad():
            got = forward(*inputs)
            want = call(model, *inputs)
        torch.testing.assert_close(got, want, rtol=0, atol=CHECK_ATOL)
        log.info("round-trip check OK (max|Δ|=%.2e)", float((got - want).abs().max()))
    return args.output


if __name__ == "__main__":
    main()
