"""Import a reference checkpoint into the port (port of
``pointsecguard_tpu/cli/import_ckpt.py``):

  python -m pointsecguard_tpu_torch.cli.import_ckpt --model pointnet2 \
      --ckpt /path/best_model.pth --log_dir log/imported

Maps the reference's trained weights (``utils/importers.py``: PointNet++
semseg `train_semseg.py` checkpoints, ResGCN `ckpt_util.py` checkpoints,
RandLA-Net TF1 snapshots from `RandLANet.py:141-142`) onto the port's
state dict and writes it as the port's checkpoint
(``<log_dir>/checkpoints/best.pt``, ``utils/checkpoint.py``), which
``cli.eval``, ``cli.attack``, ``cli.attack_object`` and ``cli.benchmark``
restore as they restore a trained one. The import runs on the CPU and
needs no GPU. The reference's optimizer state is not carried over.

A ``.pth`` is read with ``torch.load(weights_only=True)`` first; a pickled
checkpoint falls back to full unpickling with a warning. RandLA takes a
``.npz`` of ``{tf_variable_name: array}``; a TF checkpoint prefix is
refused, since reading one needs TensorFlow. Dump a snapshot to ``.npz``
where TensorFlow is installed with::

    python -c "import tensorflow as tf, numpy as np; \\
      r = tf.train.load_checkpoint('snap-XXXX'); \\
      np.savez('snap.npz', **{n: r.get_tensor(n) \\
        for n in r.get_variable_to_shape_map()})"

``--num_point`` is the JAX CLI's (the shape its model is initialised
with); the port's state dict has no point count, and only RandLA's rule
(divisible by 512, the 4-4-4-4-2 pyramid) is checked.
"""

from __future__ import annotations

import argparse

from pointsecguard_tpu_torch.utils.importers import MODELS


def load_torch_ckpt(path: str):
    """``torch.load`` with ``weights_only=True`` first; the reference's own
    checkpoints are plain tensor dicts and load that way. Fall back (with
    a warning) only for pickled formats: running arbitrary pickle is a
    trust decision the user should see."""
    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        print(f"WARNING: {path} is not a weights-only checkpoint; falling back to "
              "full unpickling, which executes code from the file. Only do this "
              "with checkpoints you trust.")
        return torch.load(path, map_location="cpu", weights_only=False)


def load_randla_arrays(path: str) -> dict:
    """The ``{tf_variable_name: array}`` of a ``.npz`` dump; SystemExit on
    anything else (a TF checkpoint prefix needs TensorFlow)."""
    if not path.endswith(".npz"):
        raise SystemExit(
            f"{path}: RandLA imports a .npz of TF variables; reading a TF "
            "checkpoint prefix needs tensorflow, which the port does not use. "
            "Dump the snapshot to .npz where tensorflow is installed (see "
            "python -m pointsecguard_tpu_torch.cli.import_ckpt --help) and pass that.")
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "import_ckpt", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, choices=list(MODELS))
    ap.add_argument("--ckpt", required=True,
                    help="reference checkpoint: .pth (torch state dict or "
                         "{'model_state_dict': ...}); for randla a .npz variable dump")
    ap.add_argument("--log_dir", required=True,
                    help="destination run dir (checkpoints/ is created)")
    ap.add_argument("--resgcn_blocks", type=int, default=28)
    ap.add_argument("--resgcn_conv", default="edge", choices=["edge", "mr"])
    ap.add_argument("--num_point", type=int, default=0,
                    help="0 = task default (4096 semseg, 1024 cls, 2048 part-seg)")
    return ap


def main(argv=None) -> dict:
    """Import and save; returns the port's state dict."""
    args = _parser().parse_args(argv)
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
    from pointsecguard_tpu_torch.utils.importers import (
        reference_variables,
        state_dict_from_variables,
    )

    epoch, miou = 0, 0.0
    if args.model == "randla":
        if (args.num_point or 4096) % 512:
            raise SystemExit("randla needs --num_point divisible by 512 "
                             "(the 4-4-4-4-2 pyramid)")
        ckpt = load_randla_arrays(args.ckpt)
    else:
        ckpt = load_torch_ckpt(args.ckpt)
        if isinstance(ckpt, dict):
            epoch = int(ckpt.get("epoch", 0))
            miou = float(ckpt.get("best_iou", 0.0))
    variables = reference_variables(args.model, ckpt, resgcn_blocks=args.resgcn_blocks,
                                    resgcn_conv=args.resgcn_conv)
    state = state_dict_from_variables(args.model, variables)
    path = save_checkpoint(args.log_dir, state)
    print(f"imported {args.ckpt} -> {path} (epoch {epoch}, best mIoU {miou:.4f})")
    return state


if __name__ == "__main__":
    main()
