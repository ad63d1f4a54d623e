"""The trained-fixture recipe of the JAX package, run through the port:

  python -m pointsecguard_tpu_torch.cli.fixture_recipe --device cpu \
      [--seeds 0 1 2] [--epochs 32] [--work_dir DIR]

For each seed: synthetic rooms of 6000 points (seed 0, as the committed
fixture), ``cli.train --model pointnet2 --npoint 128 --batch_size 8
--learning_rate 0.003 --eval_every <epochs>``, ``cli.eval --num_votes 1``
on the result, and the fixture's own clean accuracy: the share of
correct points on the first 8 whole-scene blocks of the Area-5 room
(``tests/fixtures/trained_pointnet2.json`` holds the JAX package's,
0.4746 at seed 0). Prints one JSON line per seed. A correctness figure
of the trainer; it measures no speed.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

RECIPE = {"npoint": 128, "points_per_room": 6000, "batch_size": 8,
          "learning_rate": 0.003}


def run_seed(seed: int, epochs: int, work_dir: str, device: str) -> dict:
    import numpy as np
    import torch

    from pointsecguard_tpu_torch.cli import eval as cli_eval
    from pointsecguard_tpu_torch.cli import train as cli_train
    from pointsecguard_tpu_torch.data import (
        RoomSet,
        WholeSceneBlocks,
        make_synthetic_rooms,
    )
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG
    from pointsecguard_tpu_torch.train.trainer import make_eval_step
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
    from pointsecguard_tpu_torch.utils.runtime import resolve_device

    data = os.path.join(work_dir, "data")
    log = os.path.join(work_dir, f"log_seed{seed}")
    make_synthetic_rooms(data, points_per_room=RECIPE["points_per_room"], seed=0)
    common = ["--model", "pointnet2", "--data_root", data, "--log_dir", log,
              "--device", device, "--batch_size", str(RECIPE["batch_size"])]
    _, best_miou = cli_train.main(common + [
        "--epochs", str(epochs), "--npoint", str(RECIPE["npoint"]),
        "--learning_rate", str(RECIPE["learning_rate"]),
        "--eval_every", str(epochs), "--seed", str(seed)])
    total = cli_eval.main(common + ["--num_point", str(RECIPE["npoint"]),
                                    "--num_votes", "1"])
    model = PointNet2SemSegSSG()
    model.load_state_dict(load_checkpoint(log))
    dev = resolve_device(device)
    predict = make_eval_step(model.to(dev).requires_grad_(False), dev)
    rooms = RoomSet.load(data, "test", 5)
    feats, labs, _, _ = WholeSceneBlocks(
        rooms, block_points=RECIPE["npoint"]).room_blocks(0, np.random.default_rng(0))
    with torch.no_grad():
        clean_acc = float((predict(feats[:8]) == labs[:8]).mean())
    return {"seed": seed, "epochs": epochs, "clean_acc_first_8_blocks": clean_acc,
            "eval_accuracy": total.accuracy, "eval_miou": total.miou,
            "train_best_miou": best_miou}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--work_dir", default=None, help="default: a temporary directory")
    args = ap.parse_args(argv)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            res = run_seed(seed, args.epochs, args.work_dir or tmp, args.device)
            print(json.dumps(res), flush=True)
            results.append(res)
    return results


if __name__ == "__main__":
    main()
