"""``--precision bfloat16`` through the port's five CLIs that take it, on
the CPU at a small size: ``cli.train`` → ``cli.eval`` (PointNet, and
ResGCN with ``--remat``), ``cli.attack`` (NB on the trained PointNet),
``cli.benchmark`` (one attack) and ``cli.attack_object`` (NB on a
PointNet classifier). The bf16 run's parameters and checkpoints stay
float32, its losses and figures are finite, and ``cli.eval`` in bf16
reproduces the bf16 trainer's own evaluation exactly (the same model on
the same blocks). The models' numbers are held to the JAX package's in
``tests/test_torch_precision.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import attack_object as object_cli
from pointsecguard_tpu_torch.cli import benchmark as bench_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data import make_synthetic_rooms
from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset, make_synthetic_modelnet
from pointsecguard_tpu_torch.models import PointNetCls, init_parameters
from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

BF16 = ["--precision", "bfloat16"]
RECIPE = ["--device", "cpu", "--npoint", "128", "--batch_size", "8",
          "--learning_rate", "0.003", "--seed", "0"]
SMALL_RESGCN = ["--resgcn_blocks", "3", "--resgcn_filters", "8", "--resgcn_k", "4"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("rooms") / "data")
    make_synthetic_rooms(data, points_per_room=3000, seed=0)
    return data


@pytest.fixture(scope="module")
def pointnet(rooms, tmp_path_factory):
    """PointNet through ``cli.train --precision bfloat16`` for one epoch
    (3 steps and the whole-scene evaluation)."""
    log = str(tmp_path_factory.mktemp("pointnet") / "log")
    _, best = train_cli.main(["--model", "pointnet", "--data_root", rooms, "--log_dir", log,
                              "--epochs", "1", *RECIPE, *BF16])
    return {"log": log, "best_miou": best}


def _events(log, kind):
    with open(os.path.join(log, "events.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == kind]


def test_train_keeps_float32_state_and_eval_reproduces_it(pointnet, rooms):
    (epoch,) = _events(pointnet["log"], "epoch")
    assert epoch["batches"] == 3 and epoch["nan_batches"] == 0 and np.isfinite(epoch["loss"])
    state = load_checkpoint(pointnet["log"])
    assert {v.dtype for v in state.values()} == {torch.float32}
    m = eval_cli.main(["--device", "cpu", "--data_root", rooms, "--log_dir", pointnet["log"],
                       "--model", "pointnet", "--num_point", "128", "--batch_size", "8",
                       "--num_votes", "1", *BF16])
    assert m.miou == pointnet["best_miou"]


def test_attack_nb_in_bf16(pointnet, rooms):
    clean, adv = attack_cli.main([
        "--device", "cpu", "--model", "pointnet", "--attack", "nb", "--data_root", rooms,
        "--log_dir", pointnet["log"], "--num_point", "128", "--batch_size", "8",
        "--max_blocks", "8", *BF16])
    assert 0.0 <= adv.accuracy <= clean.accuracy <= 1.0
    with open(os.path.join(pointnet["log"], "pointnet_nb_area5.tsv")) as f:
        rows = f.read().splitlines()[1:]
    assert len(rows) == 8


def test_benchmark_attack_in_bf16(pointnet, rooms):
    acc, acc_adv, total, succ, dist = bench_cli.main([
        "--device", "cpu", "--model", "pointnet", "--data_root", rooms,
        "--log_dir", pointnet["log"], "--num_point", "128", "--batch_size", "4",
        "--max_blocks", "8", "--attack_name", "fgsm", *BF16])
    assert acc.shape == (8 * 128,) and np.isfinite(dist).all() and (dist > 0).all()


def test_attack_object_nb_in_bf16(tmp_path):
    data = str(tmp_path / "mn")
    make_synthetic_modelnet(data, points_per_shape=256, train_per_class=1, test_per_class=1,
                            seed=4)
    model = PointNetCls(num_classes=ModelNetDataset(data, "test", num_point=128).num_classes)
    init_parameters(model, torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "log"), model.state_dict())
    out = object_cli.main(["--device", "cpu", "--model", "pointnet_cls", "--attack", "nb",
                           "--data_root", data, "--log_dir", str(tmp_path / "log"),
                           "--num_point", "128", "--batch_size", "4", "--max_shapes", "4",
                           "--iters", "2", *BF16])
    assert os.path.exists(out["tsv"]) and np.isfinite(out["l2_mean"])


def test_resgcn_train_with_remat_then_eval_in_bf16(rooms, tmp_path):
    log = str(tmp_path / "resgcn")
    train_cli.main(["--model", "resgcn", "--data_root", rooms, "--log_dir", log,
                    "--epochs", "1", "--remat", *RECIPE, *SMALL_RESGCN, *BF16])
    (epoch,) = _events(log, "epoch")
    assert epoch["nan_batches"] == 0 and np.isfinite(epoch["loss"])
    assert {v.dtype for v in load_checkpoint(log).values()} == {torch.float32}
    m = eval_cli.main(["--device", "cpu", "--data_root", rooms, "--log_dir", log,
                       "--model", "resgcn", "--num_point", "128", "--batch_size", "8",
                       "--num_votes", "1", *SMALL_RESGCN, *BF16])
    assert 0.0 <= m.accuracy <= 1.0
