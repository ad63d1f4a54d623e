"""The port's ``cli.train`` → ``cli.eval`` → ``cli.attack --save_adv`` →
``cli.eval --adv_set`` on the CPU at the trained fixture's recipe cut to
7 epochs, resume, and the flags both new CLIs refuse.
"""

import json
import os

import numpy as np
import pytest
import torch

from pointsecguard_tpu.cli import eval as jax_eval_cli
from pointsecguard_tpu.cli import train as jax_train_cli
from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import fixture_recipe
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data import make_synthetic_rooms
from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint

EPOCHS = 7
RECIPE = ["--npoint", "128", "--batch_size", "8", "--learning_rate", "0.003"]


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend. This module trains the
    full-width model for 48 steps, so like ``test_torch_attack.py`` it
    takes four threads where the other port modules take two (restored
    afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fixture recipe (6000-point rooms, npoint 128, batch 8, lr
    0.003, seed 0) through ``cli.train`` for 7 of its 32 epochs: 42
    optimizer steps and one whole-scene eval."""
    root = tmp_path_factory.mktemp("recipe")
    data, log = str(root / "data"), str(root / "log")
    make_synthetic_rooms(data, points_per_room=fixture_recipe.RECIPE["points_per_room"],
                         seed=0)
    _, best_miou = train_cli.main([
        "--device", "cpu", "--model", "pointnet2", "--data_root", data, "--log_dir", log,
        "--epochs", str(EPOCHS), "--eval_every", str(EPOCHS), "--seed", "0", *RECIPE])
    return {"root": root, "data": data, "log": log, "best_miou": best_miou}


def _events(log):
    with open(os.path.join(log, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_training_writes_one_epoch_line_per_epoch_and_the_loss_falls(trained):
    epochs = [e for e in _events(trained["log"]) if e["event"] == "epoch"]
    assert [e["epoch"] for e in epochs] == list(range(EPOCHS))
    for e in epochs:
        assert set(e) == {"t", "event", "epoch", "lr", "bn_momentum", "loss",
                          "nan_batches", "batches", "seconds"}
        assert e["batches"] == 6 and e["nan_batches"] == 0  # ceil(46 / 8)
        assert e["lr"] == 0.003 and e["bn_momentum"] == 0.1 and np.isfinite(e["loss"])
    assert epochs[-1]["loss"] < 0.25 * epochs[0]["loss"]
    evals = [e for e in _events(trained["log"]) if e["event"] == "eval"]
    assert [e["epoch"] for e in evals] == [EPOCHS - 1]  # --eval_every 7
    assert set(evals[0]) == {"t", "event", "epoch", "miou", "accuracy"}
    assert evals[0]["miou"] == trained["best_miou"]


def test_shortened_recipe_reaches_its_floor(trained):
    """The whole recipe (32 epochs, ``cli/fixture_recipe.py`` on the CPU)
    reached a clean accuracy of 0.494, 0.510 and 0.502 on the fixture's 8
    blocks at seeds 0, 1 and 2 (the JAX fixture: 0.4746) and 0.693, 0.706
    and 0.682 through ``cli.eval``. The whole-scene accuracy wanders over
    the first six epochs (0.03 to 0.54 at epoch 4 over those seeds, while
    the BatchNorm statistics trail the weights) and has settled by the
    seventh: 0.702, 0.665 and 0.685 at seeds 0, 1 and 2 on two threads,
    0.700 at seed 0 on four (``cli.train --eval_every 1``). The floor
    held here, at seed 0 after 7 epochs, is 0.5; ``cli.eval`` on the
    checkpoint gives the trainer's own figure back."""
    trainer_eval = [e for e in _events(trained["log"]) if e["event"] == "eval"][0]
    assert trainer_eval["accuracy"] >= 0.5
    total = eval_cli.main(["--device", "cpu", "--data_root", trained["data"],
                           "--log_dir", trained["log"], "--num_point", "128",
                           "--batch_size", "8", "--num_votes", "1", "--seed", "0"])
    assert total.accuracy == pytest.approx(trainer_eval["accuracy"], abs=1e-9)
    assert total.miou == pytest.approx(trainer_eval["miou"], abs=1e-9)


def test_checkpoints_hold_best_and_latest(trained):
    ckpt = CheckpointManager(os.path.join(trained["log"], "checkpoints"))
    latest = ckpt.restore_latest()
    assert latest["epoch"] == EPOCHS and latest["step"] == 6 * EPOCHS
    assert latest["count"].item() == 6 * EPOCHS
    assert set(latest) == {"model", "mu", "nu", "count", "step", "epoch", "best_miou"}
    best = ckpt.restore_best()
    assert set(best) == set(latest["model"]) == set(load_checkpoint(trained["log"]))
    assert sum(v.numel() for v in best.values()) == 975_949
    assert all(torch.equal(best[k], latest["model"][k]) for k in best)


def test_resume_repeats_no_epoch(trained):
    """A second call with more ``--epochs`` goes on from the newest epoch
    saved: Adam's moments and counts included."""
    train_cli.main(["--device", "cpu", "--data_root", trained["data"],
                    "--log_dir", trained["log"], "--epochs", str(EPOCHS + 1),
                    "--eval_every", str(EPOCHS), *RECIPE])
    epochs = [e["epoch"] for e in _events(trained["log"]) if e["event"] == "epoch"]
    assert epochs == list(range(EPOCHS + 1))
    latest = CheckpointManager(os.path.join(trained["log"], "checkpoints")).restore_latest()
    assert latest["epoch"] == EPOCHS + 1 and latest["step"] == 6 * (EPOCHS + 1)
    assert latest["count"].item() == 6 * (EPOCHS + 1)
    # and a call that has nothing left to train changes nothing
    train_cli.main(["--device", "cpu", "--data_root", trained["data"],
                    "--log_dir", trained["log"], "--epochs", str(EPOCHS + 1), *RECIPE])
    assert len(_events(trained["log"])) == len(epochs) + 2


def test_attack_save_adv_then_eval_adv_set(trained):
    """``--save_adv`` writes what ``--adv_set`` reads: the re-evaluated
    accuracy is the attack run's own adversarial accuracy over the same
    blocks (the TSV's mean; the model and the blocks are the same, so the
    predictions are)."""
    clean_m, adv_m = attack_cli.main([
        "--device", "cpu", "--model", "pointnet2", "--attack", "nb", "--save_adv",
        "--data_root", trained["data"], "--log_dir", trained["log"],
        "--num_point", "128", "--batch_size", "8", "--max_blocks", "8"])
    path = os.path.join(trained["log"], "pointnet2_nb_adv_area5.npz")
    with np.load(path) as f:
        assert f["points"].shape == (8, 128, 9) and f["points"].dtype == np.float32
        assert f["labels"].shape == (8, 128) and f["labels"].dtype == np.int32
    with open(os.path.join(trained["log"], "pointnet2_nb_area5.tsv")) as f:
        rows = [line.split("\t") for line in f.read().splitlines()[1:]]
    tsv_adv_acc = np.mean([float(r[3]) for r in rows])
    tsv_clean_acc = np.mean([float(r[2]) for r in rows])
    m = eval_cli.main(["--device", "cpu", "--log_dir", trained["log"],
                       "--adv_set", path, "--batch_size", "8"])
    assert m.accuracy == pytest.approx(tsv_adv_acc, abs=1e-4)  # 4 decimals a row
    assert tsv_adv_acc <= tsv_clean_acc
    assert 0.0 <= adv_m.miou <= 1.0 and 0.0 <= clean_m.miou <= 1.0
    # batch size does not change what is evaluated
    m5 = eval_cli.main(["--device", "cpu", "--log_dir", trained["log"],
                        "--adv_set", path, "--batch_size", "5"])
    assert m5.accuracy == pytest.approx(m.accuracy, abs=1e-6)


def test_eval_without_a_checkpoint_stops(trained, tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_cli.main(["--device", "cpu", "--data_root", trained["data"],
                       "--log_dir", str(tmp_path / "none")])


# --- flags -------------------------------------------------------------------

_TRAIN_REFUSED = [
    # resgcn is ported; --remat, which its run would take, is not
    pytest.param(["--model", "resgcn", "--remat"], id="--model resgcn"),
    # the classifiers are ported; bfloat16, which their run would take, is not
    pytest.param(["--model", "pointnet2_cls", "--precision", "bfloat16"],
                 id="--model pointnet2_cls"),
    ["--model", "pointnet2_part_seg"],
    ["--steps_per_call", "4"], ["--device_sampler"], ["--device_sampler_exact"],
    ["--adv_train", "nb"], ["--adv_eps", "0.2"], ["--adv_alpha", "0.01"],
    ["--adv_iters", "3"], ["--adv_rand_init", "0.1"], ["--precision", "bfloat16"],
    ["--devices", "2"], ["-d", "4"], ["--shard_points", "2"], ["--remat"],
    ["--profile", "trace"],
    ["--resgcn_blocks", "3"],
    ["--resgcn_k", "8"], ["--resgcn_filters", "32"], ["--resgcn_block_type", "dense"],
    ["--resgcn_conv", "mr"], ["--resgcn_epsilon", "0.2"], ["--num_category", "10"],
    ["--no_normals"],
]

_EVAL_REFUSED = [
    # resgcn is ported; its subsample dilation (--resgcn_fast) is not
    pytest.param(["--model", "resgcn", "--resgcn_fast"], id="--model resgcn"),
    pytest.param(["--model", "pointnet_cls", "--devices", "2"], id="--model pointnet_cls"),
    ["--model", "pointnet_part_seg"],
    # --save_preds is RandLA's (PLYs of reprojected clouds)
    ["--save_preds", "out"], ["--devices", "2"], ["--shard_points", "2"],
    ["--precision", "bfloat16"], ["--num_category", "10"], ["--no_normals"],
    ["--resgcn_blocks", "3"], ["--resgcn_k", "8"], ["--resgcn_filters", "32"],
    ["--resgcn_block_type", "plain"], ["--resgcn_conv", "edge"],
    ["--resgcn_epsilon", "0.2"], ["--resgcn_fast"],
]

# flags of RandLA's, ResGCN's, PointNet++ MSG's and PointNet's training and
# eval, ported: parsed into the arguments, refused by nothing
# (tests/test_torch_randla_train_cli.py, tests/test_torch_resgcn_cli.py and
# tests/test_torch_pointnet_cli.py run them)
_TRAIN_TAKEN = [
    (["--model", "pointnet2_msg"], "model", "pointnet2_msg"),
    (["--model", "pointnet"], "model", "pointnet"),
    (["--model", "randla"], "model", "randla"),
    (["--randla_dir", "elsewhere"], "randla_dir", "elsewhere"),
    (["--randla_points", "512"], "randla_points", 512),
    (["--val_steps", "4"], "val_steps", 4),
    (["--steps_per_epoch", "4"], "steps_per_epoch", 4),
    (["--model", "resgcn"], "model", "resgcn"),
    (["--model", "resgcn", "--resgcn_blocks", "3"], "resgcn_blocks", 3),
    (["--model", "resgcn", "--resgcn_epsilon", "0.2"], "resgcn_epsilon", 0.2),
    (["--randla_dataset", "semantickitti"], "randla_dataset", "semantickitti"),
]
_EVAL_TAKEN = [
    (["--model", "pointnet2_msg"], "model", "pointnet2_msg"),
    (["--model", "pointnet"], "model", "pointnet"),
    (["--model", "randla"], "model", "randla"),
    (["--randla_dir", "elsewhere"], "randla_dir", "elsewhere"),
    (["--num_clouds", "10"], "num_clouds", 10),
    (["--randla_points", "512"], "randla_points", 512),
    (["--model", "resgcn"], "model", "resgcn"),
    (["--model", "resgcn", "--resgcn_block_type", "plain"], "resgcn_block_type", "plain"),
    (["--model", "resgcn", "--resgcn_conv", "mr"], "resgcn_conv", "mr"),
    (["--visual"], "visual", True),
    (["--model", "randla", "--save_preds", "out"], "save_preds", "out"),
    (["--randla_dataset", "semantic3d"], "randla_dataset", "semantic3d"),
]


@pytest.mark.parametrize("flags", _TRAIN_REFUSED, ids=" ".join)
def test_train_refuses_unported_flags(flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        train_cli.main(flags)


@pytest.mark.parametrize("flags", _EVAL_REFUSED, ids=" ".join)
def test_eval_refuses_unported_flags(flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        eval_cli.main(flags)


@pytest.mark.parametrize("cli,flags,name,value",
                         [(train_cli, *t) for t in _TRAIN_TAKEN]
                         + [(eval_cli, *t) for t in _EVAL_TAKEN],
                         ids=[f"train {' '.join(t[0])}" for t in _TRAIN_TAKEN]
                         + [f"eval {' '.join(t[0])}" for t in _EVAL_TAKEN])
def test_randla_flags_are_taken(cli, flags, name, value):
    args = cli._parser().parse_args(flags)
    cli._refuse_unported(args)
    assert getattr(args, name) == value


def _flag_names(main, monkeypatch):
    """Every option string a CLI's parser is given."""
    import argparse

    names = set()
    real = argparse.ArgumentParser.add_argument

    def spy(self, *flags, **kw):
        names.update(f for f in flags if f.startswith("--"))
        return real(self, *flags, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "add_argument", spy)
        with pytest.raises(SystemExit):  # parsed after every flag is declared
            main(["--no_such_flag"])
    return names


@pytest.mark.parametrize("ours,theirs", [(train_cli, jax_train_cli),
                                         (eval_cli, jax_eval_cli)],
                         ids=["train", "eval"])
def test_every_flag_of_the_jax_cli_is_accepted_by_name(ours, theirs, monkeypatch, capsys):
    jax_flags = _flag_names(theirs.main, monkeypatch)
    port_flags = _flag_names(ours.main, monkeypatch)
    capsys.readouterr()
    assert jax_flags <= port_flags
    assert port_flags - jax_flags == {"--device"}


@pytest.mark.parametrize("cli", [train_cli, eval_cli], ids=["train", "eval"])
def test_cuda_device_without_a_card_raises(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data_root", str(tmp_path), "--log_dir", str(tmp_path / "log")])


def test_defaults_resolve_as_in_the_jax_cli(monkeypatch, tmp_path):
    """--batch_size 0 → 32, --npoint 0 → 4096, --learning_rate 0 → 0.001."""
    from pointsecguard_tpu_torch.train import loops

    seen = {}

    def fake_loop(args, device):
        seen.update(vars(args), device=device)
        return None, 0.0

    monkeypatch.setattr(loops, "train_pointnet_family", fake_loop)
    train_cli.main(["--device", "cpu", "--log_dir", str(tmp_path / "log")])
    assert seen["npoint"] == 4096 and seen["device"] == torch.device("cpu")
    # the loop resolves the other two, as the JAX loop does
    assert seen["batch_size"] == 0 and seen["learning_rate"] == 0.0
    assert seen["epochs"] == 32 and seen["eval_every"] == 1 and seen["prefetch"] == 2
    assert seen["min_block_points"] == 1024 and seen["test_area"] == 5
