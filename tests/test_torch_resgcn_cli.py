"""The port's ResGCN-28 protocol on the CPU at a small size (3 blocks, 8
filters, k = 4): ``cli.train --model resgcn`` (the JAX loop's batches,
``latest.pt`` only, resume with no epoch repeated), ``cli.eval --model
resgcn``, ``cli.attack --model resgcn`` NB with ``--save_adv`` →
``cli.eval --adv_set``, tar_NB's per-cloud gates on a room built so that
each gate both attacks and skips, and the flags that stay refused.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data import make_synthetic_rooms
from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint

SMALL = ["--resgcn_blocks", "3", "--resgcn_filters", "8", "--resgcn_k", "4"]
TRAIN = ["--model", "resgcn", "--device", "cpu", "--npoint", "128", "--batch_size", "8",
         "--learning_rate", "0.003", "--seed", "0"] + SMALL
EPOCHS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Synthetic rooms of 6000 points and the narrow model through
    ``cli.train`` for 2 epochs, with the batches handed to the prefetch
    thread recorded (its items are ``stack_batches`` stacks of
    ``--steps_per_call`` batches: each batch of a stack is recorded)."""
    from pointsecguard_tpu_torch.data import loader

    root = tmp_path_factory.mktemp("resgcn_cli")
    make_synthetic_rooms(str(root / "data"), points_per_room=6000, seed=0)
    seen = []
    real = loader.prefetch

    def spy(iterable, *a, **kw):
        def record():
            for item in iterable:
                seen.extend(batch.copy() for batch in item[0])
                yield item
        return real(record(), *a, **kw)

    log = str(root / "log")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loader, "prefetch", spy)
        _, result = train_cli.main(TRAIN + ["--data_root", str(root / "data"), "--log_dir", log,
                                            "--epochs", str(EPOCHS)])
    assert result is None  # the loop does not evaluate, as in the JAX package
    return {"root": root, "data": str(root / "data"), "log": log, "blocks": seen}


def _events(log):
    with open(os.path.join(log, "events.jsonl")) as f:
        return [json.loads(line) for line in f if json.loads(line)["event"] == "epoch"]


def test_training_keeps_latest_only_and_one_line_per_epoch(trained):
    ckdir = os.path.join(trained["log"], "checkpoints")
    assert sorted(os.listdir(ckdir)) == ["latest.pt"]
    epochs = _events(trained["log"])
    assert [e["epoch"] for e in epochs] == list(range(EPOCHS))
    steps = epochs[0]["batches"]
    for e in epochs:
        assert e["batches"] == steps > 0 and e["nan_batches"] == 0 and np.isfinite(e["loss"])
        assert e["lr"] == 0.003  # constant: the reference's schedule is off
    latest = CheckpointManager(ckdir).restore_latest()
    assert latest["epoch"] == EPOCHS and latest["step"] == steps * EPOCHS
    assert latest["best_miou"] == max(-e["loss"] for e in epochs)  # the −loss metric


def test_training_takes_the_blocks_of_the_jax_loop(trained):
    """The JAX loop spends one sampler batch on shaping its state, then
    draws an epoch of batches from the same generator: the port trained
    on those blocks, array-equal and unaugmented."""
    from pointsecguard_tpu.data import RoomSet, S3DISBlockSampler

    sampler = S3DISBlockSampler(RoomSet.load(trained["data"], "train", 5), num_point=128)
    rng = np.random.default_rng(0)
    next(iter(sampler.batches(rng, 8)))
    want = [p for _ in range(EPOCHS) for p, _ in sampler.batches(rng, 8)]
    assert len(trained["blocks"]) == len(want)
    for got, w in zip(trained["blocks"], want):
        np.testing.assert_array_equal(got, w)


def test_resume_repeats_no_epoch(trained, capfd):
    train_cli.main(TRAIN + ["--data_root", trained["data"], "--log_dir", trained["log"],
                            "--epochs", str(EPOCHS + 1)])
    assert "resumed from epoch 2" in capfd.readouterr().err
    epochs = _events(trained["log"])
    assert [e["epoch"] for e in epochs] == list(range(EPOCHS + 1))
    latest = CheckpointManager(os.path.join(trained["log"], "checkpoints")).restore_latest()
    assert latest["epoch"] == EPOCHS + 1 and latest["step"] == epochs[0]["batches"] * 3


def test_eval_then_attack_then_adv_set(trained):
    """``cli.eval`` scores the trained checkpoint; NB with ``--save_adv``
    writes 8 blocks; ``cli.eval --adv_set`` on them gives the TSV's mean
    adversarial accuracy back."""
    from pointsecguard_tpu_torch.data import RoomSet
    from pointsecguard_tpu_torch.models import DenseDeepGCN
    from pointsecguard_tpu_torch.train.evaluator import evaluate_whole_scenes
    from pointsecguard_tpu_torch.train.trainer import make_eval_step, resgcn_family
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    base = ["--model", "resgcn", "--device", "cpu", "--log_dir", trained["log"]] + SMALL
    total = eval_cli.main(base + ["--data_root", trained["data"], "--num_point", "128",
                                  "--batch_size", "8", "--num_votes", "1"])
    model = DenseDeepGCN(n_blocks=3, n_filters=8, k=4)
    model.load_state_dict(load_checkpoint(trained["log"]))
    want, _ = evaluate_whole_scenes(
        make_eval_step(model.eval(), torch.device("cpu"), resgcn_family()),
        RoomSet.load(trained["data"], "test", 5), batch_size=8, num_votes=1,
        block_points=128, rng=np.random.default_rng(0))
    assert total.accuracy == want.accuracy and np.isfinite(total.miou)

    clean_m, adv_m = attack_cli.main(base + ["--attack", "nb", "--save_adv", "--data_root",
                                             trained["data"], "--num_point", "128",
                                             "--batch_size", "8", "--max_blocks", "8"])
    with open(os.path.join(trained["log"], "resgcn_nb_area5.tsv")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    assert len(rows) == 8 and all(int(r[7]) == 50 for r in rows)  # the preset's 50 iterations
    adv = np.mean([float(r[3]) for r in rows])
    assert np.isfinite([clean_m.miou, adv_m.miou]).all()
    m = eval_cli.main(base + ["--adv_set", os.path.join(trained["log"],
                                                        "resgcn_nb_adv_area5.npz")])
    assert m.accuracy == pytest.approx(adv, abs=1e-3)


# --- tar_NB's per-cloud gates --------------------------------------------------

def _gate_room(path):
    """A 2 × 1 m room whose left 0.8 m are board (11) and the rest table
    (7): of its three 1 m windows, the first holds ~80 % board points, the
    second ~30 %, the third none; each window of ~2000 points gives two
    blocks of 1024."""
    rng = np.random.default_rng(0)
    n = 4000
    xyz = rng.random((n, 3)) * np.array([2.0, 1.0, 1.0])
    rgb = rng.random((n, 3)) * 255
    label = np.where(xyz[:, 0] < 0.8, 11, 7)
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "Area_5_gate_1.npy"),
            np.concatenate([xyz, rgb, label[:, None]], axis=1))


def _constant_checkpoint(log, cls):
    """The narrow model with its classifier's bias raised on ``cls``: it
    predicts ``cls`` everywhere."""
    from pointsecguard_tpu_torch.models import DenseDeepGCN, init_parameters

    model = DenseDeepGCN(n_blocks=3, n_filters=8, k=4)
    init_parameters(model, torch.Generator().manual_seed(0), scale=2.0)
    sd = model.state_dict()
    sd["cls.dense.bias"][cls] += 1e4
    save_checkpoint(log, sd)


def _run_targeted(data, log):
    lines = []

    class Gates(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Gates()
    logging.getLogger("attack").addHandler(handler)
    try:
        attack_cli.main(["--model", "resgcn", "--device", "cpu", "--attack", "tar_nb",
                         "--data_root", data, "--log_dir", log, "--num_point", "1024"] + SMALL)
    finally:
        logging.getLogger("attack").removeHandler(handler)
    with open(os.path.join(log, "resgcn_tar_nb_area5.tsv")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    return rows, [line for line in lines if line.startswith("resgcn gates")]


def test_targeted_gates_attack_and_skip(tmp_path):
    """Blocks with ≤ 500 origin points are skipped; of the others, a
    model that gets the origin points right is attacked and one that gets
    them wrong is skipped (`sem_seg_dense/attacks.py:204-207`). Attacked
    blocks keep every row: the TSV's other_acc is over the non-origin
    points."""
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks

    data = str(tmp_path / "data")
    _gate_room(data)
    _, labels, _, _ = WholeSceneBlocks(RoomSet.load(data, "test", 5), block_points=1024
                                       ).room_blocks(0, np.random.default_rng(0))
    counts = (labels == 11).sum(axis=1)
    many = np.flatnonzero(counts > 500)
    assert 0 < len(many) < len(counts) and len(counts) == 6
    _constant_checkpoint(str(tmp_path / "right"), 11)
    rows, gates = _run_targeted(data, str(tmp_path / "right"))
    assert [int(r[1]) for r in rows] == many.tolist()
    assert gates == [f"resgcn gates: {len(many)} clouds attacked, {len(counts) - len(many)} "
                     "skipped with <= 500 origin points, 0 with masked clean accuracy < 0.5"]
    for r in rows:  # the clean accuracy of a constant board prediction
        assert float(r[2]) == pytest.approx((labels[int(r[1])] == 11).mean(), abs=1e-4)
    _constant_checkpoint(str(tmp_path / "wrong"), 7)
    rows, gates = _run_targeted(data, str(tmp_path / "wrong"))
    assert rows == []
    assert gates == [f"resgcn gates: 0 clouds attacked, {len(counts) - len(many)} skipped "
                     f"with <= 500 origin points, {len(many)} with masked clean accuracy < 0.5"]


def test_targeted_runs_take_batch_1_before_any_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="--batch_size 1"):
        attack_cli.main(["--model", "resgcn", "--device", "cpu", "--attack", "tar_nb",
                         "--batch_size", "2", "--log_dir", str(tmp_path / "none")])


@pytest.mark.parametrize("cli,argv", [
    # --resgcn_fast is ported (tests/test_torch_resgcn_fast.py): with
    # another model it is refused as the other --resgcn_* flags are
    (attack_cli, ["--model", "randla", "--resgcn_fast"]),
    (attack_cli, ["--model", "pointnet2", "--resgcn_fixed_graphs"]),
    (attack_cli, ["--model", "pointnet2", "--resgcn_blocks", "3"]),
    # resgcn takes --remat, --device_sampler, --steps_per_call and --adv_train
    # nb (tests/test_torch_train_cli.py); with another model, or another
    # value, each is refused
    (train_cli, ["--model", "pointnet2", "--remat"]),
    (train_cli, ["--model", "randla", "--device_sampler"]),
    (train_cli, ["--model", "resgcn", "--profile", "trace"]),
    (train_cli, ["--model", "resgcn", "--adv_train", "pgd"]),
    (train_cli, ["--model", "randla", "--resgcn_k", "8"]),
    (eval_cli, ["--model", "pointnet2_msg", "--resgcn_fast"]),
    (eval_cli, ["--model", "pointnet2", "--resgcn_conv", "mr"]),
])
def test_unported_flags_are_refused_by_name(cli, argv):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("cli", [attack_cli, train_cli, eval_cli],
                         ids=["attack", "train", "eval"])
def test_precision_bfloat16_is_taken(cli):
    """ResGCN's ``--precision bfloat16``, once refused, is ported
    (tests/test_torch_precision_cli.py runs it)."""
    args = cli._parser().parse_args(["--model", "resgcn", "--precision", "bfloat16"])
    cli._refuse_unported(args)
    assert args.precision == "bfloat16"
