"""``cli.train`` → ``cli.eval`` → ``cli.attack --save_adv`` → ``cli.eval
--adv_set`` of the port for ``--model pointnet2_msg`` and ``--model
pointnet`` on the CPU (npoint 128, batch 8), resume, every attack, and the
trained checkpoint's log-probabilities against the JAX model's on the
same weights.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from pointsecguard_tpu.models import PointNet2SemSegMSG as JaxMSG
from pointsecguard_tpu.models import PointNetSemSeg as JaxPointNet
from pointsecguard_tpu.models.pointnet2 import build_geometry_msg as jax_build_geometry_msg
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks, make_synthetic_rooms
from pointsecguard_tpu_torch.train.trainer import POINTNET_MODELS
from pointsecguard_tpu_torch.utils import convert
from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint

RECIPE = ["--device", "cpu", "--npoint", "128", "--batch_size", "8",
          "--learning_rate", "0.003", "--seed", "0"]
STATE_FLOATS = {"pointnet2_msg": 1_895_253, "pointnet": 3_541_334}


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    """Like ``test_torch_train_cli.py``, this module trains full-width
    models, so it takes four threads where the other port modules take
    two (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=["pointnet2_msg", "pointnet"])
def trained(request, tmp_path_factory):
    """Synthetic rooms of 3000 points and the model through ``cli.train``
    for one epoch (3 optimizer steps and the whole-scene eval)."""
    model = request.param
    root = tmp_path_factory.mktemp(model)
    data, log = str(root / "data"), str(root / "log")
    make_synthetic_rooms(data, points_per_room=3000, seed=0)
    _, best_miou = train_cli.main(["--model", model, "--data_root", data, "--log_dir", log,
                                   "--epochs", "1", *RECIPE])
    return {"model": model, "data": data, "log": log, "best_miou": best_miou}


def _events(log, kind):
    with open(os.path.join(log, "events.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == kind]


def test_training_writes_its_epoch_and_eval_and_checkpoints(trained):
    (epoch,) = _events(trained["log"], "epoch")
    assert epoch["epoch"] == 0 and epoch["batches"] == 3 and epoch["nan_batches"] == 0
    assert epoch["lr"] == 0.003 and np.isfinite(epoch["loss"])
    (ev,) = _events(trained["log"], "eval")
    assert ev["miou"] == trained["best_miou"] and 0.0 <= ev["accuracy"] <= 1.0
    ckpt = CheckpointManager(os.path.join(trained["log"], "checkpoints"))
    latest = ckpt.restore_latest()
    assert latest["epoch"] == 1 and latest["step"] == 3 and latest["count"].item() == 3
    best = load_checkpoint(trained["log"])
    assert sum(v.numel() for v in best.values()) == STATE_FLOATS[trained["model"]]
    assert set(best) == set(POINTNET_MODELS[trained["model"]][0]().state_dict())


def test_trained_checkpoint_matches_the_jax_model(trained):
    """The trained weights through ``utils/convert.py`` into the JAX model:
    the evaluation-mode log-probabilities of 8 Area-5 blocks agree to
    1e-4, as the untrained ones do."""
    sd = load_checkpoint(trained["log"])
    blocks = WholeSceneBlocks(RoomSet.load(trained["data"], "test", 5), block_points=128
                              ).room_blocks(0, np.random.default_rng(0))[0][:8]
    model_cls, family = POINTNET_MODELS[trained["model"]]
    model = model_cls()
    model.load_state_dict(sd)
    with torch.no_grad():
        pts = torch.from_numpy(blocks)
        got = family.head(family.apply(model.eval(), pts, family.plan(pts))).numpy()
    if trained["model"] == "pointnet":
        variables = unflatten_dict(convert.pointnet_to_jax_variables(sd), sep="/")
        want = jax.jit(JaxPointNet().apply)(variables, jnp.asarray(blocks))[0]
    else:
        variables = unflatten_dict(convert.pointnet2_msg_to_jax_variables(sd), sep="/")
        want = jax.jit(lambda v, p: JaxMSG().apply(
            v, p, geometry=jax_build_geometry_msg(p[..., :3])))(variables,
                                                                  jnp.asarray(blocks))[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_resume_then_eval_gives_the_trainers_figure(trained):
    """A second call with one more epoch resumes (none repeated); then
    ``cli.eval`` on the checkpoint gives that epoch's eval back."""
    train_cli.main(["--model", trained["model"], "--data_root", trained["data"],
                    "--log_dir", trained["log"], "--epochs", "2", *RECIPE])
    assert [e["epoch"] for e in _events(trained["log"], "epoch")] == [0, 1]
    latest = CheckpointManager(os.path.join(trained["log"], "checkpoints")).restore_latest()
    assert latest["epoch"] == 2 and latest["step"] == 6
    evals = _events(trained["log"], "eval")
    best = max(evals, key=lambda e: e["miou"])
    total = eval_cli.main(["--model", trained["model"], "--device", "cpu",
                           "--data_root", trained["data"], "--log_dir", trained["log"],
                           "--num_point", "128", "--batch_size", "8", "--num_votes", "1"])
    assert total.accuracy == pytest.approx(best["accuracy"], abs=1e-9)
    assert total.miou == pytest.approx(best["miou"], abs=1e-9)


def test_attack_save_adv_then_eval_adv_set(trained):
    model = trained["model"]
    clean_m, adv_m = attack_cli.main([
        "--model", model, "--device", "cpu", "--attack", "nb", "--save_adv",
        "--data_root", trained["data"], "--log_dir", trained["log"],
        "--num_point", "128", "--max_blocks", "8"])
    path = os.path.join(trained["log"], f"{model}_nb_adv_area5.npz")
    with np.load(path) as f:
        assert f["points"].shape == (8, 128, 9) and f["labels"].shape == (8, 128)
    with open(os.path.join(trained["log"], f"{model}_nb_area5.tsv")) as f:
        rows = [line.split("\t") for line in f.read().splitlines()[1:]]
    assert len(rows) == 8 and all(r[7] == "10" for r in rows)  # the preset's 10 iterations
    tsv_adv = np.mean([float(r[3]) for r in rows])
    assert tsv_adv <= np.mean([float(r[2]) for r in rows])
    assert np.isfinite([clean_m.miou, adv_m.miou]).all()
    m = eval_cli.main(["--model", model, "--device", "cpu", "--log_dir", trained["log"],
                       "--adv_set", path, "--batch_size", "8"])
    assert m.accuracy == pytest.approx(tsv_adv, abs=1e-4)  # 4 decimals a row


@pytest.mark.parametrize("attack,steps", [("nu", 2), ("tar_nb", 3), ("tar_nu", 2)])
def test_every_attack_runs(trained, attack, steps, monkeypatch):
    """NU, tar_NB and tar_NU through the block driver, their presets
    (the "pointnet2" family's, 1000 C&W steps or 500 iterations) cut to a
    few steps to keep the CPU test short; targeted runs at the default
    batch 1 and floor → table, so that the first blocks hold origin
    points."""
    key = ("pointnet2", attack)
    field = "iters" if attack == "tar_nb" else "steps"
    monkeypatch.setitem(tattacks._PRESETS, key,
                        dataclasses.replace(tattacks._PRESETS[key], **{field: steps}))
    extra = ["--origin", "1"] if attack.startswith("tar_") else []
    attack_cli.main(["--model", trained["model"], "--device", "cpu", "--attack", attack,
                     "--data_root", trained["data"], "--log_dir", trained["log"],
                     "--num_point", "128", "--max_blocks", "2", *extra])
    with open(os.path.join(trained["log"], f"{trained['model']}_{attack}_area5.tsv")) as f:
        rows = [line.split("\t") for line in f.read().splitlines()[1:]]
    assert len(rows) >= 2
    for r in rows:
        assert 1 <= int(r[7]) <= steps and all(np.isfinite(float(x)) for x in r[2:7])
