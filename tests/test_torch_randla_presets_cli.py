"""The port's RandLA-Net CLIs on the SemanticKITTI and Semantic3D presets,
on the CPU, over tiny trees written by ``cli.prepare``: ``cli.train`` (the
preset's class weights, the ignored-label loss, resume), ``cli.eval``
against the JAX ``cli.eval`` on the same converted weights (Semantic3D
reprojected through ``_proj.pkl``, SemanticKITTI at sub-cloud resolution),
``--save_preds`` → ``cli.cv6fold``, Semantic3D's ``cli.attack`` against the
JAX driver (ignored points masked out), ``--save_adv`` → ``--adv_set``, and
the refusals in the JAX driver's words. A narrow two-layer config stands in
for both presets (the full width only makes the CPU slower; the full-width
models are held to the JAX package in ``test_torch_randla_presets.py``).
"""

import functools
import inspect
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointsecguard_tpu import configs as jconfigs
from pointsecguard_tpu_torch import configs as tconfigs
from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import cv6fold, prepare
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data import randla
from pointsecguard_tpu_torch.data import synthetic_outdoor as synth
from pointsecguard_tpu_torch.data.ply import read_ply
from pointsecguard_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint
from pointsecguard_tpu_torch.utils.convert import (
    randla_from_jax_variables,
    randla_to_jax_variables,
)

NARROW = {"d_out": (8, 16), "num_layers": 2, "sub_sampling_ratio": (4, 4)}
CONFIGS = {"semantic3d": "RandlaSemantic3DConfig", "semantickitti": "RandlaSemanticKITTIConfig"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _narrow(mp):
    for name in CONFIGS.values():
        for mod in (jconfigs, tconfigs):
            mp.setattr(mod, name, functools.partial(getattr(mod, name), **NARROW))


@pytest.fixture(autouse=True)
def narrow(monkeypatch):
    _narrow(monkeypatch)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Both datasets through the port's cli.prepare: KITTI sequences 00 (2
    scans), 08 and 11; Semantic3D's training cloud, ``bildstein_station3``
    (validation) and an unlabeled cloud."""
    root = tmp_path_factory.mktemp("presets_cli")
    seq, yaml_path = synth.write_raw_semantickitti(str(root / "kitti"), points=3000, seed=1)
    synth.write_raw_semantic3d(str(root / "sem3d"), points=6000, extent=6.0, seed=2)
    prepare.main(["--dataset", "semantickitti", "--raw_root", seq, "--out_root",
                  str(root / "kitti_prep"), "--kitti_yaml", yaml_path])
    prepare.main(["--dataset", "semantic3d", "--raw_root", str(root / "sem3d"),
                  "--out_root", str(root / "sem3d_prep")])
    return {"root": root, "semantickitti": str(root / "kitti_prep"),
            "semantic3d": str(root / "sem3d_prep" / "input_0.060"),
            "original": str(root / "sem3d_prep" / "original_ply")}


def _events(log):
    with open(os.path.join(log, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("dataset,weights_key,d_in", [
    ("semantic3d", "Semantic3D", 6), ("semantickitti", "SemanticKITTI", 3)])
def test_train_takes_the_preset_and_resumes(trees, tmp_path, monkeypatch, dataset,
                                            weights_key, d_in):
    from pointsecguard_tpu_torch.data import class_weights

    keys = []
    real = class_weights.get_class_weights
    monkeypatch.setattr(class_weights, "get_class_weights",
                        lambda key: keys.append(key) or real(key))
    log = str(tmp_path / "log")
    argv = ["--model", "randla", "--device", "cpu", "--randla_dataset", dataset,
            "--randla_dir", trees[dataset], "--log_dir", log, "--randla_points", "512",
            "--batch_size", "2", "--steps_per_epoch", "2", "--val_steps", "1"]
    train_cli.main(argv + ["--epochs", "1"])
    train_cli.main(argv + ["--epochs", "2"])
    assert keys == [weights_key, weights_key]
    epochs = [e for e in _events(log) if e["event"] == "epoch"]
    evals = [e for e in _events(log) if e["event"] == "eval"]
    assert [e["epoch"] for e in epochs] == [e["epoch"] for e in evals] == [0, 1]
    assert all(e["batches"] == 2 and np.isfinite(e["loss"]) for e in epochs)
    assert all(0.0 <= e["accuracy"] <= 1.0 for e in evals)
    latest = CheckpointManager(os.path.join(log, "checkpoints")).restore_latest()
    assert latest["epoch"] == 2 and latest["step"] == 4
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint

    sd = load_checkpoint(log)
    assert sd["fc0.weight"].shape == (8, d_in)
    assert sd["fc.weight"].shape[0] == randla.randla_dataset_preset(dataset).num_classes


def _jax_weights(trees, dataset):
    """The narrow model initialised by the JAX package and saved by its own
    CheckpointManager; the same weights as the port's checkpoint. BatchNorm
    statistics from one train-mode forward over a validation sample (keep
    fraction 0) make the predictions vary."""
    from pointsecguard_tpu.models import RandLANet as JaxRandLANet
    from pointsecguard_tpu.models import build_pyramid as jax_build_pyramid
    from pointsecguard_tpu.train import create_train_state
    from pointsecguard_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
    from pointsecguard_tpu_torch.models import RandLANet
    from pointsecguard_tpu_torch.train.trainer import randla_family

    mp = pytest.MonkeyPatch()
    _narrow(mp)
    preset = randla.randla_dataset_preset(dataset)
    d_in = 6 if preset.has_colors else 3
    model = JaxRandLANet(num_classes=preset.num_classes, d_out=NARROW["d_out"])
    pyramid = jax.jit(lambda x: jax_build_pyramid(
        x, num_layers=2, sub_ratios=NARROW["sub_sampling_ratio"], knn_tile=None))
    state, _ = create_train_state(model, (jnp.zeros((1, 512, d_in)), None),
                                  rng=jax.random.PRNGKey(0),
                                  model_args=lambda f: (f, pyramid(f[..., :3])))
    flat = flatten_dict({"params": state.params, "batch_stats": state.batch_stats}, sep="/")
    port = RandLANet(num_classes=preset.num_classes, d_out=NARROW["d_out"], d_in=d_in)
    port.load_state_dict(randla_from_jax_variables({k: np.asarray(v) for k, v in flat.items()}))
    sampler = preset.make_sampler(trees[dataset], "test", 512, np.random.default_rng(1))
    feats = torch.from_numpy(next(sampler.batches(2, 1))[1])
    port.train()
    with torch.no_grad():
        port(feats, randla_family(preset.cfg).plan(feats), momentum=0.0)
    stats = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in randla_to_jax_variables(
        port.state_dict()).items() if k.startswith("batch_stats/")}
    state = state.replace(batch_stats=unflatten_dict(stats, sep="/"))
    jlog, tlog = trees["root"] / f"jax_{dataset}", trees["root"] / f"port_{dataset}"
    JaxCheckpointManager(str(jlog / "checkpoints")).save(1, state, miou=0.1)
    save_checkpoint(str(tlog), port.state_dict())
    mp.undo()
    return jlog, tlog


@pytest.fixture(scope="module")
def weights(trees):
    return {d: _jax_weights(trees, d) for d in CONFIGS}


@pytest.mark.parametrize("dataset", ["semantic3d", "semantickitti"])
def test_eval_matches_the_jax_eval(trees, weights, dataset):
    """Voting of 6 samples of 512 points; Semantic3D reprojects through
    ``_proj.pkl``, SemanticKITTI scores at sub-cloud resolution; ignored
    points are left out of both. The float32 softmaxes differ in summation
    order only, so the metrics agree to 2e-3."""
    from pointsecguard_tpu.cli import eval as jax_eval_cli

    jlog, tlog = weights[dataset]
    argv = ["--model", "randla", "--randla_dataset", dataset, "--randla_dir", trees[dataset],
            "--randla_points", "512", "--num_clouds", "6", "--batch_size", "2", "--seed", "3"]
    want = jax_eval_cli.main(argv + ["--log_dir", str(jlog)])
    got = eval_cli.main(argv + ["--log_dir", str(tlog), "--device", "cpu"])
    assert got.class_iou.shape == (randla.randla_dataset_preset(dataset).num_classes,)
    assert got.accuracy == pytest.approx(float(want.accuracy), abs=2e-3)
    assert got.miou == pytest.approx(float(want.miou), abs=2e-3)
    np.testing.assert_allclose(got.class_iou, np.asarray(want.class_iou), atol=5e-3)
    assert 0.0 < got.accuracy < 1.0


def test_semantic3d_save_preds_then_cv6fold(trees, weights, tmp_path, capsys):
    """The prediction PLYs cover the 0.01-grid original clouds and, scored
    in Semantic3D's label space (ignored points left out), give eval's own
    figures; cv6fold, S3DIS's 13-class scorer as in the JAX package, prints
    what the JAX cv6fold prints on the same PLYs."""
    from pointsecguard_tpu.cli import cv6fold as jax_cv6fold

    _, tlog = weights["semantic3d"]
    preds = tmp_path / "preds"
    m = eval_cli.main(["--model", "randla", "--device", "cpu", "--randla_dataset",
                       "semantic3d", "--randla_dir", trees["semantic3d"], "--log_dir",
                       str(tlog), "--randla_points", "512", "--num_clouds", "6",
                       "--batch_size", "2", "--save_preds", str(preds)])
    name = "bildstein_station3_xyz_intensity_rgb.ply"
    assert os.listdir(preds) == [name]
    original = read_ply(os.path.join(trees["original"], name))
    pred = read_ply(str(preds / name))["pred"]
    assert len(pred) == len(original)
    valid, y = randla.randla_dataset_preset("semantic3d").reduce(original["class"])
    assert not valid.all()
    assert np.mean(pred[valid] == y[valid]) == pytest.approx(m.accuracy, abs=1e-12)
    argv = ["--results_dir", str(preds), "--original_dir", trees["original"]]
    capsys.readouterr()
    cv6fold.main(argv)
    ours = capsys.readouterr().out
    jax_cv6fold.main(argv)
    assert ours == capsys.readouterr().out


def _jax_randla_header() -> str:
    from pointsecguard_tpu.cli import _attack_randla

    src = inspect.getsource(_attack_randla.run_randla)
    return re.search(r'header = "([^"]+)"', src).group(1).encode().decode("unicode_escape")


def _read_tsv(path):
    lines = path.read_text().splitlines()
    return lines[0], [line.split("\t") for line in lines[1:]]


def test_semantic3d_nb_matches_the_jax_driver_and_keeps_ignored_colours(trees, weights):
    """NB on 4 clouds at batch 2: the same clouds and clean accuracies
    (over the valid points) as the JAX driver; the saved adversarial
    clouds leave every ignored point's colour as it was, and ``--adv_set``
    scores them as the attack run did."""
    from pointsecguard_tpu.cli import attack as jax_attack_cli

    jlog, tlog = weights["semantic3d"]
    argv = ["--model", "randla", "--attack", "nb", "--randla_dataset", "semantic3d",
            "--randla_dir", trees["semantic3d"], "--randla_points", "512", "--num_clouds",
            "4", "--batch_size", "2"]
    jax_attack_cli.main(argv + ["--log_dir", str(jlog)])
    _, adv_m = attack_cli.main(argv + ["--log_dir", str(tlog), "--device", "cpu",
                                       "--save_adv"])
    jheader, jrows = _read_tsv(jlog / "randla_nb_area5.tsv")
    header, rows = _read_tsv(tlog / "randla_nb_area5.tsv")
    assert header == jheader == _jax_randla_header()
    assert len(rows) == len(jrows) == 4
    for r, jr in zip(rows, jrows):
        assert r[0] == jr[0] and r[1] == jr[1]  # the same clouds, the same clean accuracy
        assert r[5] == "10" and all(np.isfinite(float(x)) for x in r[1:])
        assert 0.0 < float(r[3]) <= 17.0 + 1e-3  # the ε=17 L2 budget

    sampler = randla.randla_dataset_preset("semantic3d").make_sampler(
        trees["semantic3d"], "test", 512, np.random.default_rng(0))
    clean = np.concatenate([f for _, f, _, _, _ in sampler.batches(2, 2)])
    with np.load(tlog / "randla_nb_adv_area5.npz") as npz:
        adv, labels = npz["points"], npz["labels"]
    ignored = labels == 0
    assert ignored.any() and (~ignored).any()
    np.testing.assert_array_equal(adv[ignored], clean[ignored])
    assert not np.array_equal(adv[~ignored], clean[~ignored])
    np.testing.assert_array_equal(adv[..., :3], clean[..., :3])

    m = eval_cli.main(["--model", "randla", "--device", "cpu", "--randla_dataset",
                       "semantic3d", "--log_dir", str(tlog), "--adv_set",
                       str(tlog / "randla_nb_adv_area5.npz"), "--batch_size", "2"])
    assert m.accuracy == pytest.approx(adv_m.accuracy, abs=1e-6)
    assert m.miou == pytest.approx(adv_m.miou, abs=1e-6)


def test_semantic3d_tar_nb_takes_raw_labels_and_refuses_ignored_ones(trees, weights):
    """``--origin`` / ``--target`` are raw Semantic3D labels: an ignored one
    is refused in the JAX driver's words; valid ones attack a cloud with
    500 origin points or more."""
    from pointsecguard_tpu.cli import attack as jax_attack_cli

    jlog, tlog = weights["semantic3d"]
    argv = ["--model", "randla", "--attack", "tar_nb", "--randla_dataset", "semantic3d",
            "--randla_dir", trees["semantic3d"], "--randla_points", "2048",
            "--num_clouds", "1"]
    for origin, target in (("0", "5"), ("1", "0"), ("9", "5")):
        flags = ["--origin", origin, "--target", target]
        with pytest.raises(SystemExit) as want:
            jax_attack_cli.main(argv + flags + ["--log_dir", str(jlog)])
        with pytest.raises(SystemExit) as got:
            attack_cli.main(argv + flags + ["--log_dir", str(tlog), "--device", "cpu"])
        assert str(got.value) == str(want.value) and "label(s) {0} are ignored" in str(got.value)
    attack_cli.main(argv + ["--origin", "1", "--target", "5", "--log_dir", str(tlog),
                            "--device", "cpu"])
    header, rows = _read_tsv(tlog / "randla_tar_nb_area5.tsv")
    assert header == _jax_randla_header() and len(rows) == 1
    assert 1 <= int(rows[0][5]) <= 20 and 0.0 <= float(rows[0][4]) <= 1.0


def test_semantickitti_attack_is_refused_in_the_jax_drivers_words(trees, weights):
    from pointsecguard_tpu.cli import attack as jax_attack_cli

    jlog, tlog = weights["semantickitti"]
    argv = ["--model", "randla", "--attack", "nb", "--randla_dataset", "semantickitti",
            "--randla_dir", trees["semantickitti"], "--randla_points", "512"]
    with pytest.raises(SystemExit) as want:
        jax_attack_cli.main(argv + ["--log_dir", str(jlog)])
    with pytest.raises(SystemExit) as got:
        attack_cli.main(argv + ["--log_dir", str(tlog), "--device", "cpu"])
    assert str(got.value) == str(want.value) and "xyz-only" in str(got.value)
