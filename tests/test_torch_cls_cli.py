"""The port's classification path through its CLIs on the CPU (``--device
cpu``): ``cli.train`` → ``cli.eval`` → ``cli.attack_object`` →
``cli.benchmark --task cls`` on the 4-class synthetic ModelNet (256-point
shapes, 128 of them loaded; two train and two test shapes a class, so that
the CPU's plain path stays quick), and the flags and models that stay
refused.

``cli.eval`` is held to the trainer's own figure and to the JAX package's
``evaluate_cls`` over the JAX classifier on the same weights (carried back
through ``utils/convert.py``); the attack TSV's clean predictions to that
JAX model's argmax, shape by shape."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from pointsecguard_tpu.data.modelnet import ModelNetDataset as JaxModelNet
from pointsecguard_tpu.models import PointNet2ClsMSG as JaxMSG
from pointsecguard_tpu.models import PointNet2ClsSSG as JaxSSG
from pointsecguard_tpu.models import PointNetCls as JaxPointNetCls
from pointsecguard_tpu.train.object_eval import evaluate_cls as jax_evaluate_cls
from pointsecguard_tpu_torch.cli import attack_object as attack_cli
from pointsecguard_tpu_torch.cli import benchmark as bench_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data.modelnet import make_synthetic_modelnet
from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint
from pointsecguard_tpu_torch.utils.convert import cls_to_jax_variables

NPOINT = 128
_JAX = {"pointnet2_cls": JaxSSG, "pointnet2_cls_msg": JaxMSG, "pointnet_cls": JaxPointNetCls}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _events(log):
    with open(os.path.join(log, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The fixture and a log dir per classifier: SSG trained 2 epochs (an
    eval after the 2nd) and resumed for a 3rd (an eval after the last),
    MSG and PointNet one epoch each; 2 steps of 4 shapes an epoch."""
    root = tmp_path_factory.mktemp("cls")
    data = str(root / "mn")
    make_synthetic_modelnet(data, points_per_shape=256, train_per_class=2, test_per_class=2,
                            seed=4)
    logs = {}

    def train(model, epochs):
        logs[model] = str(root / model)
        train_cli.main(["--device", "cpu", "--model", model, "--data_root", data,
                        "--log_dir", logs[model], "--npoint", str(NPOINT), "--batch_size", "4",
                        "--epochs", str(epochs), "--eval_every", "2",
                        "--learning_rate", "0.003"])

    for model, epochs in (("pointnet2_cls", 2), ("pointnet2_cls_msg", 1), ("pointnet_cls", 1),
                          ("pointnet2_cls", 3)):
        train(model, epochs)
    return {"data": data, "logs": logs}


def test_training_epochs_evals_and_resume(trained):
    ev = _events(trained["logs"]["pointnet2_cls"])
    epochs = [e["epoch"] for e in ev if e["event"] == "epoch"]
    evals = [e for e in ev if e["event"] == "eval"]
    assert epochs == [0, 1, 2]  # the resumed run repeats none
    assert [e["epoch"] for e in evals] == [1, 2]
    assert all(e["batches"] == 2 and np.isfinite(e["loss"]) for e in ev if e["event"] == "epoch")
    for model in ("pointnet2_cls_msg", "pointnet_cls"):
        ev = _events(trained["logs"][model])
        assert [e["event"] for e in ev] == ["epoch", "eval"]


def _jax_logp(model, log, normals=True):
    sd = load_checkpoint(log)
    flat = cls_to_jax_variables(model, sd)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    net = _JAX[model](num_classes=4, normal_channel=normals)
    return jax.jit(lambda p: net.apply(variables, p)[0])


@pytest.mark.parametrize("model", sorted(_JAX))
def test_eval_matches_the_trainer_and_jax(trained, model, capsys):
    """The trainer's last eval figure, and JAX's ``evaluate_cls`` over the
    JAX classifier on the same weights (3 votes, the same subsets)."""
    log = trained["logs"][model]
    inst, cls_acc = eval_cli.main(["--device", "cpu", "--model", model,
                                   "--data_root", trained["data"], "--log_dir", log,
                                   "--num_point", str(NPOINT), "--batch_size", "4",
                                   "--num_votes", "1"])
    assert inst == pytest.approx(_events(log)[-1]["instance_accuracy"], abs=1e-12)
    inst3, cls3 = eval_cli.main(["--device", "cpu", "--model", model,
                                 "--data_root", trained["data"], "--log_dir", log,
                                 "--num_point", str(NPOINT), "--batch_size", "3",
                                 "--num_votes", "3", "--seed", "2"])
    ds = JaxModelNet(trained["data"], "test", num_point=NPOINT)
    want = jax_evaluate_cls(_jax_logp(model, log), ds, batch_size=3, num_votes=3,
                            rng=np.random.default_rng(2))
    assert (inst3, cls3) == pytest.approx(want[:2], abs=1e-12)
    assert "CLS instance accuracy" in capsys.readouterr().err


def _attack(trained, *flags, model="pointnet2_cls"):
    return attack_cli.main(["--device", "cpu", "--model", model, "--data_root",
                            trained["data"], "--log_dir", trained["logs"][model],
                            "--num_point", str(NPOINT), "--batch_size", "4", *flags])


def _tsv(path):
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t")
        return head, [line.rstrip("\n").split("\t") for line in f]


def test_attack_object_nb_with_control(trained, capsys):
    """8 shapes in two batches; NB moves xyz only, within ε = 0.05 (L∞);
    the clean predictions are the JAX model's argmax."""
    out = _attack(trained, "--attack", "nb", "--iters", "2", "--control")
    head, rows = _tsv(out["tsv"])
    assert head == ["idx", "label", "clean_pred", "adv_pred", "l2", "rand_pred"]
    assert [int(r[0]) for r in rows] == list(range(8))
    ds = JaxModelNet(trained["data"], "test", num_point=NPOINT)
    pts = np.stack([ds.load(i)[0] for i in range(8)])
    want = np.argmax(np.asarray(_jax_logp("pointnet2_cls", trained["logs"]["pointnet2_cls"])(
        jnp.asarray(pts))), -1)
    np.testing.assert_array_equal([int(r[2]) for r in rows], want)
    l2 = np.array([float(r[4]) for r in rows])
    assert (l2 > 0).all() and (l2 <= 0.05 * np.sqrt(3 * NPOINT) + 1e-6).all()
    assert "rand-noise acc" in capsys.readouterr().err and len(out["batch_ms"]) == 2


@pytest.mark.parametrize("flags", [
    ["--attack", "nb", "--iters", "1", "--fixed_geometry"],
    ["--attack", "tar_nb", "--iters", "1", "--target", "1"],
    ["--attack", "nu", "--steps", "1"],
    ["--attack", "tar_nu", "--steps", "1", "--target", "2"],
    ["--attack", "nb", "--iters", "1", "--defense", "sor"],
    ["--attack", "nb", "--iters", "1", "--defense", "srs", "--eot", "2"],
], ids=" ".join)
def test_attack_object_flags(trained, flags, capsys):
    out = _attack(trained, *flags, "--max_shapes", "4")
    _, rows = _tsv(out["tsv"])
    assert len(rows) == 4 and all(len(r) == 5 for r in rows)
    assert np.isfinite(out["l2_mean"]) and out["l2_mean"] > 0
    if flags[1].startswith("tar_"):
        assert "target success" in capsys.readouterr().err


def test_attack_object_random_noise_norm(trained):
    out = _attack(trained, "--attack", "random", "--noise_norm", "0.5", "--max_shapes", "6",
                  model="pointnet_cls")
    _, rows = _tsv(out["tsv"])
    assert len(rows) == 6 and {r[4] for r in rows} == {"0.500000"}


@pytest.mark.parametrize("model", ["pointnet2_cls_msg", "pointnet_cls"])
def test_attack_object_other_classifiers(trained, model):
    out = _attack(trained, "--attack", "nb", "--iters", "1", "--max_shapes", "4", model=model)
    assert len(_tsv(out["tsv"])[1]) == 4 and out["l2_mean"] > 0


def test_attack_object_eot_needs_srs(trained):
    with pytest.raises(SystemExit, match="--eot requires the randomized srs"):
        _attack(trained, "--defense", "sor", "--eot", "2")


_BUDGET = ["--iters", "1", "--samples", "2", "--cw_steps", "1", "--init_tries", "2"]


@pytest.mark.parametrize("name", ["fgsm", "bim", "pgd", "mim", "cw", "deepfool", "nes", "spsa",
                                  "nattack", "boundary", "evolutionary"])
def test_benchmark_cls_every_registry_name(trained, name):
    """ares' five arrays, one entry a shape, distortions on xyz only."""
    acc, acc_adv, total, succ, dist = bench_cli.main([
        "--device", "cpu", "--task", "cls", "--model", "pointnet2_cls",
        "--data_root", trained["data"], "--log_dir", trained["logs"]["pointnet2_cls"],
        "--num_point", str(NPOINT), "--batch_size", "4", "--max_blocks", "4",
        "--attack_name", name, *_BUDGET])
    assert acc.shape == acc_adv.shape == total.shape == succ.shape == dist.shape == (4,)
    assert np.isfinite(dist).all()


@pytest.mark.parametrize("flags", [
    ["--mode", "distortion", "--attack_name", "boundary"],
    ["--mode", "iteration", "--attack_name", "deepfool"],
    ["--mode", "attack", "--attack_name", "evolutionary", "--goal", "t", "--target", "1"],
    ["--mode", "worstcase", "--attack_names", "fgsm,deepfool"],
    ["--mode", "prediction"],
], ids=" ".join)
def test_benchmark_cls_modes(trained, flags, tmp_path):
    extra = ["--output", str(tmp_path / "p.npz")] if "prediction" in flags else []
    out = bench_cli.main([
        "--device", "cpu", "--task", "cls", "--model", "pointnet2_cls",
        "--data_root", trained["data"], "--log_dir", trained["logs"]["pointnet2_cls"],
        "--num_point", str(NPOINT), "--batch_size", "4", "--max_blocks", "4",
        *_BUDGET, *flags, *extra])
    assert out is not None


@pytest.mark.parametrize("cli,flags", [
    (attack_cli, ["--model", "pointnet2_part_seg"]),
    (attack_cli, ["--model", "pointnet_part_seg"]),
    (attack_cli, ["--model", "pointnet2_part_seg_msg"]),
    (attack_cli, ["--origin", "3"]),
    (attack_cli, ["--devices", "2"]),
    (attack_cli, ["--precision", "bfloat16"]),
    (train_cli, ["--model", "pointnet2_part_seg_msg"]),
    (train_cli, ["--model", "pointnet_cls", "--devices", "2"]),
    (train_cli, ["--model", "pointnet2_cls_msg", "--precision", "bfloat16"]),
    (train_cli, ["--model", "pointnet2", "--no_normals"]),
    (eval_cli, ["--model", "pointnet2_part_seg"]),
    (eval_cli, ["--model", "pointnet2_cls", "--precision", "bfloat16"]),
    (eval_cli, ["--model", "resgcn", "--num_category", "10"]),
], ids=lambda v: v if isinstance(v, str) else None)
def test_refused_flags_and_part_seg_models(cli, flags, tmp_path):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["--device", "cpu", "--log_dir", str(tmp_path), *flags])


def test_every_flag_of_the_jax_attack_object_cli_is_accepted():
    import argparse

    from pointsecguard_tpu.cli import attack_object as jax_attack_object

    def names(parser: argparse.ArgumentParser):
        return {s for a in parser._actions for s in a.option_strings if s.startswith("--")}

    jax_flags = names(jax_attack_object._build_argparser())
    assert jax_flags <= names(attack_cli._parser())
    assert names(attack_cli._parser()) - jax_flags == {"--device"}


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attack_cli.main(["--data_root", str(tmp_path), "--log_dir", str(tmp_path)])
