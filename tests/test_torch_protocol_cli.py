"""The reference's protocol flags through the port's ``cli.attack`` and
``cli.eval`` on the CPU: ``--attack random``, ``--control``,
``--log_steps``, ``--visual``, ``--defense`` / ``--eot`` (every reported
prediction the deployed defense's forward on the adversarial points),
``--resgcn_fixed_graphs``, RandLA's cloud loop with them, ``cli.eval
--visual`` / ``--save_preds``, and the flags that stay refused."""

import argparse
import functools
import inspect
import os
import re

import flax.serialization
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu_torch import configs as tconfigs
from pointsecguard_tpu_torch.cli import attack as attack_cli
from pointsecguard_tpu_torch.cli import eval as eval_cli
from pointsecguard_tpu_torch.cli._attack_common import defense_wrapper
from pointsecguard_tpu_torch.data import make_synthetic_rooms, randla
from pointsecguard_tpu_torch.models import (
    DenseDeepGCN,
    PointNet2SemSegSSG,
    RandLANet,
    build_geometry,
    build_pyramid,
)
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.convert import from_jax_variables

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL_RESGCN = ["--resgcn_blocks", "2", "--resgcn_filters", "8", "--resgcn_k", "4"]


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
def ssg_run(tmp_path_factory):
    """Synthetic rooms and the trained PointNet++ SSG fixture as the port's
    checkpoint; ``run(*flags)`` attacks one batch of 8 blocks of 128 points
    in a log dir of its own."""
    root = tmp_path_factory.mktemp("protocol")
    make_synthetic_rooms(str(root / "data"), points_per_room=6000, seed=0)
    with open(os.path.join(FIXDIR, "trained_pointnet2.msgpack"), "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    model = PointNet2SemSegSSG()
    model.load_state_dict(from_jax_variables(
        {k: np.asarray(v) for k, v in flatten_dict(raw, sep="/").items()}))
    model.eval().requires_grad_(False)

    def run(name, *flags, blocks=8):
        log = root / name
        save_checkpoint(str(log), model.state_dict())
        out = attack_cli.main(["--device", "cpu", "--data_root", str(root / "data"),
                               "--log_dir", str(log), "--num_point", "128",
                               "--batch_size", "8", "--max_blocks", str(blocks), *flags])
        return log, out

    return {"run": run, "model": model, "data": str(root / "data")}


def _read_tsv(path):
    with open(path) as f:
        lines = [line.rstrip("\n").split("\t") for line in f]
    return "\t".join(lines[0]), lines[1:]


def _jax_header(module) -> str:
    src = inspect.getsource(module)
    return re.search(r'header = "([^"]+)"', src).group(1).encode().decode("unicode_escape")


def test_random_attack_l2_is_the_noise_norm(ssg_run):
    log, _ = ssg_run["run"]("random", "--attack", "random", "--noise_norm", "1.0", "--control")
    header, rows = _read_tsv(log / "pointnet2_random_area5.tsv")
    assert not header.endswith("rand_acc")  # --control is a no-op for the noise itself
    assert len(rows) == 8
    assert all(r[4] == "1.0000" and r[7] == "0" for r in rows)
    assert not os.path.exists(log / "pointnet2_random_area5_steps.tsv")


def test_control_and_log_steps(ssg_run):
    from pointsecguard_tpu.cli import _attack_blocks

    log, _ = ssg_run["run"]("nb", "--control", "--log_steps", "--batch_size", "4")
    header, rows = _read_tsv(log / "pointnet2_nb_area5.tsv")
    assert header == _jax_header(_attack_blocks) + "\trand_acc"
    assert len(rows) == 8
    adv = np.mean([float(r[3]) for r in rows])
    rand = np.mean([float(r[9]) for r in rows])
    assert adv < rand  # the attack beats its equal-norm control on the trained net
    assert all(0.0 <= float(r[9]) <= 1.0 for r in rows)
    steps_header, steps = _read_tsv(log / "pointnet2_nb_area5_steps.tsv")
    assert steps_header == "room\tblock\titer\tacc\tsr\tl2"
    assert len(steps) == 2 * 10  # two batches, the preset's 10 iterations each
    assert [int(r[2]) for r in steps] == list(range(10)) * 2
    assert [int(r[1]) for r in steps] == [0] * 10 + [4] * 10
    # the last step's mean L2 is the batch's TSV mean
    np.testing.assert_allclose(float(steps[9][5]), np.mean([float(r[4]) for r in rows[:4]]),
                               atol=2e-4)


def test_visual_writes_the_room_artifacts(ssg_run):
    log, _ = ssg_run["run"]("visual", "--visual")
    files = sorted(os.listdir(log / "visual"))
    base = "Area_5_synth_1.npy_nb"
    assert files == sorted(f"{base}{s}" for s in (
        "_adv.html", "_adv_raw.xyzrgb", "_gt.xyzrgb", "_pred.html", "_pred.xyzrgb",
        "_raw.xyzrgb"))
    raw = np.loadtxt(log / "visual" / f"{base}_raw.xyzrgb")
    adv = np.loadtxt(log / "visual" / f"{base}_adv_raw.xyzrgb")
    assert raw.shape == adv.shape and raw.shape[1] == 6
    np.testing.assert_array_equal(raw[:, :3], adv[:, :3])
    assert (raw[:, 3:] != adv[:, 3:]).any(axis=1).sum() > 100  # attacked points recoloured


@pytest.mark.parametrize("flags", [
    ["--defense", "bit_depth"],
    ["--defense", "jitter", "--eot", "2", "--control"],
], ids=["bit_depth", "jitter eot 2"])
def test_reported_predictions_come_from_the_deployed_defense(ssg_run, flags):
    """Each row's adv_acc equals an independent forward of the deployed
    defense on the saved adversarial points: the adversarial prediction
    does not come from the attack's own closure (under EoT the two
    differ)."""
    name = "def_" + flags[1]
    log, _ = ssg_run["run"](name, "--save_adv", *flags)
    _, rows = _read_tsv(log / "pointnet2_nb_area5.tsv")
    saved = np.load(log / "pointnet2_nb_adv_area5.npz")
    pts, labels = torch.from_numpy(saved["points"]), saved["labels"]
    args = argparse.Namespace(defense=flags[1], eot=2 if "--eot" in flags else 1, seed=0,
                              defense_bits=4, defense_sigma=0.02, defense_quality=95,
                              defense_knn=8)
    eval_wrap, _ = defense_wrapper(args)
    geo = build_geometry(pts[..., :3])
    with torch.no_grad():
        pred = torch.argmax(eval_wrap(lambda p: ssg_run["model"](p, geometry=geo)[0])(pts),
                            dim=-1).numpy()
    want = [f"{(pred[b] == labels[b]).mean():.4f}" for b in range(len(rows))]
    assert [r[3] for r in rows] == want


def test_eot_needs_a_randomized_defense(ssg_run):
    from pointsecguard_tpu.cli._attack_common import defense_wrapper as jax_wrapper

    with pytest.raises(SystemExit) as want:
        jax_wrapper(argparse.Namespace(defense="jpeg", eot=2), None)
    with pytest.raises(SystemExit) as got:
        ssg_run["run"]("eot", "--eot", "2", "--defense", "jpeg")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", [
    # --ensemble / --ensemble_mode are ported: tests/test_torch_ensemble.py
    ["--devices", "4"], ["--model", "randla", "--resgcn_fast"], ["--resgcn_fast"],
    ["--model", "resgcn", "--resgcn_fast"], ["--devices", "2"], ["--shard_points", "2"],
    ["--precision", "bfloat16"], ["--resgcn_fixed_graphs"],
])
def test_flags_still_refused(flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        attack_cli.main(["--device", "cpu"] + flags)


@pytest.mark.parametrize("flags,attr,value", [
    (["--attack", "random"], "attack", "random"), (["--noise_norm", "17"], "noise_norm", 17.0),
    (["--control"], "control", True), (["--log_steps"], "log_steps", True),
    (["--visual"], "visual", True), (["--defense", "resample"], "defense", "resample"),
    (["--defense_knn", "64"], "defense_knn", 64), (["--eot", "4"], "eot", 4),
    (["--defense_quality", "10"], "defense_quality", 10),
    (["--defense_sigma", "0.1"], "defense_sigma", 0.1), (["--defense_bits", "3"], "defense_bits", 3),
    (["--model", "resgcn", "--resgcn_fixed_graphs"], "resgcn_fixed_graphs", True),
])
def test_protocol_flags_are_taken(flags, attr, value):
    args = attack_cli._parser().parse_args(flags)
    attack_cli._refuse_unported(args)
    assert getattr(args, attr) == value


def test_protocol_flag_defaults_equal_jax():
    from pointsecguard_tpu.cli import attack as jax_attack

    src = inspect.getsource(jax_attack.main)
    args = attack_cli._parser().parse_args([])
    for flag in ("defense_bits", "defense_sigma", "defense_quality", "defense_knn", "eot",
                 "noise_norm"):
        m = re.search(rf'"--{flag}", type=\w+, default=([\d.]+)', src)
        assert float(m.group(1)) == getattr(args, flag), flag
    assert args.defense == "none"


# --- ResGCN's fixed-graph surrogate ------------------------------------------

def test_resgcn_fixed_graphs(ssg_run, tmp_path):
    """The surrogate's logits on the clean input equal the dynamic model's;
    every reported adversarial prediction is the dynamic model's forward on
    the adversarial points."""
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks

    torch.manual_seed(0)
    model = DenseDeepGCN(n_blocks=2, n_filters=8, k=4).eval().requires_grad_(False)
    save_checkpoint(str(tmp_path), model.state_dict())
    attack_cli.main(["--device", "cpu", "--model", "resgcn", "--resgcn_fixed_graphs",
                     "--save_adv", "--data_root", ssg_run["data"], "--log_dir", str(tmp_path),
                     "--num_point", "128", "--batch_size", "8", "--max_blocks", "8"]
                    + SMALL_RESGCN)
    _, rows = _read_tsv(tmp_path / "resgcn_nb_area5.tsv")
    saved = np.load(tmp_path / "resgcn_nb_adv_area5.npz")
    with torch.no_grad():
        pred = torch.argmax(model(torch.from_numpy(saved["points"])), dim=-1).numpy()
    assert [r[3] for r in rows] == [f"{(pred[b] == saved['labels'][b]).mean():.4f}"
                                    for b in range(8)]
    assert all(r[7] == "50" for r in rows)
    rooms = RoomSet.load(ssg_run["data"], "test", 5)
    clean = WholeSceneBlocks(rooms, block_points=128).room_blocks(
        0, np.random.default_rng(0))[0][:8]
    with torch.no_grad():
        dynamic, graphs = model(torch.from_numpy(clean), collect_graphs=True)
        surrogate = model(torch.from_numpy(clean), graphs=graphs)
    assert torch.equal(surrogate, dynamic)


# --- RandLA-Net ----------------------------------------------------------------

NARROW = {"d_out": (8, 16), "num_layers": 2, "sub_sampling_ratio": (4, 4)}


def test_randla_protocol_flags_then_eval_visual_and_save_preds(tmp_path, monkeypatch):
    from pointsecguard_tpu.cli import _attack_randla
    from pointsecguard_tpu_torch.data.ply import read_ply

    monkeypatch.setattr(tconfigs, "RandlaConfig",
                        functools.partial(tconfigs.RandlaConfig, **NARROW))
    make_synthetic_rooms(str(tmp_path / "rooms"), points_per_room=6000, seed=2)
    for name in sorted(os.listdir(tmp_path / "rooms")):
        randla.prepare_room(str(tmp_path / "rooms" / name), str(tmp_path / "prep"), 0.1)
    torch.manual_seed(0)
    model = RandLANet(d_out=NARROW["d_out"]).eval().requires_grad_(False)
    log = tmp_path / "log"
    save_checkpoint(str(log), model.state_dict())
    base = ["--model", "randla", "--device", "cpu", "--randla_dir", str(tmp_path / "prep"),
            "--log_dir", str(log), "--randla_points", "512"]
    attack_cli.main(base + ["--num_clouds", "2", "--batch_size", "2", "--defense", "resample",
                            "--control", "--log_steps", "--visual", "--save_adv"])
    header, rows = _read_tsv(log / "randla_nb_area5.tsv")
    assert header == _jax_header(_attack_randla) + "\trand_acc" and len(rows) == 2
    steps_header, steps = _read_tsv(log / "randla_nb_area5_steps.tsv")
    assert steps_header == "cloud\titer\tacc\tsr\tl2" and len(steps) == 2 * 10
    # the last step's L2 per cloud is the TSV's
    assert [steps[9][4], steps[19][4]] == [rows[0][3], rows[1][3]]
    # adv_acc: the deployed resample defense on the saved clouds
    saved = np.load(log / "randla_nb_adv_area5.npz")
    feats = torch.from_numpy(saved["points"])
    eval_wrap, _ = defense_wrapper(argparse.Namespace(
        defense="resample", eot=1, seed=0, defense_knn=8))
    with torch.no_grad():
        pyr = build_pyramid(feats[..., :3], num_layers=2, k=16, sub_ratios=(4, 4))
        pred = torch.argmax(eval_wrap(lambda f: model(f, pyr))(feats), dim=-1).numpy()
    assert [r[2] for r in rows] == [f"{(pred[b] == saved['labels'][b]).mean():.4f}"
                                    for b in range(2)]
    vis = sorted(os.listdir(log / "visual"))
    assert {f"cloud{r[0]}_nb{s}" for r in rows for s in (
        "_raw.xyzrgb", "_adv_raw.xyzrgb", "_pred.xyzrgb", "_gt.xyzrgb", "_adv.html")} == set(vis)

    eval_cli.main(base + ["--num_clouds", "4", "--visual", "--save_preds",
                          str(tmp_path / "preds")])
    (ply,) = os.listdir(tmp_path / "preds")
    name = ply[: -len(".ply")]
    pred_full = read_ply(str(tmp_path / "preds" / ply))["pred"]
    with open(tmp_path / "prep" / f"{name}_proj.pkl", "rb") as f:
        import pickle

        proj_idx, full_labels = pickle.load(f)
    assert len(pred_full) == len(full_labels) and pred_full.max() < 13
    assert {f"{name}_pred.xyzrgb", f"{name}_gt.xyzrgb", f"{name}_pred.html"} <= set(
        os.listdir(log / "visual"))


def test_eval_visual_for_the_block_models(ssg_run, tmp_path):
    """``cli.eval --visual`` writes each room's label clouds and viewer."""
    log, _ = ssg_run["run"]("eval_visual", "--attack", "random")
    data = os.path.join(os.path.dirname(log), "data")
    eval_cli.main(["--device", "cpu", "--data_root", data, "--log_dir", str(log),
                   "--num_point", "128", "--batch_size", "8", "--num_votes", "1", "--visual"])
    assert {"Area_5_synth_1.npy_pred.xyzrgb", "Area_5_synth_1.npy_gt.xyzrgb",
            "Area_5_synth_1.npy_pred.html"} <= set(os.listdir(log / "visual"))
