"""The port's RandLA-Net attack CLI on the CPU against the JAX driver, and
its guards (unported flags, batch rules, no card)."""

import dataclasses
import functools
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu import attacks as jattacks
from pointsecguard_tpu import configs as jconfigs
from pointsecguard_tpu.models import RandLANet as JaxRandLANet
from pointsecguard_tpu.models import build_pyramid as jax_build_pyramid
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch import configs as tconfigs
from pointsecguard_tpu_torch.cli import attack as tcli
from pointsecguard_tpu_torch.data import make_synthetic_rooms, randla
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.convert import randla_from_jax_variables

NARROW = {"d_out": (8, 16), "num_layers": 2, "sub_sampling_ratio": (4, 4)}


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
def prepared(tmp_path_factory):
    root = tmp_path_factory.mktemp("randla_cli")
    make_synthetic_rooms(str(root / "rooms"), points_per_room=6000, seed=2)
    for name in sorted(os.listdir(root / "rooms")):
        randla.prepare_room(str(root / "rooms" / name), str(root / "port"), 0.1)
    return root


def _jax_randla_header() -> str:
    from pointsecguard_tpu.cli import _attack_randla

    src = inspect.getsource(_attack_randla.run_randla)
    return re.search(r'header = "([^"]+)"', src).group(1).encode().decode("unicode_escape")


@pytest.fixture(scope="module")
def cli_runs(prepared):
    """The JAX driver and the port's on the same prepared clouds and
    weights, both with a narrow two-layer config (the full width only
    makes the CPU run slower)."""
    from pointsecguard_tpu.cli import attack as jcli
    from pointsecguard_tpu.train import create_train_state
    from pointsecguard_tpu.utils.checkpoint import CheckpointManager

    mp = pytest.MonkeyPatch()
    mp.setattr(jconfigs, "RandlaConfig", functools.partial(jconfigs.RandlaConfig, **NARROW))
    mp.setattr(tconfigs, "RandlaConfig", functools.partial(tconfigs.RandlaConfig, **NARROW))
    jmodel = JaxRandLANet(d_out=NARROW["d_out"])
    feats = jnp.zeros((1, 512, 6))
    state, _ = create_train_state(
        jmodel, (feats, None), rng=jax.random.PRNGKey(0),
        model_args=lambda f: (f, jax.jit(lambda x: jax_build_pyramid(
            x, num_layers=2, sub_ratios=NARROW["sub_sampling_ratio"], knn_tile=None))(
                f[..., :3])))
    jlog, tlog = prepared / "jax_log", prepared / "port_log"
    CheckpointManager(str(jlog / "checkpoints")).save(0, state)
    flat = flatten_dict({"params": state.params, "batch_stats": state.batch_stats}, sep="/")
    save_checkpoint(str(tlog), randla_from_jax_variables(
        {k: np.asarray(v) for k, v in flat.items()}))
    argv = ["--model", "randla", "--attack", "nb", "--randla_dir", str(prepared / "port"),
            "--randla_points", "512", "--num_clouds", "2"]
    jcli.main(argv + ["--log_dir", str(jlog)])
    tcli.main(argv + ["--log_dir", str(tlog), "--device", "cpu"])
    mp.undo()
    return jlog, tlog


def _read_tsv(path):
    lines = path.read_text().splitlines()
    return lines[0], [line.split("\t") for line in lines[1:]]


def test_cli_nb_on_cpu_matches_the_jax_driver(cli_runs):
    jlog, tlog = cli_runs
    jheader, jrows = _read_tsv(jlog / "randla_nb_area5.tsv")
    header, rows = _read_tsv(tlog / "randla_nb_area5.tsv")
    assert header == jheader == _jax_randla_header()
    assert len(rows) == len(jrows) == 2
    for r, jr in zip(rows, jrows):
        assert r[0] == jr[0]  # the same clouds
        assert r[1] == jr[1]  # the same clean accuracy
        assert r[5] == "10" and all(np.isfinite(float(x)) for x in r[1:])
        assert float(r[3]) <= 17.0 + 1e-3  # the ε=17 L2 budget


def test_cli_tar_nb_on_cpu_gates_clouds(cli_runs, monkeypatch):
    """tar_NB at batch 1: clouds with fewer than 500 origin points are
    skipped (`tester_S3DIS.py:253-258`), the rest attacked toward the
    target with per-cloud early exit."""
    _, tlog = cli_runs
    monkeypatch.setattr(tconfigs, "RandlaConfig",
                        functools.partial(tconfigs.RandlaConfig, **NARROW))
    argv = ["--model", "randla", "--attack", "tar_nb", "--device", "cpu",
            "--randla_dir", str(tlog.parent / "port"), "--log_dir", str(tlog),
            "--randla_points", "2048", "--num_clouds", "3", "--target", "7"]
    tsv = tlog / "randla_tar_nb_area5.tsv"
    tcli.main(argv + ["--origin", "2"])  # walls: ~a quarter of each cloud
    header, rows = _read_tsv(tsv)
    assert header == _jax_randla_header() and len(rows) == 3
    for r in rows:
        assert 1 <= int(r[5]) <= 20 and 0.0 <= float(r[4]) <= 1.0
    tcli.main(argv + ["--origin", "11"])  # boards: under 500 points per cloud
    assert len(_read_tsv(tsv)[1]) == 0


def _short_presets(mp, attack, **overrides):
    """The C&W preset with its 1000 steps cut, in both packages."""
    for pkg in (jattacks, tattacks):
        key = ("randla", attack)
        mp.setitem(pkg._PRESETS, key, dataclasses.replace(pkg._PRESETS[key], **overrides))


@pytest.fixture(scope="module")
def nu_runs(cli_runs):
    """NU through both drivers on the clouds and weights of ``cli_runs``,
    20 steps without the early exit (the random weights start below its
    1/13 accuracy); the port's with --fused_ap (off the TPU the JAX driver
    runs its reference composition: the two differ by float
    reassociation)."""
    from pointsecguard_tpu.cli import attack as jcli

    jlog, tlog = cli_runs
    mp = pytest.MonkeyPatch()
    mp.setattr(jconfigs, "RandlaConfig", functools.partial(jconfigs.RandlaConfig, **NARROW))
    mp.setattr(tconfigs, "RandlaConfig", functools.partial(tconfigs.RandlaConfig, **NARROW))
    _short_presets(mp, "nu", steps=20, success_acc=0.0)
    argv = ["--model", "randla", "--attack", "nu", "--randla_dir",
            str(tlog.parent / "port"), "--randla_points", "512", "--num_clouds", "2"]
    jcli.main(argv + ["--log_dir", str(jlog)])
    tcli.main(argv + ["--log_dir", str(tlog), "--device", "cpu", "--fused_ap"])
    mp.undo()
    return jlog, tlog


def test_cli_nu_fused_on_cpu_matches_the_jax_driver(nu_runs):
    jlog, tlog = nu_runs
    jheader, jrows = _read_tsv(jlog / "randla_nu_area5.tsv")
    header, rows = _read_tsv(tlog / "randla_nu_area5.tsv")
    assert header == jheader == _jax_randla_header()
    assert len(rows) == len(jrows) == 2
    for r, jr in zip(rows, jrows):
        assert r[0] == jr[0] and r[1] == jr[1]  # the same clouds, clean accuracy
        assert r[5] == jr[5] == "20" and all(np.isfinite(float(x)) for x in r[1:])
        assert float(r[2]) <= float(r[1])  # C&W does not raise the accuracy
        assert float(r[3]) > 0.0  # and moved the colours


def test_cli_tar_nu_fused_on_cpu_gates_clouds(cli_runs, monkeypatch):
    """tar_NU at batch 1 through the fused model: the <500-origin gate,
    then per-cloud exit within the step budget."""
    _, tlog = cli_runs
    monkeypatch.setattr(tconfigs, "RandlaConfig",
                        functools.partial(tconfigs.RandlaConfig, **NARROW))
    _short_presets(monkeypatch, "tar_nu", steps=10)
    tcli.main(["--model", "randla", "--attack", "tar_nu", "--device", "cpu", "--fused_ap",
               "--randla_dir", str(tlog.parent / "port"), "--log_dir", str(tlog),
               "--randla_points", "2048", "--num_clouds", "2", "--origin", "2",
               "--target", "7"])
    header, rows = _read_tsv(tlog / "randla_tar_nu_area5.tsv")
    assert header == _jax_randla_header() and len(rows) == 2
    for r in rows:
        assert 1 <= int(r[5]) <= 10 and 0.0 <= float(r[4]) <= 1.0


@pytest.mark.parametrize("flags", [
    ["--model", "pointnet2", "--fused_ap"], ["--randla_dataset", "semantic3d"],
    ["--shard_points", "2"], ["--precision", "bfloat16"],
    # --ensemble is refused with RandLA in the JAX driver's words: tests/test_torch_ensemble.py
    ["--devices", "2"],
])
def test_unported_randla_flags_are_refused(flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        tcli.main(["--model", "randla", "--device", "cpu"] + flags)


def test_randla_targeted_needs_batch_one(prepared):
    with pytest.raises(SystemExit, match="batch_size 1"):
        tcli.main(["--model", "randla", "--attack", "tar_nb", "--device", "cpu",
                   "--batch_size", "2", "--randla_dir", str(prepared / "port")])


def test_randla_without_a_card_raises(prepared):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--model", "randla", "--randla_dir", str(prepared / "port"),
                   "--log_dir", str(prepared / "port_log")])
