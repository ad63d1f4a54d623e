"""The port's PointNet++ NU / tar_NU through its attack CLI on the CPU,
against the JAX driver on the same synthetic blocks and weights (the C&W
preset's 1000 steps cut in both packages)."""

import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointsecguard_tpu import attacks as jattacks
from pointsecguard_tpu.models import PointNet2SemSegSSG as JaxPointNet2
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch.cli import attack as tcli
from pointsecguard_tpu_torch.data import synthetic
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint
from pointsecguard_tpu_torch.utils.convert import from_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_tsv_header() -> str:
    from pointsecguard_tpu.cli import _attack_blocks

    src = inspect.getsource(_attack_blocks.run_blocks)
    return re.search(r'header = "([^"]+)"', src).group(1).encode().decode("unicode_escape")


def _read_tsv(path):
    lines = path.read_text().splitlines()
    return lines[0], [line.split("\t") for line in lines[1:]]


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Synthetic rooms and one JAX-initialised PointNet++ checkpoint in
    each package's format."""
    from pointsecguard_tpu.train import create_train_state
    from pointsecguard_tpu.utils.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("cw_cli")
    synthetic.make_synthetic_rooms(str(root / "data"), points_per_room=3000, seed=0)
    state, _ = create_train_state(JaxPointNet2(), (jnp.zeros((2, 64, 9)), None),
                                  rng=jax.random.PRNGKey(0))
    CheckpointManager(str(root / "jax_log" / "checkpoints")).save(0, state)
    flat = flatten_dict({"params": state.params, "batch_stats": state.batch_stats}, sep="/")
    save_checkpoint(str(root / "port_log"),
                    from_jax_variables({k: np.asarray(v) for k, v in flat.items()}))
    return root


def _run_both(logs, mp, attack, extra, **overrides):
    from pointsecguard_tpu.cli import attack as jcli

    for pkg in (jattacks, tattacks):
        key = ("pointnet2", attack)
        mp.setitem(pkg._PRESETS, key, dataclasses.replace(pkg._PRESETS[key], **overrides))
    argv = ["--attack", attack, "--data_root", str(logs / "data"), "--num_point", "64",
            "--batch_size", "2", "--max_blocks", "2"] + extra
    jcli.main(argv + ["--log_dir", str(logs / "jax_log")])
    tcli.main(argv + ["--log_dir", str(logs / "port_log"), "--device", "cpu"])
    tsv = f"pointnet2_{attack}_area5.tsv"
    return _read_tsv(logs / "jax_log" / tsv), _read_tsv(logs / "port_log" / tsv)


def test_cli_nu_on_cpu_matches_the_jax_driver(logs, monkeypatch):
    # 20 steps without the early exit: the random weights start below it
    (jheader, jrows), (header, rows) = _run_both(
        logs, monkeypatch, "nu", [], steps=20, success_acc=0.0)
    assert header == jheader == _jax_tsv_header()
    assert len(rows) == len(jrows) == 2
    for r, jr in zip(rows, jrows):
        assert r[:3] == jr[:3]  # the same room, block and clean accuracy
        assert r[7] == jr[7] == "20" and all(np.isfinite(float(x)) for x in r[2:])
        assert float(r[4]) > 0.0  # the colours moved


def test_cli_tar_nu_on_cpu_matches_the_jax_driver(logs, monkeypatch):
    (jheader, jrows), (header, rows) = _run_both(
        logs, monkeypatch, "tar_nu", ["--origin", "11"], steps=10)
    assert header == jheader == _jax_tsv_header()
    assert len(rows) == len(jrows) >= 1  # blocks without board points are skipped
    for r, jr in zip(rows, jrows):
        assert r[:3] == jr[:3]
        assert 1 <= int(r[7]) <= 10 and 0.0 <= float(r[5]) <= 1.0
