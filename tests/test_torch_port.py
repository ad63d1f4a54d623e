"""Guards of the port: no JAX inside it, the numpy host layer equal to the
JAX package's, the CLI's TSV format, unported flags refused, and
``chip_smoke.py`` failing without a GPU."""

import dataclasses
import inspect
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointsecguard_tpu.data import s3dis as jax_s3dis
from pointsecguard_tpu.data import synthetic as jax_synthetic
from pointsecguard_tpu_torch import attacks as tattacks
from pointsecguard_tpu_torch.cli import attack as tcli
from pointsecguard_tpu_torch.data import s3dis, synthetic
from pointsecguard_tpu_torch.models import PointNet2SemSegSSG
from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "pointsecguard_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once; torch's default of
    one thread per core each makes them contend, so the CPU-heavy port
    tests run on two threads (restored afterwards)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _no_gpu_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    return env


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pointsecguard_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pointsecguard_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_no_gpu_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|pointsecguard_tpu)\b",
                         re.M)
    sources = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders


def test_synthetic_rooms_and_blocks_equal_jax_package(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    synthetic.make_synthetic_rooms(str(ours), points_per_room=(2000, 9000), seed=3)
    jax_synthetic.make_synthetic_rooms(str(theirs), points_per_room=(2000, 9000), seed=3)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and len(names) == 2
    for n in names:
        np.testing.assert_array_equal(np.load(ours / n), np.load(theirs / n))
    rooms = s3dis.RoomSet.load(str(ours), "test", 5)
    jrooms = jax_s3dis.RoomSet.load(str(theirs), "test", 5)
    np.testing.assert_array_equal(rooms.label_weights, jrooms.label_weights)
    got = s3dis.WholeSceneBlocks(rooms, block_points=512).room_blocks(
        0, np.random.default_rng(1))
    want = jax_s3dis.WholeSceneBlocks(jrooms, block_points=512).room_blocks(
        0, np.random.default_rng(1))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _jax_tsv_header() -> str:
    from pointsecguard_tpu.cli import _attack_blocks

    src = inspect.getsource(_attack_blocks.run_blocks)
    literal = re.search(r'header = "([^"]+)"', src).group(1)
    return literal.encode().decode("unicode_escape")


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    synthetic.make_synthetic_rooms(str(root / "data"), points_per_room=3000, seed=0)
    save_checkpoint(str(root / "log"), PointNet2SemSegSSG().state_dict())
    return root


def _read_tsv(path):
    lines = path.read_text().splitlines()
    return lines[0], [line.split("\t") for line in lines[1:]]


def test_cli_nb_on_cpu_writes_jax_tsv_format(tiny_run):
    clean_m, adv_m = tcli.main([
        "--device", "cpu", "--data_root", str(tiny_run / "data"),
        "--log_dir", str(tiny_run / "log"), "--num_point", "64",
        "--batch_size", "2", "--max_blocks", "3",
    ])
    header, rows = _read_tsv(tiny_run / "log" / "pointnet2_nb_area5.tsv")
    assert header == _jax_tsv_header()
    assert len(rows) == 4  # batches of 2 until ≥ 3 blocks, as the JAX CLI
    for r in rows:
        assert len(r) == 9 and r[0] == "Area_5_synth_1.npy" and r[7] == "10"
        assert all(np.isfinite(float(x)) for x in r[2:])
        assert re.fullmatch(r"\d+\.\d{4}", r[4])  # l2 at 4 decimals
    assert [r[1] for r in rows] == ["0", "1", "2", "3"]
    assert 0.0 <= adv_m.accuracy <= 1.0 and 0.0 <= clean_m.miou <= 1.0


def test_cli_tar_nb_on_cpu(tiny_run, monkeypatch):
    # the preset's 500 iterations are cut to 3 to keep the CPU test short
    short = dataclasses.replace(tattacks._PRESETS[("pointnet2", "tar_nb")], iters=3)
    monkeypatch.setitem(tattacks._PRESETS, ("pointnet2", "tar_nb"), short)
    tcli.main([
        "--device", "cpu", "--attack", "tar_nb", "--origin", "11",
        "--data_root", str(tiny_run / "data"), "--log_dir", str(tiny_run / "log"),
        "--num_point", "64", "--batch_size", "2", "--max_blocks", "2",
    ])
    header, rows = _read_tsv(tiny_run / "log" / "pointnet2_tar_nb_area5.tsv")
    assert header == _jax_tsv_header()
    assert len(rows) >= 2
    for r in rows:  # blocks without board points are skipped, as in JAX
        assert r[7] == "3" and 0.0 <= float(r[5]) <= 1.0 and 0.0 <= float(r[6]) <= 1.0


@pytest.mark.parametrize("flags", [
    # the protocol flags (--control, --log_steps, --visual, --defense, --eot,
    # --attack random, --resgcn_fixed_graphs) are ported:
    # tests/test_torch_protocol_cli.py runs them. SemanticKITTI's clouds are
    # xyz-only: its attack is refused for that reason, not as unported
    ["--model", "randla", "--randla_dataset", "semantickitti"],
    # --ensemble / --ensemble_mode are ported: tests/test_torch_ensemble.py;
    # --randla_dataset semantic3d too (test_randla_dataset_is_taken)
    # --devices / --shard_points are ported (tests/test_torch_parallel_*.py),
    # --log_steps with them too: what stays refused with them is the fused
    # attentive kernel under --shard_points, and --resgcn_fast but with resgcn
    ["--model", "randla", "--shard_points", "4", "--devices", "4", "--fused_ap"],
    ["--devices", "4", "--resgcn_fast"],
    ["--devices", "2", "--model", "randla", "--resgcn_k", "8"],
    ["--shard_points", "2", "--devices", "2", "--model", "pointnet2_msg", "--fused_ap"],
    # resgcn is ported with --resgcn_fast (tests/test_torch_resgcn_fast.py);
    # the subsample dilation and the frozen-graph surrogate are resgcn's alone
    ["--model", "pointnet2", "--resgcn_fast"], ["--model", "pointnet", "--resgcn_fixed_graphs"],
    # RandLA's fused attentive pooling is not MSG's
    ["--model", "pointnet2_msg", "--fused_ap"],
])
def test_unported_flags_are_refused(flags):
    refusal = "xyz-only" if "semantickitti" in flags else "not ported yet"
    with pytest.raises(SystemExit, match=refusal):
        tcli.main(flags)


@pytest.mark.parametrize("model", ["pointnet2", "randla"])
def test_precision_bfloat16_is_taken(model):
    """``--precision bfloat16`` is parsed and refused by nothing
    (tests/test_torch_precision_cli.py attacks in bf16)."""
    args = tcli._parser().parse_args(["--model", model, "--precision", "bfloat16"])
    tcli._refuse_unported(args)
    assert args.precision == "bfloat16"


def test_randla_dataset_is_taken():
    """``--randla_dataset semantic3d`` is parsed and refused by nothing
    (tests/test_torch_randla_presets_cli.py attacks Semantic3D clouds)."""
    args = tcli._parser().parse_args(["--model", "randla", "--randla_dataset", "semantic3d"])
    tcli._refuse_unported(args)
    assert args.randla_dataset == "semantic3d"


def test_cuda_device_without_a_card_raises(tiny_run):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--data_root", str(tiny_run / "data"),
                   "--log_dir", str(tiny_run / "log")])


def _run_smoke(cwd):
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=_no_gpu_env() if cwd == REPO else
                         dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=""),
                         capture_output=True, text=True, timeout=120)
    last = out.stdout.strip().splitlines()[-1:] or [""]
    return out.returncode, last[0]


def test_chip_smoke_fails_without_gpu():
    rc, last = _run_smoke(REPO)
    assert rc != 0 and '"ok": true' not in last


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    rc, last = _run_smoke(tmp_path)
    assert rc != 0 and '"ok": true' not in last
