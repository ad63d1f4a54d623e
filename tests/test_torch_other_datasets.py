"""The port's dataset preparation on the CPU against the JAX package:
SemanticKITTI scans, labels and the learning map, the SemanticKITTI and
Semantic3D artifact trees (byte-equal ``.npy`` / ``.ply`` files, equal
projection pickles, KD-trees that answer the same queries), S3DIS
collection and ``original_ply``, ``cli.prepare`` for the three datasets and
``cli.cv6fold``.

The JAX package's preparation calls its optional C++ sub-sampler, which is
not part of the port: here it runs the JAX package's numpy sub-sampler.
"""

import os
import pickle

import numpy as np
import pytest
from scipy.spatial import cKDTree

from pointsecguard_tpu.cli import cv6fold as jax_cv6fold
from pointsecguard_tpu.cli import prepare as jax_prepare
from pointsecguard_tpu.data import other_datasets as jod
from pointsecguard_tpu.data import randla as jrandla
from pointsecguard_tpu.data import s3dis as js3dis
from pointsecguard_tpu.ops import subsample as jsubsample
from pointsecguard_tpu_torch.cli import cv6fold, prepare
from pointsecguard_tpu_torch.data import make_synthetic_rooms, other_datasets, randla, s3dis
from pointsecguard_tpu_torch.data import synthetic_outdoor as synth
from pointsecguard_tpu_torch.data.ply import read_ply, write_ply


def _jax_grid(points, features=None, labels=None, sample_dl=0.1, num_classes=0):
    """The JAX package's numpy sub-sampler under its C++ route's signature
    (called positionally and with keywords)."""
    return jsubsample.grid_subsample(points, features, labels, sample_dl, num_classes or None)


@pytest.fixture
def jax_numpy_grid(monkeypatch):
    monkeypatch.setattr(jod, "grid_subsample_native", _jax_grid)
    monkeypatch.setattr(jrandla, "grid_subsample_native", _jax_grid)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Raw trees of the three datasets: KITTI sequences 00 (2 scans), 08
    and 11; Semantic3D with a labeled training cloud, a labeled
    ``bildstein_station3`` cloud and an unlabeled one; S3DIS
    ``Area_*/room/Annotations`` from two synthetic rooms."""
    root = tmp_path_factory.mktemp("raw")
    seq, yaml_path = synth.write_raw_semantickitti(str(root / "kitti"), points=3000, seed=1)
    synth.write_raw_semantic3d(str(root / "sem3d"), points=4000, extent=6.0, seed=2)
    rooms = make_synthetic_rooms(str(root / "rooms"), points_per_room=3000, seed=3)
    synth.write_raw_s3dis(rooms, str(root / "s3dis"))
    return {"root": root, "kitti": seq, "yaml": yaml_path, "sem3d": str(root / "sem3d"),
            "s3dis": str(root / "s3dis"), "rooms": rooms}


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, names in os.walk(top) for f in names)


def assert_trees_equal(ours, theirs):
    """Same files; ``.npy`` and ``.ply`` byte-equal; projection pickles
    array-equal; KD-tree pickles answer the same queries."""
    names = _files(ours)
    assert names == _files(theirs) and names
    q = np.random.default_rng(0).random((50, 3)) * 8 - 4
    for n in names:
        a, b = os.path.join(ours, n), os.path.join(theirs, n)
        if not n.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), n
            continue
        with open(a, "rb") as fa, open(b, "rb") as fb:
            x, y = pickle.load(fa), pickle.load(fb)
        if isinstance(x, cKDTree):
            np.testing.assert_array_equal(x.data, y.data)
            for u, v in zip(x.query(q, k=4), y.query(q, k=4)):
                np.testing.assert_array_equal(u, v)
        else:
            assert len(x) == len(y), n
            for u, v in zip(x, y):
                assert np.asarray(u).dtype == np.asarray(v).dtype, n
                np.testing.assert_array_equal(u, v)


# --- SemanticKITTI ---------------------------------------------------------


def test_kitti_scan_labels_and_remap_equal_jax_package(raw):
    scan = os.path.join(raw["kitti"], "00", "velodyne", "000001.bin")
    label = os.path.join(raw["kitti"], "00", "labels", "000001.label")
    np.testing.assert_array_equal(other_datasets.load_kitti_scan(scan),
                                  jod.load_kitti_scan(scan))
    lut = other_datasets.build_kitti_remap(synth.KITTI_LEARNING_MAP)
    np.testing.assert_array_equal(lut, jod.build_kitti_remap(synth.KITTI_LEARNING_MAP))
    got = other_datasets.load_kitti_labels(label, lut)
    np.testing.assert_array_equal(got, jod.load_kitti_labels(label, lut))
    assert got.dtype == np.int32 and set(np.unique(got)) == {0, 1, 9, 11, 13, 15, 18}
    raw_ids = np.fromfile(label, np.uint32)
    assert (raw_ids >> 16).any()  # the cars carry instance ids


def test_learning_map_parser_equals_yaml(raw, tmp_path):
    """The port's parser reads the ``learning_map`` block only (not
    ``learning_map_inv``, which follows it), as yaml.safe_load does."""
    got = other_datasets.parse_kitti_learning_map(raw["yaml"])
    assert got == jod.parse_kitti_learning_map(raw["yaml"]) == synth.KITTI_LEARNING_MAP
    text = open(raw["yaml"]).read()
    assert "learning_map_inv:" in text and "learning_ignore:" in text and "color_map:" in text
    # the block last in the file, blank lines and comments inside it
    moved = tmp_path / "moved.yaml"
    block = text[text.index("learning_map:"):text.index("learning_map_inv:")]
    rest = text.replace(block, "")
    lines = block.splitlines()
    moved.write_text(rest + lines[0] + "\n\n  # a comment\n" + "\n".join(lines[1:]) + "\n")
    assert (other_datasets.parse_kitti_learning_map(str(moved))
            == jod.parse_kitti_learning_map(str(moved)) == synth.KITTI_LEARNING_MAP)
    missing = tmp_path / "missing.yaml"
    missing.write_text(rest)
    with pytest.raises(ValueError, match="learning_map"):
        other_datasets.parse_kitti_learning_map(str(missing))


def test_prepare_semantickitti_root_equals_jax_package(raw, tmp_path, jax_numpy_grid):
    mapping = synth.KITTI_LEARNING_MAP
    ours = other_datasets.prepare_semantickitti_root(raw["kitti"], str(tmp_path / "port"),
                                                     mapping)
    theirs = jod.prepare_semantickitti_root(raw["kitti"], str(tmp_path / "jax"), mapping)
    assert ours == theirs == ["00/000000", "00/000001", "08/000000", "11/000000"]
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    files = _files(tmp_path / "port")
    assert "08/proj/000000_proj.pkl" in files and "11/proj/000000_proj.pkl" in files
    assert not any(f.startswith("00/proj") or f.startswith("11/labels") for f in files)


def test_prepare_scan_equals_jax_package(raw, tmp_path, jax_numpy_grid):
    rng = np.random.default_rng(4)
    xyz = (rng.random((2000, 3)) * 3).astype(np.float32)
    labels = rng.integers(0, 20, 2000).astype(np.int32)
    for lab, tag in ((labels, "labeled"), (None, "bare")):
        other_datasets.prepare_scan(xyz, lab, str(tmp_path / "port"), tag, grid_size=0.2)
        jod.prepare_scan(xyz, lab, str(tmp_path / "jax"), tag, grid_size=0.2)
    other_datasets.prepare_scan(xyz, labels, str(tmp_path / "port"), "noproj",
                                grid_size=0.2, save_proj=False)
    jod.prepare_scan(xyz, labels, str(tmp_path / "jax"), "noproj", grid_size=0.2,
                     save_proj=False)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


# --- Semantic3D --------------------------------------------------------------


def test_load_semantic3d_cloud_equals_jax_package(raw):
    """np.loadtxt here, pandas in the JAX package: the same float32 values."""
    for name in os.listdir(raw["sem3d"]):
        if name.endswith(".txt"):
            path = os.path.join(raw["sem3d"], name)
            got = other_datasets.load_semantic3d_cloud(path)
            want = jod.load_semantic3d_cloud(path)
            assert got.dtype == want.dtype == np.float32 and got.shape == (4000, 7)
            np.testing.assert_array_equal(got, want)


def test_prepare_semantic3d_root_equals_jax_package_and_skips_done_clouds(raw, tmp_path,
                                                                           jax_numpy_grid):
    ours = other_datasets.prepare_semantic3d_root(raw["sem3d"], str(tmp_path / "port"))
    theirs = jod.prepare_semantic3d_root(raw["sem3d"], str(tmp_path / "jax"))
    assert ours == theirs and len(ours) == 3
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    # the labeled cloud's projection pairs the 0.01-grid points with their
    # own labels (the deliberate fix), the unlabeled one's raw points with 0
    sub = tmp_path / "port" / "input_0.060"
    for name, labeled in synth.SEMANTIC3D_CLOUDS:
        with open(sub / f"{name}_proj.pkl", "rb") as f:
            proj, labels = pickle.load(f)
        original = read_ply(str(tmp_path / "port" / "original_ply" / f"{name}.ply"))
        assert len(proj) == len(labels) == len(original)
        if labeled:
            np.testing.assert_array_equal(labels, original["class"])
        else:
            assert not labels.any() and "class" not in original.dtype.names
    before = {n: os.path.getmtime(tmp_path / "port" / n) for n in _files(tmp_path / "port")}
    assert other_datasets.prepare_semantic3d_root(raw["sem3d"], str(tmp_path / "port")) == []
    assert before == {n: os.path.getmtime(tmp_path / "port" / n)
                      for n in _files(tmp_path / "port")}


def test_prepare_semantic3d_cloud_equals_jax_package(tmp_path, jax_numpy_grid):
    rng = np.random.default_rng(5)
    pts = (rng.random((3000, 3)) * 2).astype(np.float32)
    cols = rng.integers(0, 256, (3000, 3)).astype(np.uint8)
    labels = rng.integers(0, 9, 3000).astype(np.uint8)
    for lab, tag in ((labels, "labeled"), (None, "bare")):
        other_datasets.prepare_semantic3d_cloud(pts, cols, lab, str(tmp_path / "port"), tag,
                                                first_grid=0.05, final_grid=0.2)
        jod.prepare_semantic3d_cloud(pts, cols, lab, str(tmp_path / "jax"), tag,
                                     first_grid=0.05, final_grid=0.2)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


# --- S3DIS -------------------------------------------------------------------


def test_collect_s3dis_and_original_ply_equal_jax_package(raw, tmp_path, jax_numpy_grid):
    ours = s3dis.collect_s3dis(raw["s3dis"], str(tmp_path / "port"))
    theirs = js3dis.collect_s3dis(raw["s3dis"], str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs] \
        == ["Area_1_synth_1.npy", "Area_5_synth_1.npy"]
    for a, b, room in zip(ours, theirs, raw["rooms"]):
        got = np.load(a)
        np.testing.assert_array_equal(got, np.load(b))
        assert got.shape == np.load(room).shape  # every point collected once
    for a in ours:
        randla.prepare_room(a, str(tmp_path / "rp"), 0.2, original_dir=str(tmp_path / "ro"))
        jrandla.prepare_room(a, str(tmp_path / "jp"), 0.2, original_dir=str(tmp_path / "jo"))
    assert_trees_equal(tmp_path / "rp", tmp_path / "jp")
    assert_trees_equal(tmp_path / "ro", tmp_path / "jo")


# --- the CLIs ------------------------------------------------------------------


@pytest.mark.parametrize("dataset", ["s3dis", "semantickitti", "semantic3d"])
def test_cli_prepare_equals_jax_cli(raw, tmp_path, jax_numpy_grid, dataset, capsys):
    def argv(out):
        if dataset == "semantickitti":
            return ["--dataset", dataset, "--raw_root", raw["kitti"], "--out_root",
                    str(out), "--kitti_yaml", raw["yaml"]]
        if dataset == "semantic3d":
            return ["--dataset", dataset, "--raw_root", raw["sem3d"], "--out_root", str(out)]
        return ["--raw_root", raw["s3dis"], "--out_root", str(out / "rooms"),
                "--randla_out", str(out / "randla_input_0.200"), "--sub_grid_size", "0.2"]

    prepare.main(argv(tmp_path / "port"))
    ours = capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT")
    jax_prepare.main(argv(tmp_path / "jax"))
    theirs = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    assert ours == theirs and ours
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    if dataset == "s3dis":
        assert _files(tmp_path / "port" / "original_ply") == [
            "Area_1_synth_1.ply", "Area_5_synth_1.ply"]


def test_cli_prepare_needs_its_inputs():
    with pytest.raises(SystemExit):
        prepare.main(["--dataset", "semantickitti", "--raw_root", "x"])
    with pytest.raises(SystemExit):
        prepare.main(["--dataset", "semantic3d"])


def test_cv6fold_equals_jax_cli(raw, tmp_path, capsys):
    """The same PLYs give the same printed per-cloud accuracies, accuracy,
    mIoU, class IoUs and mAcc as the JAX CLI, and the same metrics to
    float32 rounding."""
    original = tmp_path / "original"
    preds = tmp_path / "preds"
    os.makedirs(preds)
    rng = np.random.default_rng(6)
    for room in raw["rooms"]:
        name = os.path.basename(room)[:-4]
        randla.prepare_room(room, str(tmp_path / "prep"), 0.2, original_dir=str(original))
        labels = np.load(room)[:, 6].astype(np.int64)
        pred = np.where(rng.random(len(labels)) < 0.7, labels, rng.integers(0, 13, len(labels)))
        write_ply(str(preds / f"{name}.ply"), [pred.astype(np.int32)], ["pred"])
    argv = ["--results_dir", str(preds), "--original_dir", str(original)]
    m = cv6fold.main(argv)
    ours = capsys.readouterr().out
    want = jax_cv6fold.main(argv)
    assert ours == capsys.readouterr().out and "mAcc" in ours
    # the JAX CLI's metrics are float32 (jax.numpy), the port's float64
    assert m.miou == pytest.approx(float(want.miou), abs=1e-6)
    assert m.accuracy == pytest.approx(float(want.accuracy), abs=1e-6)
    np.testing.assert_allclose(m.class_iou, np.asarray(want.class_iou), atol=1e-6)
    assert 0.5 < m.accuracy < 0.9


def test_cv6fold_scores_eval_save_preds_as_eval_does(tmp_path, monkeypatch):
    """Rooms prepared with their ``original_ply`` as ``cli.prepare`` lays
    them out, a narrow random RandLA-Net, ``cli.eval --save_preds``:
    cv6fold on those PLYs gives eval's own accuracy and mIoU."""
    import functools

    import torch

    from pointsecguard_tpu_torch import configs as tconfigs
    from pointsecguard_tpu_torch.cli import eval as eval_cli
    from pointsecguard_tpu_torch.models import RandLANet
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    narrow = {"d_out": (8, 16), "num_layers": 2, "sub_sampling_ratio": (4, 4)}
    monkeypatch.setattr(tconfigs, "RandlaConfig",
                        functools.partial(tconfigs.RandlaConfig, **narrow))
    rooms = make_synthetic_rooms(str(tmp_path / "rooms"), points_per_room=6000, seed=2)
    for room in rooms:
        randla.prepare_room(room, str(tmp_path / "prep"), 0.1,
                            original_dir=str(tmp_path / "original"))
    torch.manual_seed(0)
    save_checkpoint(str(tmp_path / "log"), RandLANet(d_out=narrow["d_out"]).state_dict())
    m = eval_cli.main(["--model", "randla", "--device", "cpu", "--randla_dir",
                       str(tmp_path / "prep"), "--log_dir", str(tmp_path / "log"),
                       "--randla_points", "512", "--num_clouds", "4", "--save_preds",
                       str(tmp_path / "preds")])
    assert os.listdir(tmp_path / "preds") == ["Area_5_synth_1.ply"]
    cv = cv6fold.main(["--results_dir", str(tmp_path / "preds"), "--original_dir",
                       str(tmp_path / "original")])
    assert cv.accuracy == pytest.approx(m.accuracy, abs=1e-12)
    assert cv.miou == pytest.approx(m.miou, abs=1e-12)
    assert 0.0 < cv.accuracy < 1.0
