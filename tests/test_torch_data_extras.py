"""The port's copies of the three numpy readers that no CLI reaches
(``data/blocks.py``, ``data/partnet.py``, ``data/image_datasets.py``)
against the JAX package's, on the same inputs and seeds: the legacy
block utilities, the PartNet h5 loader and the CIFAR-10 / ImageNet-val
loaders. Each port function returns what the JAX one returns, exactly;
the cases mirror ``tests/test_data_extras.py`` (``TestLegacyBlocks``,
``TestPartNet``) and ``tests/test_image_datasets.py``."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from pointsecguard_tpu.data import blocks as jblocks
from pointsecguard_tpu.data import image_datasets as jimages
from pointsecguard_tpu.data import partnet as jpartnet
from pointsecguard_tpu_torch import data as tdata
from pointsecguard_tpu_torch.data import blocks as tblocks


def _equal_trees(got, want):
    assert type(got) is type(want) or isinstance(got, type(want))
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal_trees(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _room(seed=0, n=5000):
    rng = np.random.RandomState(seed)
    data = rng.rand(n, 6) * [3, 3, 2.5, 255, 255, 255]
    return data, rng.randint(0, 13, n)


# --- the legacy block utilities --------------------------------------------------

@pytest.mark.parametrize("n,num_sample", [(50, 80), (50, 20), (50, 50)],
                         ids=["pad", "shrink", "same"])
def test_sample_data_equals_jax(n, num_sample):
    d = np.random.RandomState(0).rand(n, 6)
    got = tblocks.sample_data(d, num_sample, np.random.default_rng(0))
    want = jblocks.sample_data(d, num_sample, np.random.default_rng(0))
    _equal_trees(got, want)
    assert got[0].shape == (num_sample, 6)


@pytest.mark.parametrize("stride", [1.0, 0.5])
def test_room2blocks_equals_jax(stride):
    data, labels = _room()
    got = tblocks.room2blocks(data, labels, 256, stride=stride, rng=np.random.default_rng(0))
    want = jblocks.room2blocks(data, labels, 256, stride=stride, rng=np.random.default_rng(0))
    _equal_trees(got, want)
    assert got[0].shape[1:] == (256, 6) and got[1].shape == got[0].shape[:2]


def test_room2blocks_normalized_equals_jax():
    rng = np.random.RandomState(0)
    data = np.hstack([rng.rand(4000, 3) * 3, rng.randint(0, 256, (4000, 3)),
                      rng.randint(0, 13, (4000, 1))])
    got = tblocks.room2blocks_normalized(data, 128, rng=np.random.default_rng(0))
    want = jblocks.room2blocks_normalized(data, 128, rng=np.random.default_rng(0))
    _equal_trees(got, want)
    assert got[0].shape[1:] == (128, 9)
    assert got[0][..., 3:9].min() >= 0 and got[0][..., 3:9].max() <= 1 + 1e-6


def test_room2samples_equals_jax():
    data, labels = _room(n=1000)
    got = tblocks.room2samples(data, labels, 256)
    _equal_trees(got, jblocks.room2samples(data, labels, 256))
    assert got[0].shape == (4, 256, 6)


@pytest.mark.parametrize("label_color", [True, False])
def test_export_obj_equals_jax(tmp_path, label_color):
    rng = np.random.RandomState(0)
    data = np.hstack([rng.rand(10, 6), rng.randint(0, 13, (10, 1))])
    jblocks.export_obj(str(tmp_path / "j.obj"), data, label_color=label_color)
    tblocks.export_obj(str(tmp_path / "t.obj"), data, label_color=label_color)
    text = (tmp_path / "t.obj").read_text()
    assert text == (tmp_path / "j.obj").read_text()
    assert len(text.strip().splitlines()) == 10


def test_bbox_label_to_obj_equals_jax(tmp_path):
    boxes = np.array([[0, 0, 0, 1, 1, 1], [1, 2, 0, 2, 3, 1.5]])
    jblocks.bbox_label_to_obj(str(tmp_path / "j.obj"), boxes, np.array([3, 14]))
    tblocks.bbox_label_to_obj(str(tmp_path / "t.obj"), boxes, np.array([3, 14]))
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()


# --- PartNet ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def partnet_root(tmp_path_factory):
    """Both h5 layouts (`ResGCN/utils/data_util.py:165-214`), as
    tests/test_data_extras.py writes them."""
    h5py = pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("partnet")
    rng = np.random.RandomState(0)
    d = root / "raw" / "sem_seg_h5" / "Bed-3"
    d.mkdir(parents=True)
    for phase, nfiles in (("train", 2), ("val", 1)):
        for i in range(nfiles):
            with h5py.File(str(d / f"{phase}-{i:02d}.h5"), "w") as f:
                f["data"] = rng.rand(4, 128, 3).astype(np.float32)
                f["label_seg"] = rng.randint(0, 7, (4, 128))
    d2 = root / "raw" / "ins_seg_h5_for_sgpn" / "ins_seg_h5" / "Bed"
    d2.mkdir(parents=True)
    with h5py.File(str(d2 / "train-00.h5"), "w") as f:
        f["pts"] = rng.rand(3, 64, 3).astype(np.float32)
        f["label"] = rng.randint(0, 5, (3, 64))
        f["nor"] = rng.rand(3, 64, 3).astype(np.float32)
        f["opacity"] = rng.rand(3, 64).astype(np.float32)
        f["rgb"] = (rng.rand(3, 64, 3) * 255).astype(np.float32)
    return str(root)


@pytest.mark.parametrize("kw", [{"phase": "train"}, {"phase": "val"},
                                {"dataset": "ins_seg_h5"}],
                         ids=["sem_seg train", "sem_seg val", "ins_seg"])
def test_partnet_equals_jax(partnet_root, kw):
    got, want = tdata.PartNetDataset(partnet_root, **kw), jpartnet.PartNetDataset(
        partnet_root, **kw)
    assert len(got) == len(want) == {"train": 8, "val": 4}.get(kw.get("phase"), 3)
    assert got.num_classes == want.num_classes
    for i in range(len(want)):
        _equal_trees(got[i], want[i])
    _equal_trees(list(got.batches(np.random.default_rng(0), 2)),
                 list(want.batches(np.random.default_rng(0), 2)))
    if "dataset" in kw:
        pos, lab, nor, feats = got[0]
        assert nor.shape == (64, 3) and feats.shape == (64, 4) and feats[:, 1:].max() <= 1.0


def test_partnet_missing_raises_the_application_gate(tmp_path):
    with pytest.raises(FileNotFoundError, match="application"):
        tdata.PartNetDataset(str(tmp_path), obj_category="Chair")
    with pytest.raises(ValueError, match="unknown PartNet variant"):
        tdata.PartNetDataset(str(tmp_path), dataset="other")


def test_partnet_batch_drives_the_port_resgcn(partnet_root):
    """A PartNet batch drives the port's DenseDeepGCN (xyz padded to the
    9-channel input), as tests/test_data_extras.py drives the JAX one."""
    import torch

    from pointsecguard_tpu_torch.models import DenseDeepGCN

    ds = tdata.PartNetDataset(partnet_root, phase="train")
    pos, _ = next(ds.batches(np.random.default_rng(1), 2))
    pts = torch.from_numpy(np.concatenate([pos, np.zeros((2, 128, 6), np.float32)], -1))
    model = DenseDeepGCN(num_classes=ds.num_classes, n_blocks=3, n_filters=8, k=4).eval()
    with torch.no_grad():
        assert model(pts).shape == (2, 128, ds.num_classes)


def test_readers_import_h5py_and_pil_only_when_they_read():
    """``import pointsecguard_tpu_torch.data`` with ``h5py`` and ``PIL``
    blocked: the package imports, and the readers raise only once asked
    to read."""
    code = (
        "import sys\n"
        "for m in ('h5py', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import pointsecguard_tpu_torch, pointsecguard_tpu_torch.data as d\n"
        "from pointsecguard_tpu_torch.data import blocks, image_datasets, partnet\n"
        "try:\n"
        "    d.PartNetDataset('nowhere')\n"
        "except ImportError as e:\n"
        "    assert 'h5py' in str(e)\n"
        "else:\n"
        "    raise AssertionError('PartNet read without h5py')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)), timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# --- the image benchmark sets ------------------------------------------------------

N_CIFAR = 12


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (N_CIFAR, 32, 32, 3), dtype=np.uint8)
    with open(root / "test_batch", "wb") as f:
        pickle.dump({b"data": imgs.transpose(0, 3, 1, 2).reshape(N_CIFAR, 3072),
                     b"labels": list(rng.randint(0, 10, N_CIFAR))}, f)
    np.save(root / "target.npy", rng.randint(0, 10, N_CIFAR))
    return str(root), imgs


@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet")
    img_dir = root / "ILSVRC2012_img_val"
    img_dir.mkdir()
    rng = np.random.RandomState(1)
    names = []
    for i, (size, mode) in enumerate(zip([(80, 60), (48, 48), (100, 40)], ["RGB", "L", "RGB"])):
        arr = rng.randint(0, 256, (size[1], size[0]), dtype=np.uint8)
        if mode == "RGB":
            arr = np.stack([arr] * 3, -1) + np.arange(3, dtype=np.uint8)
        Image.fromarray(arr, mode=mode).save(img_dir / f"val_{i}.png")
        names.append(f"val_{i}.png")
    with open(root / "val.txt", "w") as f:
        f.writelines(f"{n} {i % 3}\n" for i, n in enumerate(names))
    with open(root / "target.txt", "w") as f:
        f.writelines(f"{n} {(i + 1) % 3}\n" for i, n in enumerate(names))
    return str(root)


_CIFAR_CASES = {
    "all": {}, "offset_targets": {"offset": 5, "load_target": True},
    "target_label": {"target_label": 3}, "int64": {"label_dtype": np.int64},
}


@pytest.mark.parametrize("case", sorted(_CIFAR_CASES))
def test_load_cifar10_equals_jax(cifar_root, case):
    root, imgs = cifar_root
    kw = _CIFAR_CASES[case]
    got, want = list(tdata.load_cifar10(root, **kw)), list(jimages.load_cifar10(root, **kw))
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        _equal_trees(g, w)
    if case == "all":
        np.testing.assert_array_equal(got[3][1], imgs[3])


def test_cifar10_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="test_batch"):
        list(tdata.load_cifar10(str(tmp_path)))


_IMAGENET_CASES = {
    "clip": (32, 32, {}), "targets_offset": (16, 16, {"load_target": True, "label_offset": 1}),
    "offset_filter": (16, 16, {"offset": 1, "target_label": 2}),
    "no_clip": (24, 20, {"clip": False}),
}


@pytest.mark.parametrize("case", sorted(_IMAGENET_CASES))
def test_load_imagenet_val_equals_jax(imagenet_root, case):
    h, w, kw = _IMAGENET_CASES[case]
    got = list(tdata.load_imagenet_val(imagenet_root, h, w, **kw))
    want = list(jimages.load_imagenet_val(imagenet_root, h, w, **kw))
    assert got and len(got) == len(want)
    for g, v in zip(got, want):
        _equal_trees(g, v)
        assert g[1].shape == (h, w, 3) and g[1].dtype == np.uint8


@pytest.mark.parametrize("drop", [False, True])
def test_classifier_scaling_and_batches_equal_jax(cifar_root, drop):
    root, _ = cifar_root
    tspec = tdata.ImageClassifierSpec(x_shape=(3072,), x_min=-1.0, x_max=1.0)
    jspec = jimages.ImageClassifierSpec(x_shape=(3072,), x_min=-1.0, x_max=1.0)
    got = list(tdata.as_batches(tdata.load_for_classifier(tdata.load_cifar10(root), tspec), 5,
                                drop_remainder=drop))
    want = list(jimages.as_batches(jimages.load_for_classifier(jimages.load_cifar10(root),
                                                               jspec), 5, drop_remainder=drop))
    _equal_trees(got, want)
    assert [b[1].shape[0] for b in got] == ([5, 5] if drop else [5, 5, 2])
    assert got[0][1].dtype == np.float32 and got[0][1].shape == (5, 3072)
