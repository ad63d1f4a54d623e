"""The port's device block sampler (``data/device_sampler.py``,
``cli.train --device_sampler``) against the JAX package's, on the CPU.

JAX's draws (``kroom, kcenter, kchoice, krot`` of each block's key,
`pointsecguard_tpu/data/device_sampler.py:139-245`) are regenerated and
fed to the port through ``draws=``: features and labels equal within
1e-6 in both stage-1 modes, with and without replacement and with and
without the z-rotation. Then JAX's invariants (``TestInvariants``,
``TestWithoutReplacement`` of tests/test_device_sampler.py) on the
port's own draws, the marginals against the port's host sampler, and an
epoch's step count through ``cli.train``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointsecguard_tpu.data import RoomSet as JaxRoomSet
from pointsecguard_tpu.data import device_sampler as jds
from pointsecguard_tpu_torch.cli import train as train_cli
from pointsecguard_tpu_torch.data import RoomSet, S3DISBlockSampler, make_synthetic_rooms
from pointsecguard_tpu_torch.data import device_sampler as tds

P, B, TRIES = 128, 8, 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dsr"))
    make_synthetic_rooms(d, points_per_room=6000, seed=0)
    return d


@pytest.fixture(scope="module")
def rooms(data):
    return RoomSet.load(data, "train", 5)


@pytest.fixture(scope="module")
def staged(rooms):
    return tds.stage_rooms(rooms, torch.device("cpu"))


def _sampler(num_max, **kw):
    kw = {"augment_z": False, "min_points": 256, **kw}
    return tds.make_device_block_sampler(batch_size=B, num_point=P, num_max=num_max, **kw)


def test_staging_equals_jax(data, rooms, staged):
    st, num_max = staged
    jst, jnum_max = jds.stage_rooms(JaxRoomSet.load(data, "train", 5))
    assert num_max == jnum_max and num_max % 128 == 0
    np.testing.assert_array_equal(st.flat.numpy(), np.asarray(jst.flat))
    for name in ("start", "count", "coord_max", "prob"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)))
    assert st.nbytes == st.flat.numel() * 4 + st.coord_max.numel() * 4 + st.prob.numel() * 4 \
        + (st.start.numel() + st.count.numel()) * 8


def _jax_draws(jst, num_max, key, replacement, augment_z):
    """The draws ``_sample_one`` takes from each block's key."""
    rooms, cands, us, gumbels, angles = [], [], [], [], []
    for k in jax.random.split(key, B):
        kroom, kcenter, kchoice, krot = jax.random.split(k, 4)
        r = jax.random.choice(kroom, jst.prob.shape[0], p=jst.prob)
        rooms.append(int(r))
        cands.append(np.asarray(jax.random.randint(kcenter, (TRIES,), 0, jst.count[r])))
        us.append(np.asarray(jax.random.uniform(kchoice, (P,))))
        gumbels.append(np.asarray(jax.random.gumbel(kchoice, (num_max,))))
        angles.append(float(jax.random.uniform(krot, (), minval=0.0, maxval=2 * jnp.pi)))
    t = torch.from_numpy
    return tds.BlockDraws(
        room=torch.tensor(rooms), candidates=t(np.stack(cands)).long(), u=t(np.stack(us)),
        gumbel=None if replacement else t(np.stack(gumbels)),
        angle=torch.tensor(angles, dtype=torch.float32) if augment_z else None)


@pytest.mark.parametrize("mode", ["dense", "super"])
@pytest.mark.parametrize("replacement", [True, False], ids=["with", "without"])
@pytest.mark.parametrize("augment_z", [False, True], ids=["flat", "rotated"])
def test_sampler_equals_jax_on_its_draws(data, staged, mode, replacement, augment_z):
    st, num_max = staged
    jst, _ = jds.stage_rooms(JaxRoomSet.load(data, "train", 5))
    kw = dict(min_points=256, augment_z=augment_z, replacement=replacement, stage1_mode=mode)
    key = jax.random.PRNGKey(9)
    jf, jl = jax.jit(jds.make_device_block_sampler(
        batch_size=B, num_point=P, num_max=num_max, **kw))(jst, key)
    draws = _jax_draws(jst, num_max, key, replacement, augment_z)
    f, lab = tds.make_device_block_sampler(batch_size=B, num_point=P, num_max=num_max,
                                           chunk=3, **kw)(st, draws=draws)
    assert f.shape == (B, P, 9) and f.dtype == torch.float32 and lab.dtype == torch.int64
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))


class TestInvariants:
    def test_shapes_and_feature_ranges(self, staged):
        st, num_max = staged
        f, lab = _sampler(num_max)(st, torch.Generator().manual_seed(0))
        f, lab = f.numpy(), lab.numpy()
        assert f.shape == (B, P, 9) and lab.shape == (B, P)
        assert lab.min() >= 0 and lab.max() <= 12
        assert np.all(np.abs(f[..., :2]) <= 0.5 + 1e-5)
        assert f[..., 3:6].min() >= 0 and f[..., 3:6].max() <= 1
        assert f[..., 6:9].min() >= 0 and f[..., 6:9].max() <= 1 + 1e-5

    def test_deterministic_per_seed(self, staged):
        st, num_max = staged
        runs = [_sampler(num_max, augment_z=True)(st, torch.Generator().manual_seed(7))
                for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])

    def test_augmentation_rotates_only_centred_coords(self, staged):
        """The rotation's draw comes last, so one seed gives the same blocks
        with and without it: z and the xy radius kept, channels 3:9 untouched."""
        st, num_max = staged
        f_off, _ = _sampler(num_max)(st, torch.Generator().manual_seed(3))
        f_on, _ = _sampler(num_max, augment_z=True)(st, torch.Generator().manual_seed(3))
        f_off, f_on = f_off.numpy(), f_on.numpy()
        np.testing.assert_array_equal(f_off[..., 3:], f_on[..., 3:])
        np.testing.assert_allclose(f_off[..., 2], f_on[..., 2], atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(f_off[..., :2], axis=-1),
                                   np.linalg.norm(f_on[..., :2], axis=-1), atol=1e-4)
        assert np.abs(f_off[..., 0] - f_on[..., 0]).max() > 1e-3

    def test_labels_match_staged_points(self, rooms, staged):
        st, num_max = staged
        f, lab = _sampler(num_max)(st, torch.Generator().manual_seed(1))
        f, lab = f.numpy(), lab.numpy()
        ok = np.zeros(f.shape[:2], bool)
        for pts, labels, cmax in zip(rooms.points, rooms.labels, rooms.coord_max):
            xyz = f[..., 6:9] * cmax
            for b in range(B):
                d = np.abs(pts[None, :, :3] - xyz[b][:, None, :]).sum(-1)
                j = d.argmin(1)
                ok[b] |= (d[np.arange(P), j] < 1e-3) & (labels[j] == lab[b])
        assert ok.all()


class TestWithoutReplacement:
    def test_no_duplicates_and_all_in_block(self, staged):
        st, num_max = staged
        f, _ = _sampler(num_max, replacement=False)(st, torch.Generator().manual_seed(2))
        f = f.numpy()
        assert np.all(np.abs(f[..., :2]) <= 0.5 + 1e-5)
        for b in range(B):
            assert len({tuple(r) for r in f[b].round(6).tolist()}) == P

    def test_small_block_falls_back_to_replacement(self):
        rng = np.random.default_rng(7)
        pts = np.concatenate([rng.uniform(0, 0.5, (40, 3)), rng.uniform(0, 255, (40, 3))], 1)

        class _R:
            points = [pts]
            labels = [rng.integers(0, 13, 40)]
            coord_max = [pts[:, :3].max(0)]

        st, num_max = tds.stage_rooms(_R, torch.device("cpu"))
        sample = tds.make_device_block_sampler(batch_size=2, num_point=P, num_max=num_max,
                                               min_points=8, replacement=False,
                                               augment_z=False)
        f, lab = sample(st, torch.Generator().manual_seed(3))
        assert f.shape == (2, P, 9)
        assert set(lab.flatten().tolist()) <= set(_R.labels[0].tolist())

    def test_tied_keys_are_taken_in_index_order_as_lax_top_k(self):
        """Float32 Gumbel keys tie in a block of tens of thousands of points:
        the port takes the tied keys in index order, as ``lax.top_k`` does
        (keys rounded to halves here, so that nearly every key ties)."""
        n = 300
        rng = np.random.default_rng(3)
        xyz = np.stack([(np.arange(n) + 1) * 1e-3, rng.uniform(0, 0.4, n),
                        rng.uniform(0, 1, n)], 1)

        class _R:
            points = [np.concatenate([xyz, rng.uniform(0, 255, (n, 3))], 1)]
            labels = [rng.integers(0, 13, n)]
            coord_max = [xyz.max(0)]

        st, num_max = tds.stage_rooms(_R, torch.device("cpu"))
        sample = tds.make_device_block_sampler(batch_size=2, num_point=P, num_max=num_max,
                                               min_points=8, replacement=False,
                                               augment_z=False)
        draws = sample.draw(st, torch.Generator().manual_seed(0))
        keys = torch.round(2 * draws.gumbel) / 2
        f, _ = sample(st, draws=draws._replace(gumbel=keys))
        got = np.rint(f.numpy()[..., 6] * xyz[:, 0].max() / 1e-3).astype(int) - 1
        valid = np.arange(num_max) < n
        for b in range(2):
            masked = jnp.where(jnp.asarray(valid), jnp.asarray(keys[b].numpy()), -jnp.inf)
            np.testing.assert_array_equal(got[b], np.asarray(jax.lax.top_k(masked, P)[1]))

    def test_min_points_retry_prefers_dense_blocks(self):
        """A room 95 % one dense 1 m cluster: nearly every block lands on it."""
        rng = np.random.default_rng(5)
        xyz = np.concatenate([rng.uniform(0, 1, (4000, 3)), rng.uniform(10, 50, (200, 3))])

        class _R:
            points = [np.concatenate([xyz, rng.uniform(0, 255, (4200, 3))], 1)]
            labels = [rng.integers(0, 13, 4200)]
            coord_max = [xyz.max(0)]

        st, num_max = tds.stage_rooms(_R, torch.device("cpu"))
        f, _ = _sampler(num_max, min_points=1024)(st, torch.Generator().manual_seed(1))
        abs_x = f.numpy()[..., 6] * float(xyz.max(0)[0])
        assert ((abs_x < 1.5).mean(axis=1) > 0.9).mean() >= 7 / 8


def test_label_and_feature_marginals_match_the_host_sampler(rooms, staged):
    st, num_max = staged
    gen = torch.Generator().manual_seed(11)
    sample = _sampler(num_max)
    dev = [sample(st, gen) for _ in range(160 // B)]
    dev_f = torch.cat([d[0] for d in dev]).numpy()
    dev_l = torch.cat([d[1] for d in dev]).numpy()
    host = S3DISBlockSampler(rooms, num_point=P, min_points=256)
    rng = np.random.default_rng(0)
    hs = [host.sample(rng) for _ in range(160)]
    host_f, host_l = np.stack([h[0] for h in hs]), np.stack([h[1] for h in hs])
    hd = np.bincount(dev_l.ravel(), minlength=13) / dev_l.size
    hh = np.bincount(host_l.ravel(), minlength=13) / host_l.size
    assert np.abs(hd - hh).sum() < 0.2, (hd, hh)
    md, mh = dev_f.mean((0, 1)), host_f.mean((0, 1))
    np.testing.assert_allclose(md[:2], mh[:2], atol=0.05)
    np.testing.assert_allclose(md[2], mh[2], atol=0.25)
    np.testing.assert_allclose(md[3:6], mh[3:6], atol=0.06)
    np.testing.assert_allclose(md[6:9], mh[6:9], atol=0.08)


@pytest.mark.parametrize("n,spc,want", [(46, 4, [4, 1, 1]), (46, 1, [1] * 6),
                                        (48, 3, [3, 3]), (3, 4, [1])])
def test_epoch_calls_cover_the_host_epoch(n, spc, want):
    calls = tds.epoch_calls(n, 8, spc)
    assert calls == want and sum(calls) == max(-(-n // 8), 1)


def test_device_sampled_epoch_runs_the_host_step_count(data, tmp_path):
    """``cli.train --device_sampler [--device_sampler_exact] --steps_per_call
    4`` takes the host
    epoch's ceil(46 / 8) = 6 steps (a call of 4, then two of 1), as the
    host pipeline does."""
    counts = {}
    for name, extra in (("host", []), ("device", ["--device_sampler", "--device_sampler_exact"])):
        log = str(tmp_path / name)
        train_cli.main(["--device", "cpu", "--model", "pointnet", "--data_root", data,
                        "--log_dir", log, "--npoint", "128", "--batch_size", "8",
                        "--epochs", "1", "--eval_every", "99", "--steps_per_call", "4",
                        *extra])
        with open(os.path.join(log, "events.jsonl")) as f:
            epochs = [json.loads(line) for line in f if '"epoch"' in line]
        counts[name] = [e["batches"] for e in epochs if e["event"] == "epoch"]
        assert all(np.isfinite(e["loss"]) for e in epochs if e["event"] == "epoch")
    assert counts["device"] == counts["host"] == [6]


def test_sampled_multi_step_draws_each_batch_before_its_step(staged):
    """k steps a call, each on a batch sampled from the generator first:
    equal to sampling and stepping by hand from the same seed."""
    from pointsecguard_tpu_torch.models import PointNetSemSeg, init_parameters, weighted_nll_loss
    from pointsecguard_tpu_torch.train.trainer import POINTNET, TrainState, make_train_step

    st, num_max = staged
    sample = _sampler(num_max, augment_z=True)
    results = []
    for by_hand in (False, True):
        model = PointNetSemSeg()
        init_parameters(model, torch.Generator().manual_seed(0))
        state = TrainState(model)
        step = make_train_step(model, weighted_nll_loss, family=POINTNET)
        gen = torch.Generator().manual_seed(4)
        if by_hand:
            losses = []
            for _ in range(2):
                pts, lab = sample(st, gen)
                losses.append(step(state, pts, lab, torch.ones(13), 1e-3, 0.1, gen))
            losses = torch.stack(losses)
        else:
            losses = tds.make_sampled_multi_train_step(step, sample)(
                state, st, torch.ones(13), 1e-3, 0.1, 2, gen)
        results.append((losses, state.params.clone()))
    assert results[0][0].shape == (2,) and torch.isfinite(results[0][0]).all()
    assert torch.equal(results[0][0], results[1][0]) and torch.equal(results[0][1], results[1][1])
