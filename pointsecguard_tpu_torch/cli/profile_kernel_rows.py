"""Time the wide-row bottom-k and FPS kernels at their rows of PERF.md's
kernel table on one card, for this checkout's port or another's.

    python3 pointsecguard_tpu_torch/cli/profile_kernel_rows.py make --inputs F
    python3 pointsecguard_tpu_torch/cli/profile_kernel_rows.py time --inputs F \\
        [--root DIR] [--label L] [--only bottom_k|fps] [--check]

``make`` writes the rows' sources, seeded as ``chip_smoke.py`` makes them:
the 16 synthetic ModelNet shapes of 10,000 points of phase 82 and the xyz
of one RandLA sampler batch of 4 × 40960 points of phase 4 (synthetic
rooms prepared at 0.04 m). ``time`` imports ``pointsecguard_tpu_torch``
from ``--root`` (default: this checkout), builds its kernels there, and
for each row prints the card's time of one call (``device_ms``: calls
queued behind a spin kernel) and an eager call's (CUDA events, median):

- ``psg::bottom_k_chunked`` on the 10,000-point classifier's ball query,
  [16, 512, 10000] k = 32 (index values, the sentinel 10000 out of radius
  0.2, around FPS's 512 centres from index 0), and on the tiled kNN
  route's distances, [4, 4096, 40960] k = 16; ``torch.topk`` beside both;
- ``psg::fps`` at [16, 10000] → 512 from index 0, [8, 16384] → 1024 and
  the seams [2, 8192], [2, 8193], [2, 65536], [2, 65537], [2, 131072] and
  [2, 131073] → 256 from random starts (clouds of ``torch.rand`` from a
  generator seeded 82, as phase 82 draws them), with the kernel each took
  where the port counts it.

``--check`` first holds every row equal to its plain version. The JSON
line carries the card's name and power limit. To compare two trees, run
``time`` for each on the same card in turns (parent, change, change,
parent); to try a constant of ``csrc/``, run it on a copy with the
constant changed (the library's name hashes the sources).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOM_POINTS = 400_000  # chip_smoke.py's synthetic rooms
RANDLA_POINTS, RANDLA_BATCH = 40960, 4
CLS_POINTS, CLS_PER_CLASS = 10_000, 4
FPS_ROWS = ((16, 10000, 512, "zero"), (8, 16384, 1024, "random"),
            (2, 8192, 256, "random"), (2, 8193, 256, "random"),
            (2, 65536, 256, "random"), (2, 65537, 256, "random"),
            (2, 131072, 256, "random"), (2, 131073, 256, "random"))


def make(path: str) -> None:
    import numpy as np
    import torch

    from pointsecguard_tpu_torch.data import make_synthetic_rooms
    from pointsecguard_tpu_torch.data.modelnet import ModelNetDataset, make_synthetic_modelnet
    from pointsecguard_tpu_torch.data.randla import SpatiallyRegularSampler, prepare_room

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(path))) as work:
        root = os.path.join(work, "modelnet_10k")
        make_synthetic_modelnet(root, points_per_shape=CLS_POINTS, train_per_class=1,
                                test_per_class=CLS_PER_CLASS, seed=1)
        ds = ModelNetDataset(root, "test", num_point=CLS_POINTS)
        cls_xyz = np.stack([ds.load(i)[0][:, :3] for i in range(len(ds))])
        rooms, prep = os.path.join(work, "data"), os.path.join(work, "randla")
        make_synthetic_rooms(rooms, points_per_room=ROOM_POINTS, seed=0)
        for name in sorted(os.listdir(rooms)):
            prepare_room(os.path.join(rooms, name), prep, 0.04,
                         original_dir=os.path.join(work, "original_ply"))
        sampler = SpatiallyRegularSampler.load(prep, split="test", num_points=RANDLA_POINTS,
                                               rng=np.random.default_rng(7))
        _, feats, _, _, _ = next(sampler.batches(RANDLA_BATCH, 1))
    torch.save({"cls_xyz": torch.from_numpy(cls_xyz),
                "randla_xyz": torch.from_numpy(feats[..., :3].copy())}, path)
    print(f"wrote {path}: cls_xyz {tuple(cls_xyz.shape)}, randla_xyz {tuple(feats.shape[:2])}")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _eager_ms(fn, reps: int = 20) -> float:
    import statistics

    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_rows(args) -> dict:
    root = os.path.abspath(args.root)
    import torch

    import pointsecguard_tpu_torch
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked, build, fps

    pkg = os.path.dirname(os.path.realpath(pointsecguard_tpu_torch.__file__))
    if pkg != os.path.join(os.path.realpath(root), "pointsecguard_tpu_torch"):
        raise RuntimeError(f"imported the port from {pkg}, not from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no card: these are times on the card")
    dev = torch.device("cuda")
    build.load_library()
    inputs = torch.load(args.inputs)
    rows = []

    def row(name, kern, plain, **extra):
        if args.check:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(got, want)) if isinstance(got, tuple)
                    else torch.equal(got, want))
            if not same:
                raise AssertionError(f"{name}: kernel != plain")
        rec = {"row": name, "ms": _device_ms(kern), "eager_ms": _eager_ms(kern), **extra}
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    if args.only in (None, "bottom_k"):
        from pointsecguard_tpu_torch.models.pointnet2_cls import CLS_SSG_SPEC
        from pointsecguard_tpu_torch.ops import gather_points, square_distance

        xyz = inputs["cls_xyz"].to(dev)
        npoint, (radius,), (k,) = CLS_SSG_SPEC[0]
        centers = gather_points(xyz, fps.fps(xyz, npoint, torch.zeros(
            xyz.shape[0], dtype=torch.int32, device=dev)))
        sqr = square_distance(centers, xyz)
        n = xyz.shape[1]
        ball = torch.where(sqr > radius * radius, float(n),
                           torch.arange(n, dtype=torch.float32, device=dev))
        rxyz = inputs["randla_xyz"].to(dev)
        dists = square_distance(rxyz[:, :4096], rxyz)
        for what, vals, kk in (("ball query", ball, k), ("tiled kNN route", dists, 16)):
            extra = {"topk_ms": _device_ms(lambda: torch.topk(vals, kk, dim=-1, largest=False,
                                                              sorted=True))}
            if hasattr(bottomk_chunked, "overflow_rows"):
                extra["overflow_rows"] = bottomk_chunked.overflow_rows(vals, kk)
            row(f"bottom_k_chunked {what} {list(vals.shape)} k={kk}",
                lambda: bottomk_chunked.bottom_k_chunked(vals, kk),
                lambda: bottomk.bottom_k_plain(vals, kk), **extra)
        del ball, dists, sqr
    if args.only in (None, "fps"):
        gen = torch.Generator(device=dev).manual_seed(82)
        for b, n, npoint, kind in FPS_ROWS:
            cloud = torch.rand((b, n, 3), generator=gen, device=dev)
            start = (torch.zeros(b, dtype=torch.int32, device=dev) if kind == "zero" else
                     torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32))
            kernels.reset_launch_counts()
            fps.fps(cloud, npoint, start)
            counts = kernels.launch_counts()
            took = ("fps_stream" if counts.get("fps_stream") else
                    "fps_cluster" if counts.get("fps_cluster") else "fps")
            row(f"fps [{b}, {n}] -> {npoint}", lambda: fps.fps(cloud, npoint, start),
                lambda: fps.fps_plain(cloud, npoint, start), kernel=took)
            rows[-1]["ns_per_step"] = 1e6 * rows[-1]["ms"] / (npoint - 1)
    out = {"label": args.label or root, "card": _card(), "rows": rows}
    print(json.dumps(out))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make", help="write the rows' sources")
    mk.add_argument("--inputs", required=True)
    tm = sub.add_parser("time", help="time the rows on the card")
    tm.add_argument("--inputs", required=True)
    tm.add_argument("--root", default=REPO, help="checkout whose port to time")
    tm.add_argument("--label", default=None)
    tm.add_argument("--only", choices=("bottom_k", "fps"), default=None)
    tm.add_argument("--check", action="store_true", help="each row equal to plain first")
    args = ap.parse_args(argv)
    # the port of --root (the rows' sources: of this checkout), not one
    # found elsewhere on the path
    sys.path.insert(0, os.path.abspath(getattr(args, "root", REPO)))
    if args.cmd == "make":
        make(args.inputs)
    else:
        time_rows(args)


if __name__ == "__main__":
    main()
