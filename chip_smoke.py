#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. ``require_cuda()``; print the card's name and power limit.
2. Build the port's CUDA kernels from ``pointsecguard_tpu_torch/csrc``.
3. FPS and bottom-k against their plain PyTorch versions on the card, at
   the shapes one ``build_geometry`` of a batch of 8 × 4096-point blocks
   gives them: FPS indices equal at all four levels; bottom-k values and
   indices equal on the ball-query and 3-NN inputs and on tie-heavy
   rounded values; the contracts' edges (N at the limit, npoint > N,
   k == N) and refusal past the limit. Median times of kernel and plain
   (CUDA events, after warm-up).
4. kNN and wide-row bottom-k against their plain versions on the card:
   kNN at every ``build_pyramid`` shape of a batch of 4 × 40960-point
   RandLA clouds (k=16 and k=1), at [1, 4096, 64] k=16 and k=48 and on
   tie-heavy [2, 2048, 4] k=8; wide-row
   bottom-k on [4, 4096, 40960] k=16 pyramid distances, on tie-heavy
   rounded values and at its edges (N = 8193, k = 48, N = 2^20); refusal
   past the bounds. Values and indices equal; median times of kernel and
   plain, per shape and per ``build_pyramid``.
5. The two kNN routes at full size: the 40960² level through the fused
   kernel and through the tiled route (``square_distance`` + wide-row
   bottom-k, tile 4096) give identical indices.
6. The PointNet++ slice: synthetic rooms at 25k points/m², a full-width
   PointNet++ SSG checkpoint with seeded random weights (BatchNorm
   statistics from one forward over synthetic blocks), and the NB attack
   through ``pointsecguard_tpu_torch.cli.attack.main`` on 32 blocks of
   4096 points at batch 8. FPS and bottom-k must have launched on that
   run; then the model on the card (kernels) against the same model on
   the CPU (plain versions) on two blocks.
7. The RandLA slice: the same rooms prepared at 0.04 m (the Area-5 cloud
   keeps ≥ 40960 points, so nothing is up-sampled), a full-width RandLA
   checkpoint with seeded random weights (BatchNorm statistics from one
   train-mode forward), and the NB attack through the same CLI on 8
   clouds of 40960 points at batch 4: exactly 10 kNN launches per batch,
   finite output, mean adversarial accuracy below mean clean accuracy.
   Then card vs CPU on one 8192-point cloud: pyramid indices equal at
   every level, logits within 1e-4 of the largest magnitude.

The last lines are the kernels' JSON record, the card's name and power
limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}``.
Work files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
BATCH, NUM_POINT, MAX_BLOCKS = 8, 4096, 32
STATE_FLOATS = 975_949  # full-width SSG: parameters + BN running stats
RANDLA_BATCH, RANDLA_POINTS, RANDLA_CLOUDS = 4, 40960, 8
RANDLA_STATE_FLOATS = 5_010_981  # full-width S3DIS RandLA-Net
ROOM_POINTS = 400_000  # synthetic 4 × 4 m rooms at 25k points/m²


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slice_blocks(dev) -> torch.Tensor:
    """[8, 4096, 9]: four blocks of a synthetic room at 25k points/m²
    (padded with repeated points, as WholeSceneBlocks pads) and four
    uniform-noise clouds."""
    from pointsecguard_tpu_torch.data import RoomSet, WholeSceneBlocks
    from pointsecguard_tpu_torch.data.synthetic import make_room

    rng = np.random.default_rng(1)
    room = make_room(400_000, rng=rng)
    rooms = RoomSet(["smoke"], [room[:, :6]], [room[:, 6].astype(np.int64)],
                    [room[:, :3].min(0)], [room[:, :3].max(0)])
    data, *_ = WholeSceneBlocks(rooms, block_points=NUM_POINT).room_blocks(0, rng)
    noise = rng.random((4, NUM_POINT, 9), dtype=np.float32)
    return torch.from_numpy(np.concatenate([data[:4], noise])).to(dev)


def geometry_inputs(xyz: torch.Tensor):
    """The FPS inputs and the bottom-k inputs of one build_geometry."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.models.pointnet2 import (
        SSG_NPOINTS, SSG_NSAMPLES, SSG_RADII,
    )

    fps_in, bk_in, levels = [], [], [xyz]
    for npoint, radius, nsample in zip(SSG_NPOINTS, SSG_RADII, SSG_NSAMPLES):
        cur = levels[-1]
        fps_in.append((cur, npoint))
        centers = ops.gather_points(cur, ops.farthest_point_sample(cur, npoint))
        n = cur.shape[1]
        sqr = ops.square_distance(centers, cur)
        arange = torch.arange(n, dtype=torch.float32, device=cur.device)
        bk_in.append((torch.where(sqr > radius * radius, float(n), arange), nsample))
        levels.append(centers)
    for li in range(4):
        bk_in.append((ops.square_distance(levels[li], levels[li + 1]), 3))
    return fps_in, bk_in


def phase_kernels(dev, records):
    from pointsecguard_tpu_torch.ops.cuda import bottomk, fps

    xyz = slice_blocks(dev)[..., :3].contiguous()
    fps_in, bk_in = geometry_inputs(xyz)
    start = torch.zeros(xyz.shape[0], dtype=torch.int32, device=dev)
    fps_err = 0.0  # largest index difference
    for cur, npoint in fps_in:
        got = fps.fps(cur, npoint, start)
        want = fps.fps_plain(cur, npoint, start)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fps kernel != plain at {tuple(cur.shape)}->{npoint}")
        fps_err = max(fps_err, (got - want).abs().max().item())
        print(f"fps {tuple(cur.shape)} -> {npoint}: indices equal")

    rounded = torch.round(torch.randn(
        (8, 1024, 4096), generator=torch.Generator(device=dev).manual_seed(0),
        device=dev) * 20) / 20
    bk_err = 0.0
    for vals, k in bk_in + [(rounded, 3), (rounded, 32)]:
        gv, gi = bottomk.bottom_k(vals, k)
        wv, wi = bottomk.bottom_k_plain(vals, k)
        torch.cuda.synchronize()
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(f"bottom_k kernel != plain at {tuple(vals.shape)} k={k}")
        bk_err = max(bk_err, (gv - wv).abs().max().item())
        print(f"bottom_k {tuple(vals.shape)} k={k}: values and indices equal")

    # the contracts' edges: N at the limit, npoint > N (wrap onto index 0),
    # a nonzero start, k == N with sentinel ties, and refusal past the limit
    gen = torch.Generator(device=dev).manual_seed(1)
    for n, npoint, s in ((8192, 1024, 5), (500, 1024, 7), (1, 4, 0)):
        cloud = torch.rand((2, n, 3), generator=gen, device=dev)
        st = torch.full((2,), s, dtype=torch.int32, device=dev)
        if not torch.equal(fps.fps(cloud, npoint, st), fps.fps_plain(cloud, npoint, st)):
            raise AssertionError(f"fps kernel != plain at N={n} npoint={npoint}")
    sentinel = torch.where(torch.rand((8, 16, 32), generator=gen, device=dev) < 0.7,
                           32.0, torch.arange(32.0, device=dev))
    for vals, k in ((torch.rand((2, 64, 8192), generator=gen, device=dev), 48),
                    (sentinel, 32), (torch.rand((3, 8, 1), generator=gen, device=dev), 1)):
        gv, gi = bottomk.bottom_k(vals, k)
        wv, wi = bottomk.bottom_k_plain(vals, k)
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(f"bottom_k kernel != plain at {tuple(vals.shape)} k={k}")
    for call in (lambda: fps.fps(torch.zeros((1, 8193, 3), device=dev), 4, start[:1]),
                 lambda: bottomk.bottom_k(torch.zeros((1, 8, 8193), device=dev), 4)):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("a kernel took a shape past its limit")
    print("contract edges: N at 8192, npoint > N, k == N, N = 1 equal to plain; "
          "N = 8193 refused")

    # times at the slice's shapes: all launches of one build_geometry
    def run_fps(f):
        return lambda: [f(cur, n, start) for cur, n in fps_in]

    def run_bk(f):
        return lambda: [f(v, k) for v, k in bk_in]

    for name, kern, plain, fn, reps in (
        ("fps", fps.fps, fps.fps_plain, run_fps, 5),
        ("bottom_k", bottomk.bottom_k, bottomk.bottom_k_plain, run_bk, 20),
    ):
        ms = cuda_ms(fn(kern), reps=20)
        plain_ms = cuda_ms(fn(plain), reps=reps)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
              f"build_geometry of [{BATCH}, {NUM_POINT}] (median)")
        records[name].update(ms=ms, plain_ms=plain_ms)
    records["fps"]["max_abs_err"] = fps_err
    records["bottom_k"]["max_abs_err"] = bk_err
    for cur, n in fps_in:
        ms = cuda_ms(lambda: fps.fps(cur, n, start), reps=20)
        print(f"  fps {tuple(cur.shape)} -> {n}: {ms:.4f} ms")
    for v, k in bk_in:
        ms = cuda_ms(lambda: bottomk.bottom_k(v, k), reps=20)
        print(f"  bottom_k {tuple(v.shape)} k={k}: {ms:.4f} ms")


def random_state_dict(seed: int) -> dict:
    """Full-width SSG weights from a seeded generator: Linear weights and
    biases uniform in ±1/sqrt(fan_in) (torch's default bound); BatchNorm
    at its initial scale 1, bias 0, mean 0, var 1."""
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG

    gen = torch.Generator().manual_seed(seed)
    sd = PointNet2SemSegSSG().state_dict()
    for key, t in sd.items():
        if key.endswith(("dense.weight", "dense.bias", "cls.weight", "cls.bias")):
            fan_in = sd[key.rsplit(".", 1)[0] + ".weight"].shape[1]
            bound = 1.0 / math.sqrt(fan_in)
            t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)
    n = sum(t.numel() for t in sd.values())
    if n != STATE_FLOATS:
        raise AssertionError(f"state dict holds {n} floats, want {STATE_FLOATS}")
    return sd


def calibrated_state_dict(seed: int, dev) -> dict:
    """``random_state_dict`` with BatchNorm running statistics set from
    one train-mode forward over four synthetic blocks (keep fraction 0),
    so the random network's predictions vary from point to point and the
    attack has decisions to flip."""
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG

    model = PointNet2SemSegSSG()
    model.load_state_dict(random_state_dict(seed))
    model.to(dev).train()
    with torch.no_grad():
        model(slice_blocks(dev)[:4], momentum=0.0)
    return model.state_dict()


def phase_slice(dev, records, data: str) -> dict:
    from pointsecguard_tpu_torch.cli import attack
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    log = os.path.join(WORK, "log")
    save_checkpoint(log, calibrated_state_dict(0, dev))
    argv = ["--model", "pointnet2", "--attack", "nb", "--data_root", data,
            "--log_dir", log, "--num_point", str(NUM_POINT),
            "--batch_size", str(BATCH), "--max_blocks", str(MAX_BLOCKS)]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clean_m, adv_m = attack.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    rows = []
    with open(os.path.join(log, "pointnet2_nb_area5.tsv")) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            rows.append(dict(zip(header, line.rstrip("\n").split("\t"))))
    if len(rows) < MAX_BLOCKS:
        raise AssertionError(f"{len(rows)} TSV rows, want {MAX_BLOCKS}")
    col = {c: np.array([float(r[c]) for r in rows]) for c in
           ("clean_acc", "adv_acc", "l2", "time_s")}
    iters = int(rows[0]["steps"])
    # each row carries its batch's wall time / batch size
    ms_block = 1e3 * col["time_s"]
    warm = ms_block[BATCH:]  # the first batch pays one-off CUDA set-up
    stats = {
        "blocks": len(rows),
        "nb_iters": iters,
        "ms_per_block_mean": float(ms_block.mean()),
        "ms_per_block_warm_median": float(np.median(warm)),
        "wall_nb_iters_per_s": len(rows) * iters / float(col["time_s"].sum()),
        "main_wall_s": wall,
        "clean_acc": float(col["clean_acc"].mean()),
        "adv_acc": float(col["adv_acc"].mean()),
        "l2_mean": float(col["l2"].mean()),
        "clean_miou": clean_m.miou,
        "adv_miou": adv_m.miou,
        "launches": counts,
    }
    print("slice: " + json.dumps(stats))
    values = [v for c in col.values() for v in c] + [clean_m.miou, adv_m.miou]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("non-finite value in the slice's output")
    for name in ("fps", "bottom_k"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
        records[name]["launches"] = counts[name]
    return stats


def phase_reference(dev) -> None:
    """Port on the card (kernels) vs the port on the CPU (plain versions)
    on two blocks: FPS indices equal, ball-query / 3-NN agreement, and
    log-probabilities on the same geometry within 1e-4 of the largest."""
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, build_geometry

    model = PointNet2SemSegSSG()
    model.load_state_dict(calibrated_state_dict(1, dev))
    model.eval()
    pts = slice_blocks(dev)[[0, 4]]
    geo_gpu = build_geometry(pts[..., :3])
    geo_cpu = build_geometry(pts[..., :3].cpu())
    for li in range(4):
        if not torch.equal(geo_gpu["sa"][li][0].cpu(), geo_cpu["sa"][li][0]):
            raise AssertionError(f"FPS centres differ card vs CPU at level {li}")
    # ball-query groups (sa, item 1) and 3-NN indices (fp, item 0): the
    # distance product may round differently on the card than on the CPU
    agree = [
        (geo_gpu[part][li][item].cpu() == geo_cpu[part][li][item]).float().mean().item()
        for part, item in (("sa", 1), ("fp", 0)) for li in range(4)
    ]
    if min(agree) < 0.999:
        raise AssertionError(f"card/CPU neighbour agreement {min(agree)} < 0.999")
    geo_shared = {k: tuple(tuple(t.cpu() for t in p) for p in v)
                  for k, v in geo_gpu.items()}
    with torch.no_grad():
        lp_gpu = model.to(dev)(pts, geometry=geo_gpu)[0].cpu()
        lp_cpu = model.cpu()(pts.cpu(), geometry=geo_shared)[0]
    # float32 sums run in another order on the card than on the CPU; the
    # difference grows with the magnitude of what is summed, so the bound
    # is relative to the largest log-probability
    err = (lp_gpu - lp_cpu).abs().max().item()
    tol = 1e-4 * max(1.0, lp_cpu.abs().max().item())
    print(f"reference: card vs CPU log-probs max |diff| {err:.3e} "
          f"(tolerance {tol:.3e}); neighbour agreement min {min(agree):.6f}")
    if not (lp_gpu.shape == (2, NUM_POINT, 13) and torch.isfinite(lp_gpu).all()
            and err <= tol):
        raise AssertionError("card log-probs disagree with the CPU reference")


def prepare_randla(data: str) -> str:
    """The synthetic rooms prepared as RandLA clouds (0.04 m grid, KD-tree,
    projection); the Area-5 cloud must keep ≥ 40960 points."""
    from pointsecguard_tpu_torch.data.randla import SpatiallyRegularSampler, prepare_room

    prep = os.path.join(WORK, "randla_input_0.040")
    for name in sorted(os.listdir(data)):
        prepare_room(os.path.join(data, name), prep, 0.04)
    sizes = {c.name: len(c.labels) for c in
             SpatiallyRegularSampler.load(prep, split="test").clouds}
    print(f"randla clouds (test split, 0.04 m grid): {sizes}")
    if min(sizes.values()) < RANDLA_POINTS:
        raise AssertionError(f"a test cloud holds fewer than {RANDLA_POINTS} points")
    return prep


def randla_batch(prep: str, dev, num_points: int = RANDLA_POINTS, batch: int = RANDLA_BATCH):
    """One sampler batch of features [B, P, 6] on the card."""
    from pointsecguard_tpu_torch.data.randla import SpatiallyRegularSampler

    sampler = SpatiallyRegularSampler.load(prep, split="test", num_points=num_points,
                                           rng=np.random.default_rng(7))
    _, feats, _, _, _ = next(sampler.batches(batch, 1))
    return torch.from_numpy(feats).to(dev)


def pyramid_knn_inputs(xyz: torch.Tensor):
    """The (query, points, k) of every kNN call of one build_pyramid."""
    calls, cur = [], xyz
    for ratio in (4, 4, 4, 4, 2):
        sub = cur[:, : cur.shape[1] // ratio]
        calls += [(cur, cur, 16), (cur, sub, 1)]
        cur = sub
    return calls


def _equal(name, got, want) -> float:
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{name}: kernel != plain")
    return (got[0] - want[0]).abs().max().item()


def phase_randla_kernels(dev, records, xyz):
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked, knn
    from pointsecguard_tpu_torch.ops.distance import square_distance

    calls = pyramid_knn_inputs(xyz)
    gen = torch.Generator(device=dev).manual_seed(2)
    feat64 = torch.randn((1, 4096, 64), generator=gen, device=dev)
    feat4 = torch.round(torch.randn((2, 2048, 4), generator=gen, device=dev) * 4) / 4
    knn_err = 0.0
    # the pyramid's calls (D = 3 kernel, k = 1 and 16), then the any-D
    # kernel, with k below its list size (8 of 16) and at the bound (48)
    for q, p, k in calls + [(feat64, feat64, 16), (feat4, feat4, 8),
                            (feat64[:, :1024], feat64, 48)]:
        knn_err = max(knn_err, _equal(f"knn {tuple(q.shape)} x {tuple(p.shape)} k={k}",
                                      knn.knn(q, p, k), knn.knn_plain(q, p, k)))
        print(f"knn {tuple(q.shape)} x {tuple(p.shape)} k={k}: values and indices equal")

    dists = square_distance(xyz[:, :4096], xyz)  # a tile of the tiled route
    rounded = torch.round(dists * 4) / 4
    bk_err = 0.0
    for vals, k in ((dists, 16), (rounded, 16),
                    (torch.rand((2, 64, 8193), generator=gen, device=dev), 48),
                    (torch.rand((1, 4, 1 << 20), generator=gen, device=dev), 16)):
        bk_err = max(bk_err, _equal(f"bottom_k_chunked {tuple(vals.shape)} k={k}",
                                    bottomk_chunked.bottom_k_chunked(vals, k),
                                    bottomk.bottom_k_plain(vals, k)))
        print(f"bottom_k_chunked {tuple(vals.shape)} k={k}: values and indices equal")
    refused = (
        lambda: knn.knn(xyz[:, :64], xyz[:, :64], 49),
        lambda: knn.knn(xyz[:, :8], xyz[:, :8], 9),
        lambda: bottomk_chunked.bottom_k_chunked(dists[:1, :1], 49),
        lambda: bottomk_chunked.bottom_k_chunked(
            torch.zeros((1, bottomk_chunked.MAX_N + 1), device=dev), 4),
    )
    for call in refused:
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("a kernel took a shape past its bounds")
    print("contract edges: N = 8193, k = 48, N = 2^20 equal to plain; "
          "k = 49, k > N, N > 2^22 refused")

    def run_knn(f):
        return lambda: [f(q, p, k) for q, p, k in calls]

    for name, kern, plain, fn, arg, what in (
        ("knn", knn.knn, knn.knn_plain, run_knn, None,
         f"build_pyramid of [{RANDLA_BATCH}, {RANDLA_POINTS}] (10 calls)"),
        ("bottom_k_chunked", bottomk_chunked.bottom_k_chunked, bottomk.bottom_k_plain,
         None, dists, f"[{RANDLA_BATCH}, 4096, {RANDLA_POINTS}] k=16"),
    ):
        if fn is not None:
            ms, plain_ms = cuda_ms(fn(kern), reps=10), cuda_ms(fn(plain), reps=3)
        else:
            ms = cuda_ms(lambda: kern(arg, 16), reps=20)
            plain_ms = cuda_ms(lambda: plain(arg, 16), reps=5)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per {what} (median)")
        records[name].update(ms=ms, plain_ms=plain_ms)
    records["knn"]["max_abs_err"] = knn_err
    records["bottom_k_chunked"]["max_abs_err"] = bk_err
    for q, p, k in calls:
        ms = cuda_ms(lambda: knn.knn(q, p, k), reps=10)
        print(f"  knn {tuple(q.shape)} x {tuple(p.shape)} k={k}: {ms:.4f} ms")


def phase_routes(records, xyz) -> None:
    """The 40960² level through the fused kernel and through the tiled
    route (square_distance + wide-row bottom-k on tiles of 4096)."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.ops import cuda as kernels

    fused = ops.knn(xyz, xyz, 16, strategy="fused")
    kernels.reset_launch_counts()
    tiled = ops.knn(xyz, xyz, 16, tile=4096, strategy="pallas")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if not torch.equal(fused[1], tiled[1]):
        raise AssertionError("fused and tiled kNN routes give different indices")
    if counts["bottom_k_chunked"] != RANDLA_POINTS // 4096:
        raise AssertionError(f"tiled route launches: {counts}")
    records["bottom_k_chunked"]["launches"] = counts["bottom_k_chunked"]
    print(f"routes: fused and tiled kNN indices identical at {tuple(xyz.shape)} k=16; "
          f"launches on the tiled route {counts}")


def randla_state_dict(seed: int, dev, feats) -> dict:
    """Full-width RandLA weights from a seeded generator (Linear weights
    and biases uniform in ±1/sqrt(fan_in), BatchNorm at scale 1, bias 0)
    with BatchNorm statistics from one train-mode forward over ``feats``
    (keep fraction 0)."""
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

    gen = torch.Generator().manual_seed(seed)
    model = RandLANet()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for t in (mod.weight, mod.bias):
                    if t is not None:
                        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)
    n = sum(t.numel() for t in model.state_dict().values())
    if n != RANDLA_STATE_FLOATS:
        raise AssertionError(f"RandLA state holds {n} floats, want {RANDLA_STATE_FLOATS}")
    model.to(dev).train()
    with torch.no_grad():
        model(feats, build_pyramid(feats[..., :3]), momentum=0.0)
    return model.state_dict()


def phase_randla(dev, records, prep: str) -> dict:
    from pointsecguard_tpu_torch.cli import attack
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    log = os.path.join(WORK, "randla_log")
    save_checkpoint(log, randla_state_dict(0, dev, randla_batch(prep, dev)))
    argv = ["--model", "randla", "--attack", "nb", "--randla_dir", prep,
            "--log_dir", log, "--num_clouds", str(RANDLA_CLOUDS),
            "--batch_size", str(RANDLA_BATCH)]

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clean_m, adv_m = attack.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    with open(os.path.join(log, "randla_nb_area5.tsv")) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [dict(zip(header, line.rstrip("\n").split("\t"))) for line in f]
    if len(rows) != RANDLA_CLOUDS:
        raise AssertionError(f"{len(rows)} TSV rows, want {RANDLA_CLOUDS}")
    col = {c: np.array([float(r[c]) for r in rows]) for c in
           ("clean_acc", "adv_acc", "l2", "time_s")}
    iters = int(rows[0]["steps"])
    ms_cloud = 1e3 * col["time_s"]  # each row: its batch's wall / batch size
    stats = {
        "clouds": len(rows),
        "points": RANDLA_POINTS,
        "nb_iters": iters,
        "ms_per_cloud_mean": float(ms_cloud.mean()),
        "ms_per_cloud_warm_median": float(np.median(ms_cloud[RANDLA_BATCH:])),
        "wall_nb_iters_per_s": len(rows) * iters / float(col["time_s"].sum()),
        "main_wall_s": wall,
        "clean_acc": float(col["clean_acc"].mean()),
        "adv_acc": float(col["adv_acc"].mean()),
        "l2_mean": float(col["l2"].mean()),
        "clean_miou": clean_m.miou,
        "adv_miou": adv_m.miou,
        "launches": counts,
    }
    print("randla slice: " + json.dumps(stats))
    values = [v for c in col.values() for v in c] + [clean_m.miou, adv_m.miou]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("non-finite value in the RandLA slice's output")
    if counts["knn"] != 10 * RANDLA_CLOUDS // RANDLA_BATCH:
        raise AssertionError(f"kNN launches {counts['knn']}, want 10 per batch")
    if not stats["adv_acc"] < stats["clean_acc"]:
        raise AssertionError("the NB attack did not lower the mean accuracy")
    records["knn"]["launches"] = counts["knn"]
    return stats


def phase_randla_reference(dev, prep: str) -> None:
    """RandLA on the card (kernels) vs on the CPU (plain versions) on one
    8192-point cloud: pyramid indices equal at every level; logits on the
    same pyramid within 1e-4 of the largest magnitude."""
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

    feats = randla_batch(prep, dev, num_points=8192, batch=1)
    model = RandLANet()
    model.load_state_dict(randla_state_dict(1, dev, feats))
    model.eval()
    pyr_gpu = build_pyramid(feats[..., :3])
    pyr_cpu = build_pyramid(feats[..., :3].cpu())
    for key in ("neigh_idx", "sub_idx", "interp_idx"):
        for level, (g, c) in enumerate(zip(pyr_gpu[key], pyr_cpu[key])):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"card/CPU pyramid {key}[{level}] differ")
    with torch.no_grad():
        lg = model.to(dev)(feats, pyr_gpu).cpu()
        lc = model.cpu()(feats.cpu(), pyr_cpu)
    # float32 sums run in another order on the card than on the CPU; the
    # bound is relative to the largest logit
    err = (lg - lc).abs().max().item()
    tol = 1e-4 * max(1.0, lc.abs().max().item())
    print(f"randla reference: pyramid indices equal card vs CPU at all 5 levels; "
          f"logits max |diff| {err:.3e} (tolerance {tol:.3e})")
    if not (lg.shape == (1, 8192, 13) and torch.isfinite(lg).all() and err <= tol):
        raise AssertionError("card RandLA logits disagree with the CPU reference")


def main() -> int:
    import pointsecguard_tpu_torch
    from pointsecguard_tpu_torch.ops.cuda import build
    from pointsecguard_tpu_torch.utils.runtime import require_cuda

    # the port and its kernel sources must be this checkout's, never an
    # installed copy found elsewhere on the path
    pkg = os.path.dirname(os.path.realpath(pointsecguard_tpu_torch.__file__))
    if pkg != os.path.join(os.path.realpath(REPO), "pointsecguard_tpu_torch"):
        raise RuntimeError(f"pointsecguard_tpu_torch imported from {pkg}, "
                           f"not from the checkout at {REPO}")
    dev = require_cuda()
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({build.library_path().name})")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    records = {
        "fps": {"name": "fps", "route": "cuda",
                "source": "pointsecguard_tpu_torch/csrc/fps.cu",
                "replaces": "pointsecguard_tpu/ops/pallas/fps.py:27"},
        "bottom_k": {"name": "bottom_k", "route": "cuda",
                     "source": "pointsecguard_tpu_torch/csrc/bottomk.cu",
                     "replaces": "pointsecguard_tpu/ops/pallas/bottomk.py:66"},
        "knn": {"name": "knn", "route": "cuda",
                "source": "pointsecguard_tpu_torch/csrc/knn.cu",
                "replaces": "pointsecguard_tpu/ops/pallas/knn.py:52"},
        "bottom_k_chunked": {"name": "bottom_k_chunked", "route": "cuda",
                             "source": "pointsecguard_tpu_torch/csrc/bottomk_chunked.cu",
                             "replaces": "pointsecguard_tpu/ops/pallas/bottomk.py:206"},
    }
    from pointsecguard_tpu_torch.data import make_synthetic_rooms

    data = os.path.join(WORK, "data")
    make_synthetic_rooms(data, points_per_room=ROOM_POINTS, seed=0)
    prep = prepare_randla(data)
    phase_kernels(dev, records)
    xyz = randla_batch(prep, dev)[..., :3].contiguous()
    phase_randla_kernels(dev, records, xyz)
    phase_routes(records, xyz)
    del xyz
    phase_slice(dev, records, data)
    phase_reference(dev)
    phase_randla(dev, records, prep)
    phase_randla_reference(dev, prep)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
