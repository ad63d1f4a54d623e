#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. ``require_cuda()``; print the card's name and power limit.
2. Build the port's CUDA kernels from ``pointsecguard_tpu_torch/csrc``.
3. Each kernel against its plain PyTorch version on the card, at the
   shapes one ``build_geometry`` of a batch of 8 × 4096-point blocks gives
   it: FPS indices equal at all four levels; bottom-k values and indices
   equal on the ball-query and 3-NN inputs and on tie-heavy rounded
   values; the contracts' edges (N at the limit, npoint > N, k == N) and
   refusal past the limit. Median times of kernel and plain (CUDA
   events, after warm-up).
4. The slice: synthetic rooms at 25k points/m², a full-width PointNet++
   SSG checkpoint with seeded random weights (BatchNorm statistics from
   one forward over synthetic blocks), and the NB attack through
   ``pointsecguard_tpu_torch.cli.attack.main`` on 32 blocks of 4096
   points at batch 8. Both kernels must have launched on that run.
5. Reference check on a small input: the model on the card (kernels)
   against the same model on the CPU (plain versions).

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


def phase_slice(dev, records) -> dict:
    from pointsecguard_tpu_torch.cli import attack
    from pointsecguard_tpu_torch.data import make_synthetic_rooms
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    data, log = os.path.join(WORK, "data"), os.path.join(WORK, "log")
    make_synthetic_rooms(data, points_per_room=400_000, seed=0)
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
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
        records[name]["launches"] = n
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
    }
    phase_kernels(dev, records)
    phase_slice(dev, records)
    phase_reference(dev)

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
