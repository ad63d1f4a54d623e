#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels_only]

Phases, each of which raises (and the script exits non-zero) on failure:

1. ``require_cuda()``; print the card's name and power limit.
2. Build the port's CUDA kernels from ``pointsecguard_tpu_torch/csrc``.
3. FPS and bottom-k against their plain PyTorch versions on the card, at
   the shapes one ``build_geometry`` of a batch of 8 × 4096-point blocks
   gives them: FPS indices equal at all four levels; bottom-k values and
   indices equal on the ball-query and 3-NN inputs, on the C&W smooth
   term's colour distances ([8, 4096, 4096], k = 10 and 5) and on
   tie-heavy rounded values; the contracts' edges (FPS: N = 1, 33, 500,
   1000, 4097 and 8192, npoint > N, the start at N − 1, identical and
   rounded points, a start outside the cloud; bottom-k: k == N up to
   8192, k = 1, 48, 129) and the orders that stress the selection
   (descending and constant rows, ±inf, widths off 4 and off 128);
   refusal past the limit. Times of kernel and plain, per level, and the
   time of one dependent FPS step.
4. kNN and wide-row bottom-k against their plain versions on the card:
   kNN at every ``build_pyramid`` shape of a batch of 4 × 40960-point
   RandLA clouds (k=16 and k=1), at [1, 4096, 64] k=16 and k=48, on
   tie-heavy [2, 2048, 4] k=8 and on the orders and shapes that stress its
   deferred insertion (points sorted far → near and near → far from
   huddled queries, a constant and a duplicated cloud, S and N off the
   block, tile and group sizes, k == N == 16, one query, ``query is
   points`` and a distinct query, k = 17 and 48 at D = 3); wide-row
   bottom-k on [4, 4096, 40960] k=16 pyramid distances, on tie-heavy
   rounded values and at its edges (N = 8193, k = 48, N = 2^20); refusal
   past the bounds. Values and indices equal; median times of kernel and
   plain, per shape and per ``build_pyramid``, and of the far → near and
   near → far orders beside the random one.
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
8. The fused attentive-pooling kernels (forward and backward) against
   their plain version at the shapes of one RandLA batch ([16, 163840, 8]
   and [16, 40960, 32], with and without dW) and at the contract's edges
   (M = 1, M off the row tile, D = 1, 5, 8, 12, 32, 63, K = 4 and 16); dW
   the same on two runs; refusal past the bounds; times of kernel and
   plain per RandLA forward (4 calls) and per backward.
9. The full-width RandLA with ``ap_impl="fused"`` against the reference
   composition on one sampler batch: logits within 1e-4 of the largest;
   the colour gradient as close to a float64 evaluation as the float32
   reference's, within a factor of 2.
10. RandLA NB through the CLI with and without ``--fused_ap``, in turns
    (reference, fused, fused, reference): ms/cloud of each; 4 forward
    and 4 backward attentive-kernel launches per model forward / backward
    with the flag, none without.
11. RandLA NU through the CLI: one batch of 4 clouds, the preset's 1000
    steps or its early exit, with ``--fused_ap`` and without, in turns;
    launches as in 10.
12. PointNet++ NU through the CLI on 8 blocks at batch 8 (the random
    checkpoint with the ceiling, floor and wall logits raised, so that
    the clean accuracy starts above NU's exit): bottom-k launches for the
    geometry and for the smooth term of every step.
13. Card vs CPU on one 8192-point cloud, reference and fused model:
    pyramid indices equal at every level, logits within 1e-4 of the
    largest magnitude.

Every kernel's time is given twice: ``ms`` is its time on the card alone
(``device_ms``: the launches are queued behind a spin kernel, so the
host's time to send them is hidden) and ``eager_ms`` the median of single
eager calls as a caller sees them; they differ where the card finishes a
call faster than the host sends it. Beside them stand the plain PyTorch
version's time, ``bound_ms`` (the least time an H100 could take: every
input byte read once and every output byte written once at 3.35 TB/s, or
the operations at 67 TFLOP/s, whichever is larger;
``pointsecguard_tpu_torch/ops/cuda/bounds.py``), ``library_ms`` (the one
PyTorch call that computes the same values, ``torch.topk`` for the two
bottom-k kernels; null where there is none) and ``calls_per_batch`` from
the launch counters of the slice phases.

The last lines are the kernels' JSON record, the card's name and power
limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}``.
``--kernels_only`` stops after phases 3, 4, 5 and 8 and exits 1.
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
NU_CLOUDS, NU_BLOCKS = 4, 8  # one C&W batch of each model
# the fused attentive poolings of one RandLA batch: layers 0 and 1, two
# poolings each, [K, M, D] with M = batch × the level's points
ATT_SHAPES = ((16, RANDLA_BATCH * RANDLA_POINTS, 8), (16, RANDLA_BATCH * RANDLA_POINTS // 4, 32))
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


def record_bound(rec: dict, work) -> None:
    """The least time the card could take for ``work`` and what sets it."""
    rec.update(bound_ms=work.bound_ms, bound_by=work.bound_by)


def topk_library(vals: torch.Tensor, k: int):
    """The one PyTorch call that computes bottom-k's values (it does not
    order ties, so only its values are comparable). A yardstick for the
    timings here; the port never calls it."""
    return torch.topk(vals, k, dim=-1, largest=False, sorted=True)


TOPK_CALL = "torch.topk(vals, k, dim=-1, largest=False, sorted=True)"


def device_ms(fn, reps: int = 10) -> float:
    """Milliseconds of ``fn()`` on the card alone: ``reps`` runs are queued
    behind a spin kernel of some 20 ms, so the host's time to send the
    launches is hidden and the events see back-to-back device work.
    ``cuda_ms`` times one eager call as a caller sees it; for a call that
    the card finishes faster than the host sends it, the two differ."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bounds, fps
    from pointsecguard_tpu_torch.ops.distance import square_distance

    blocks = slice_blocks(dev)
    xyz = blocks[..., :3].contiguous()
    # the C&W smooth term's input: colour distances of a batch, [8, 4096, 4096]
    colors = blocks[..., 3:6].contiguous()
    cw_in = square_distance(colors, colors)
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
    for vals, k in bk_in + [(rounded, 3), (rounded, 32), (cw_in, 10), (cw_in, 5)]:
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
    # ... and for the argmax by warp reductions: N off 32 and off the
    # thread count, the start at N - 1, a cloud of identical points (every
    # step a tie of all N: index 0 from the second step on), rounded
    # coordinates (tied maxima in different warps), one warp and 32 warps
    fps_edges = [(8192, 1024, 5, "rand"), (500, 1024, 7, "rand"), (1, 4, 0, "rand"),
                 (1000, 256, 999, "rand"), (33, 33, 32, "rand"), (4097, 64, 4096, "rand"),
                 (512, 64, 3, "same"), (1000, 300, 0, "rounded"), (8192, 128, 8191, "rounded")]
    for n, npoint, s, kind in fps_edges:
        cloud = torch.rand((2, n, 3), generator=gen, device=dev)
        if kind == "same":
            cloud = cloud[:, :1].expand(2, n, 3).contiguous()
        elif kind == "rounded":
            cloud = torch.round(cloud * 4) / 4
        st = torch.full((2,), s, dtype=torch.int32, device=dev)
        if not torch.equal(fps.fps(cloud, npoint, st), fps.fps_plain(cloud, npoint, st)):
            raise AssertionError(f"fps kernel != plain at N={n} npoint={npoint} ({kind})")
    outside = torch.tensor([500, -1], dtype=torch.int32, device=dev)
    if not (fps.fps(cloud[:, :500].contiguous(), 8, outside) == -1).all():
        raise AssertionError("fps: a start outside [0, N) must give -1")
    print(f"fps: {len(fps_edges)} edge cases (N = 1, 33, 500, 1000, 4097, 8192, npoint > N, "
          "start at N - 1, identical and rounded points) equal to plain; "
          "start outside the cloud gives -1")
    sentinel = torch.where(torch.rand((8, 16, 32), generator=gen, device=dev) < 0.7,
                           32.0, torch.arange(32.0, device=dev))
    wide = torch.rand((2, 64, 8192), generator=gen, device=dev)
    # orders that stress the selection: a descending row (every element
    # passes the threshold), a constant row (all ties), ±inf among the
    # values; widths off 4 and off 128 (the scalar-load kernel); k above
    # the warp kernel's 128 (the sorting kernel), up to k == N == 8192
    descending = -torch.arange(4096.0, device=dev).expand(64, 4096).contiguous()
    constant = torch.full((64, 4096), 2.5, device=dev)
    odd = torch.rand((5, 33, 4099), generator=gen, device=dev)
    infs = torch.where(torch.rand((64, 1000), generator=gen, device=dev) < 0.3,
                       float("inf"), torch.randn((64, 1000), generator=gen, device=dev))
    infs[:, 7] = float("-inf")
    edge_cases = (
        (wide, 48), (wide, 1), (sentinel, 32),
        (torch.rand((3, 8, 1), generator=gen, device=dev), 1),
        (descending, 10), (descending, 32), (descending, 128), (constant, 10),
        (constant, 32), (odd, 16), (odd[..., :130], 130), (odd[..., :130], 7),
        (odd[..., :2], 2), (infs, 32), (infs, 1000),
        (torch.round(odd[..., :1001] * 8) / 8, 64),
        (wide[:, :8], 129), (wide[:1, :4], 8192), (odd[:, :4], 4099),
    )
    for vals, k in edge_cases:
        vals = vals.contiguous()
        gv, gi = bottomk.bottom_k(vals, k)
        wv, wi = bottomk.bottom_k_plain(vals, k)
        torch.cuda.synchronize()
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            raise AssertionError(f"bottom_k kernel != plain at {tuple(vals.shape)} k={k}")
    print(f"bottom_k: {len(edge_cases)} edge cases (descending, constant, ±inf, "
          "N off 4 and 128, k = 1, 48, 129, N = 8192 = k) equal to plain")
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

    def rows_of(v):
        return v.numel() // v.shape[-1]

    work = {
        "fps": bounds.total(bounds.fps(cur.shape[0], cur.shape[1], n) for cur, n in fps_in),
        "bottom_k": bounds.total(bounds.bottom_k(rows_of(v), v.shape[-1], k)
                                 for v, k in bk_in),
    }
    for name, kern, plain, fn, reps in (
        ("fps", fps.fps, fps.fps_plain, run_fps, 5),
        ("bottom_k", bottomk.bottom_k, bottomk.bottom_k_plain, run_bk, 20),
    ):
        eager_ms = cuda_ms(fn(kern), reps=20)
        ms = device_ms(fn(kern))
        plain_ms = cuda_ms(fn(plain), reps=reps)
        record_bound(records[name], work[name])
        bound = records[name]["bound_ms"]
        print(f"{name}: kernel {ms:.4f} ms on the card ({eager_ms:.4f} ms as eager calls, "
              f"median), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({records[name]['bound_by']}; {work[name].bytes} bytes, "
              f"{work[name].operations} operations; share {bound / ms:.3f}) per "
              f"build_geometry of [{BATCH}, {NUM_POINT}]")
        records[name].update(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms)
    # a recurrence: the time of one dependent step says more than the bound
    steps = sum(n - 1 for _, n in fps_in)
    records["fps"]["ns_per_step"] = 1e6 * records["fps"]["ms"] / steps
    print(f"fps: {steps} dependent steps per build_geometry, "
          f"{records['fps']['ns_per_step']:.0f} ns per step on the card")
    records["fps"]["max_abs_err"] = fps_err
    records["bottom_k"]["max_abs_err"] = bk_err
    # the library call on the same inputs: its values must be the kernel's
    for v, k in bk_in + [(cw_in, 10)]:
        if not torch.equal(topk_library(v, k)[0], bottomk.bottom_k(v, k)[0]):
            raise AssertionError(f"torch.topk values != bottom_k at {tuple(v.shape)} k={k}")
    lib_ms = device_ms(run_bk(topk_library))
    records["bottom_k"].update(library_ms=lib_ms, library_call=TOPK_CALL)
    print(f"bottom_k: library call {TOPK_CALL} {lib_ms:.4f} ms per build_geometry")
    # one call of the C&W smooth term (NU: k = 10, tar_NU: k = 5)
    cw = {}
    for k in (10, 5):
        w = bounds.bottom_k(rows_of(cw_in), cw_in.shape[-1], k)
        cw[f"k={k}"] = {
            "shape": list(cw_in.shape),
            "ms": device_ms(lambda: bottomk.bottom_k(cw_in, k)),
            "eager_ms": cuda_ms(lambda: bottomk.bottom_k(cw_in, k), reps=20),
            "plain_ms": cuda_ms(lambda: bottomk.bottom_k_plain(cw_in, k), reps=5),
            "library_ms": device_ms(lambda: topk_library(cw_in, k)),
            "bound_ms": w.bound_ms, "bound_by": w.bound_by,
        }
        c = cw[f"k={k}"]
        print(f"bottom_k {tuple(cw_in.shape)} k={k} (one C&W step): kernel {c['ms']:.4f} ms, "
              f"plain {c['plain_ms']:.4f} ms, library {c['library_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {w.bytes} bytes; share "
              f"{c['bound_ms'] / c['ms']:.3f})")
    records["bottom_k"]["cw_step"] = cw
    for vals, k, what in ((descending.expand(128, 64, 4096).contiguous(), 32, "descending"),
                          (constant.expand(128, 64, 4096).contiguous(), 32, "constant")):
        ms = device_ms(lambda: bottomk.bottom_k(vals, k))
        print(f"  bottom_k {tuple(vals.shape)} k={k} {what} rows: {ms:.4f} ms")
    for cur, n in fps_in:
        ms = device_ms(lambda: fps.fps(cur, n, start))
        print(f"  fps {tuple(cur.shape)} -> {n}: {ms:.4f} ms "
              f"({1e6 * ms / (n - 1):.0f} ns per step)")
    for v, k in bk_in:
        ms = device_ms(lambda: bottomk.bottom_k(v, k))
        lib = device_ms(lambda: topk_library(v, k))
        b = bounds.bottom_k(rows_of(v), v.shape[-1], k).bound_ms
        print(f"  bottom_k {tuple(v.shape)} k={k}: {ms:.4f} ms (bound {b:.4f} ms, "
              f"library {lib:.4f} ms)")


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


def read_tsv(path: str) -> list[dict]:
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        return [dict(zip(header, line.rstrip("\n").split("\t"))) for line in f]


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

    rows = read_tsv(os.path.join(log, "pointnet2_nb_area5.tsv"))
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
        records[name]["calls_per_batch"] = {
            "pointnet2 nb": counts[name] / (len(rows) // BATCH)}
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


def knn_stress(dev, knn, gen):
    """Orders and shapes that stress the fused kNN's deferred insertion,
    each equal to the plain version; returns the (query, points) of three
    orders of the same points, for timing.

    Far -> near: the queries huddle around the cube's centre and the
    points come sorted by falling distance from it, so nearly every point
    is below a query's k-th value when it is scanned (the queue's worst
    case). A constant cloud ties every distance (indices 0..k-1); a
    duplicated cloud ties pairs; S and N off the block, tile and group
    sizes; k == N; one query; ``query is points`` and a distinct query."""
    B, S, N = 4, 4096, 40960
    pts = torch.rand((B, N, 3), generator=gen, device=dev)
    centre = torch.full((3,), 0.5, device=dev)
    order = torch.argsort(((pts - centre) ** 2).sum(-1), dim=-1, descending=True)
    far = torch.gather(pts, 1, order[..., None].expand(B, N, 3)).contiguous()
    q = (centre + 1e-3 * torch.randn((B, S, 3), generator=gen, device=dev)).contiguous()
    constant = torch.full((2, 1000, 3), 0.3, device=dev)
    dup = torch.rand((2, 3000, 3), generator=gen, device=dev)
    dup[:, 1500:] = dup[:, :1500]
    odd_q = torch.rand((3, 1000, 3), generator=gen, device=dev)
    odd_p = torch.rand((3, 4099, 3), generator=gen, device=dev)
    tiny = torch.rand((2, 16, 3), generator=gen, device=dev)
    near = far[:, -2048:].contiguous()
    one = torch.rand((1, 1, 3), generator=gen, device=dev)
    cases = [
        ("far -> near", q, far, 16), ("far -> near", q, far, 1), ("random", q, pts, 16),
        ("far -> near, query is points", near, near, 16),
        ("near -> far", q[:, :512], far.flip(1).contiguous(), 16),
        ("constant", constant, constant, 16), ("constant", constant[:, :7], constant, 1),
        ("duplicated", dup, dup, 16), ("duplicated, distinct query", dup.clone(), dup, 16),
        ("S, N off the block and tile", odd_q, odd_p, 16), ("S, N off", odd_q, odd_p, 1),
        ("N off the group", odd_q[:, :33], odd_p[:, :513], 5),
        ("k == N == 16", tiny, tiny, 16), ("B = S = 1", one, odd_p[:1, :777], 5),
        ("k = 48, D = 3", odd_q[:, :300], odd_p, 48), ("k = 17", odd_q[:, :300], odd_p, 17),
        ("k = 48, far -> near", q[:1, :256], far[:1, :8192].contiguous(), 48),
    ]
    for what, a, b, k in cases:
        _equal(f"knn {what} {tuple(a.shape)} x {tuple(b.shape)} k={k}",
               knn.knn(a, b, k), knn.knn_plain(a, b, k))
    idx = knn.knn(constant, constant, 16)[1]
    if not torch.equal(idx, torch.arange(16, dtype=torch.int32, device=dev).expand_as(idx)):
        raise AssertionError("knn on a constant cloud: indices are not 0..k-1")
    print(f"knn: {len(cases)} stress cases (far -> near, near -> far, constant, duplicated, "
          "S and N off the block / tile / group, k == N, one query, query is points and "
          "distinct, k = 17 and 48 at D = 3) equal to plain")
    # as many huddled queries as a cloud has points, against the points
    # near -> far: after the first few nothing hits, so this is the time
    # of the scan alone
    q_full = (centre + 1e-3 * torch.randn((B, N, 3), generator=gen, device=dev)).contiguous()
    return {"far -> near": (q, far), "random": (q, pts),
            "near -> far (the scan alone)": (q_full, far.flip(1).contiguous())}


def phase_randla_kernels(dev, records, xyz):
    from pointsecguard_tpu_torch.ops.cuda import bottomk, bottomk_chunked, bounds, knn
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

    stress_orders = knn_stress(dev, knn, gen)

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
            eager_ms, plain_ms = cuda_ms(fn(kern), reps=10), cuda_ms(fn(plain), reps=3)
            ms = device_ms(fn(kern), reps=3)
        else:
            eager_ms = cuda_ms(lambda: kern(arg, 16), reps=20)
            ms = device_ms(lambda: kern(arg, 16))
            plain_ms = cuda_ms(lambda: plain(arg, 16), reps=5)
        work = (bounds.total(bounds.knn(q.shape[0], q.shape[1], p.shape[1], q.shape[2], k)
                             for q, p, k in calls) if fn is not None else
                bounds.bottom_k_chunked(arg.numel() // arg.shape[-1], arg.shape[-1], 16))
        record_bound(records[name], work)
        bound = records[name]["bound_ms"]
        print(f"{name}: kernel {ms:.4f} ms on the card ({eager_ms:.4f} ms as eager calls, "
              f"median), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({records[name]['bound_by']}; {work.bytes} bytes, {work.operations} "
              f"operations; share {bound / ms:.3f}) per {what}")
        records[name].update(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms)
    records["knn"]["max_abs_err"] = knn_err
    records["bottom_k_chunked"]["max_abs_err"] = bk_err
    if not torch.equal(topk_library(dists, 16)[0], bottomk_chunked.bottom_k_chunked(dists, 16)[0]):
        raise AssertionError("torch.topk values != bottom_k_chunked")
    lib_ms = device_ms(lambda: topk_library(dists, 16), reps=5)
    records["bottom_k_chunked"].update(library_ms=lib_ms, library_call=TOPK_CALL)
    print(f"bottom_k_chunked: library call {TOPK_CALL} {lib_ms:.4f} ms")
    for q, p, k in calls:
        ms = device_ms(lambda: knn.knn(q, p, k), reps=5)
        b = bounds.knn(q.shape[0], q.shape[1], p.shape[1], q.shape[2], k)
        print(f"  knn {tuple(q.shape)} x {tuple(p.shape)} k={k}: {ms:.4f} ms "
              f"(bound {b.bound_ms:.4f} ms, {b.bound_by})")
    for what, (q, p) in stress_orders.items():
        ms = device_ms(lambda: knn.knn(q, p, 16), reps=5)
        print(f"  knn {tuple(q.shape)} x {tuple(p.shape)} k=16, points in {what} order: "
              f"{ms:.4f} ms ({1e9 * ms / (q.shape[0] * q.shape[1] * p.shape[1]):.3f} ps "
              f"per pair)")


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
    records["bottom_k_chunked"]["calls_per_batch"] = {
        "tiled kNN of one 40960² level": counts["bottom_k_chunked"]}
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


def run_randla_cli(prep: str, log: str, attack: str, fused: bool, clouds: int):
    """One attack run through the CLI at batch 4, the launch counts set to
    0 just before it and read just after; its rows and summary."""
    from pointsecguard_tpu_torch.cli import attack as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels

    argv = ["--model", "randla", "--attack", attack, "--randla_dir", prep,
            "--log_dir", log, "--num_clouds", str(clouds),
            "--batch_size", str(RANDLA_BATCH)] + (["--fused_ap"] if fused else [])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clean_m, adv_m = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rows = read_tsv(os.path.join(log, f"randla_{attack}_area5.tsv"))
    if len(rows) != clouds:
        raise AssertionError(f"{len(rows)} TSV rows, want {clouds}")
    col = {c: np.array([float(r[c]) for r in rows]) for c in
           ("clean_acc", "adv_acc", "l2", "time_s", "steps")}
    ms_cloud = 1e3 * col["time_s"]  # each row: its batch's wall / batch size
    stats = {
        "attack": attack, "fused_ap": fused, "clouds": len(rows), "points": RANDLA_POINTS,
        "steps": [int(x) for x in col["steps"]],
        "ms_per_cloud_mean": float(ms_cloud.mean()),
        "ms_per_cloud_warm_median": float(np.median(ms_cloud[RANDLA_BATCH:]
                                                    if clouds > RANDLA_BATCH else ms_cloud)),
        "main_wall_s": wall,
        "clean_acc": float(col["clean_acc"].mean()),
        "adv_acc": float(col["adv_acc"].mean()),
        "l2_mean": float(col["l2"].mean()),
        "clean_miou": clean_m.miou,
        "adv_miou": adv_m.miou,
        "launches": counts,
    }
    values = [v for c in col.values() for v in c] + [clean_m.miou, adv_m.miou]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite value in the RandLA {attack} output")
    if counts["knn"] != 10 * clouds // RANDLA_BATCH:
        raise AssertionError(f"kNN launches {counts['knn']}, want 10 per batch")
    # model passes per batch: the collect forward, one forward + backward
    # per attack step, and PGD's final forward; S = the batch's steps
    steps = [max(col["steps"][b : b + RANDLA_BATCH]) for b in range(0, clouds, RANDLA_BATCH)]
    extra = 2 if attack in ("nb", "tar_nb") else 1
    fwd, bwd = sum(int(S) + extra for S in steps), sum(int(S) for S in steps)
    want = (4 * fwd, 4 * bwd) if fused else (0, 0)
    if (counts["attentive_fwd"], counts["attentive_bwd"]) != want:
        raise AssertionError(f"attentive launches {counts}, want fwd/bwd {want} "
                             f"({fwd} forwards, {bwd} backwards)")
    return stats


def phase_randla(dev, records, prep: str, sd: dict) -> list[dict]:
    """NB through the CLI on the reference and the fused model, in turns."""
    from pointsecguard_tpu_torch.utils.checkpoint import save_checkpoint

    log = os.path.join(WORK, "randla_log")
    save_checkpoint(log, sd)
    runs = []
    for fused in (False, True, True, False):
        stats = run_randla_cli(prep, log, "nb", fused, RANDLA_CLOUDS)
        stats["nb_iters_per_s"] = sum(stats["steps"]) / (
            1e-3 * stats["ms_per_cloud_mean"] * stats["clouds"])
        print("randla slice: " + json.dumps(stats))
        if not stats["adv_acc"] < stats["clean_acc"]:
            raise AssertionError("the NB attack did not lower the mean accuracy")
        runs.append(stats)
    records["knn"]["launches"] = runs[0]["launches"]["knn"]
    batches = RANDLA_CLOUDS // RANDLA_BATCH
    records["knn"]["calls_per_batch"] = {"randla nb": runs[0]["launches"]["knn"] / batches}
    for name in ("attentive_fwd", "attentive_bwd"):
        records[name]["calls_per_batch"] = {
            "randla nb --fused_ap": runs[1]["launches"][name] / batches}
    for name in ("reference", "fused_ap"):
        picked = [r for r in runs if r["fused_ap"] == (name == "fused_ap")]
        print(f"randla nb {name}: ms/cloud warm median "
              f"{[r['ms_per_cloud_warm_median'] for r in picked]}")
    return runs


def phase_randla_nu(prep: str, records) -> list[dict]:
    """NU (C&W, ares flavour) through the CLI on one batch of 4
    full-width clouds at the preset's budget, with --fused_ap and
    without, in turns (fused, reference, fused, reference). The launch
    counts of the last fused run are the attentive kernels' record."""
    log = os.path.join(WORK, "randla_log")
    runs = []
    for fused in (True, False, True, False):
        stats = run_randla_cli(prep, log, "nu", fused, NU_CLOUDS)
        stats["ms_per_step"] = stats["ms_per_cloud_mean"] * NU_CLOUDS / max(stats["steps"])
        print("randla nu: " + json.dumps(stats))
        steps = stats["steps"]
        if not all(1 <= n <= 1000 for n in steps):
            raise AssertionError(f"NU steps {steps} outside 1..1000")
        if max(steps) > 1 and not stats["adv_acc"] < stats["clean_acc"]:
            raise AssertionError("the NU attack did not lower the mean accuracy")
        runs.append(stats)
    fused_run = runs[2]
    for name in ("attentive_fwd", "attentive_bwd"):
        if fused_run["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
        records[name]["launches"] = fused_run["launches"][name]
        records[name]["calls_per_batch"]["randla nu --fused_ap"] = (
            f"{fused_run['launches'][name]} over {max(fused_run['steps'])} steps")
    records["knn"]["calls_per_batch"]["randla nu"] = fused_run["launches"]["knn"]
    for name in ("reference", "fused_ap"):
        picked = [r for r in runs if r["fused_ap"] == (name == "fused_ap")]
        print(f"randla nu {name}: ms per step {[r['ms_per_step'] for r in picked]}")
    return runs


def phase_pointnet2_nu(data: str, records) -> dict:
    """PointNet++ NU through the CLI on 8 blocks at batch 8: the
    geometry's 8 bottom-k launches and one more per C&W step for the
    smooth term. The checkpoint is ``phase_slice``'s with +2 on the
    ceiling, floor and wall logits (3/4 of the room's points): the
    random weights alone start below NU's 1/13 accuracy exit on every
    block, so the attack would stop at its first step."""
    from pointsecguard_tpu_torch.cli import attack as cli
    from pointsecguard_tpu_torch.ops import cuda as kernels
    from pointsecguard_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    sd = load_checkpoint(os.path.join(WORK, "log"))
    sd["cls.bias"][:3] += 2.0
    log = os.path.join(WORK, "log_nu")
    save_checkpoint(log, sd)
    argv = ["--model", "pointnet2", "--attack", "nu", "--data_root", data,
            "--log_dir", log, "--num_point", str(NUM_POINT),
            "--batch_size", str(BATCH), "--max_blocks", str(NU_BLOCKS)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    clean_m, adv_m = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    rows = read_tsv(os.path.join(log, "pointnet2_nu_area5.tsv"))
    col = {c: np.array([float(r[c]) for r in rows]) for c in
           ("clean_acc", "adv_acc", "l2", "time_s", "steps")}
    S = int(col["steps"].max())
    stats = {
        "blocks": len(rows), "steps": [int(x) for x in col["steps"]],
        "ms_per_block": float(1e3 * col["time_s"].mean()),
        "ms_per_step": float(1e3 * col["time_s"].sum() / S),
        "main_wall_s": wall,
        "clean_acc": float(col["clean_acc"].mean()),
        "adv_acc": float(col["adv_acc"].mean()),
        "l2_mean": float(col["l2"].mean()),
        "launches": counts,
    }
    print("pointnet2 nu: " + json.dumps(stats))
    values = [v for c in col.values() for v in c] + [clean_m.miou, adv_m.miou]
    if len(rows) != NU_BLOCKS or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"PointNet++ NU: {len(rows)} rows or a non-finite value")
    if counts["fps"] != 4 or counts["bottom_k"] != 8 + S:
        raise AssertionError(f"PointNet++ NU launches {counts}, want fps 4 and "
                             f"bottom_k 8 + {S} steps")
    if S > 1 and not stats["adv_acc"] < stats["clean_acc"]:
        raise AssertionError("the NU attack did not lower the mean accuracy")
    records["fps"]["calls_per_batch"]["pointnet2 nu"] = counts["fps"]
    records["bottom_k"]["calls_per_batch"]["pointnet2 nu"] = (
        f"{counts['bottom_k']} over {S} steps (8 + 1 per step)")
    return stats


def attentive_case(K: int, M: int, D: int, gen, dev):
    """fn, fx [K, M, D] and a [2D, 2D] projection at Linear's init scale."""
    fn = torch.randn((K, M, D), generator=gen, device=dev)
    fx = torch.randn((K, M, D), generator=gen, device=dev)
    w = (torch.rand((2 * D, 2 * D), generator=gen, device=dev) * 2 - 1) / math.sqrt(2 * D)
    return fn, fx, w


def grad_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want|, which must stay within 1e-8 + 1e-4·max|want|
    (the JAX package's gate for the fused gradients)."""
    err = (got - want).abs().max().item()
    tol = 1e-8 + 1e-4 * want.abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{name}: max |diff| {err:.3e} > {tol:.3e}")
    return err


def phase_attentive_kernels(dev, records):
    from pointsecguard_tpu_torch.ops.attentive import attentive_pool_fused_plain as plain
    from pointsecguard_tpu_torch.ops.cuda import attentive, bounds

    gen = torch.Generator(device=dev).manual_seed(3)
    fwd_err = bwd_err = 0.0
    # the slice shapes, then the edges: M = 1 and M off the row tile (a
    # block holds 64, 32, 8 or 4 rows at D = 1, 8, 32, 63), D off 4 (the
    # padded layout with 4-byte copies), both K, with and without dW
    cases = [(*ATT_SHAPES[0], False), (*ATT_SHAPES[0], True),
             (*ATT_SHAPES[1], False), (*ATT_SHAPES[1], True),
             (16, 1, 8, True), (16, 1001, 8, True), (16, 1001, 63, True),
             (4, 1001, 63, True), (4, 37, 5, False),
             (16, 1001, 1, True), (4, 999, 1, False), (4, 1001, 8, True),
             (16, 1001, 32, True), (4, 1003, 32, False), (16, 100003, 32, False),
             (16, 997, 63, False), (16, 5000, 12, True), (4, 70001, 8, True)]
    for K, M, D, want_dw in cases:
        fn, fx, w = attentive_case(K, M, D, gen, dev)
        g1, g2 = torch.randn((2, M, D), generator=gen, device=dev)
        grads = {}
        for name, f in (("kernel", attentive.attentive_pool_fused), ("plain", plain)):
            leaves = [fn.clone().requires_grad_(True), fx.clone().requires_grad_(True),
                      w.clone().requires_grad_(want_dw)]
            out = f(*leaves)
            wrt = leaves if want_dw else leaves[:2]
            grads[name] = (out, torch.autograd.grad(out, wrt, (g1, g2)))
        torch.cuda.synchronize()
        (ok_, gk), (op_, gp) = grads["kernel"], grads["plain"]
        for a, b in zip(ok_, op_):
            err = (a - b).abs().max().item()
            if not (torch.isfinite(a).all() and torch.allclose(a, b, rtol=2e-5, atol=2e-6)):
                raise AssertionError(f"attentive fwd [{K}, {M}, {D}]: max |diff| {err:.3e}")
            fwd_err = max(fwd_err, err)
        for name, a, b in zip(("dfn", "dfx", "dw"), gk, gp):
            bwd_err = max(bwd_err, grad_err(f"attentive {name} [{K}, {M}, {D}]", a, b))
        print(f"attentive [{K}, {M}, {D}] dW={want_dw}: forward and backward "
              f"within tolerance of plain")

    # dW is summed in a fixed order: two runs give the same bits
    for K, M, D in (ATT_SHAPES[1], ATT_SHAPES[0], (16, 20001, 63), (4, 20001, 1)):
        fn, fx, w = attentive_case(K, M, D, gen, dev)
        g1, g2 = torch.randn((2, M, D), generator=gen, device=dev)
        dws = []
        for _ in range(2):
            wl = w.clone().requires_grad_(True)
            dws.append(torch.autograd.grad(attentive.attentive_pool_fused(fn, fx, wl), wl,
                                           (g1, g2))[0])
        if not torch.equal(*dws):
            raise AssertionError(f"attentive dW differs between two runs at [{K}, {M}, {D}]")
    refused = (
        lambda: attentive.attentive_pool_fused(*attentive_case(8, 64, 8, gen, dev)),
        lambda: attentive.attentive_pool_fused(*attentive_case(16, 64, 64, gen, dev)),
        lambda: attentive.attentive_pool_fused(
            *(t.double() for t in attentive_case(16, 64, 8, gen, dev))),
    )
    for call in refused:
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("the attentive kernel took an input past its bounds")
    print("contract edges: M = 1, M off the row tile, D = 1, 5, 8, 12, 32, 63, K = 4 and 16 "
          "within tolerance; dW equal on two runs; K = 8, D = 64, float64 refused")

    # times per RandLA forward (4 calls) and per backward (the attack's:
    # no dW), the same inputs for kernel and plain
    calls = [attentive_case(*ATT_SHAPES[i // 2], gen, dev) for i in range(4)]
    cots = [tuple(torch.randn((2, M, D), generator=gen, device=dev))
            for _, M, D in (ATT_SHAPES[i // 2] for i in range(4))]
    res = {}
    for name, f in (("kernel", attentive.attentive_pool_fused), ("plain", plain)):
        timer = cuda_ms if name == "plain" else device_ms
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: [f(*c) for c in calls], reps=20)
            fwd_dev = timer(lambda: [f(*c) for c in calls], reps=10)
        leaves = [(fn.clone().requires_grad_(True), fx.clone().requires_grad_(True), w)
                  for fn, fx, w in calls]
        outs = [o for lv in leaves for o in f(*lv)]
        flat = [t for lv in leaves for t in lv[:2]]
        cot = [g for c in cots for g in c]
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(outs, flat, cot, retain_graph=True),
                         reps=20)
        bwd_dev = timer(lambda: torch.autograd.grad(outs, flat, cot, retain_graph=True),
                        reps=10)
        res[name] = (fwd_ms, bwd_ms, fwd_dev, bwd_dev)
        del leaves, outs, flat
    (ef, eb, kf, kb), (pf, pb, _, _) = res["kernel"], res["plain"]
    print(f"attentive per RandLA forward (4 calls): kernel {kf:.4f} ms on the card "
          f"({ef:.4f} ms as eager calls, median), plain {pf:.4f} ms; backward (no dW): "
          f"kernel {kb:.4f} ms ({eb:.4f} ms eager), plain {pb:.4f} ms; forward + backward: "
          f"kernel {kf + kb:.4f} ms, plain {pf + pb:.4f} ms")
    records["attentive_fwd"].update(ms=kf, eager_ms=ef, plain_ms=pf, max_abs_err=fwd_err)
    records["attentive_bwd"].update(ms=kb, eager_ms=eb, plain_ms=pb, max_abs_err=bwd_err)
    shapes = [ATT_SHAPES[i // 2] for i in range(4)]
    for name, f, ms in (("attentive_fwd", bounds.attentive_fwd, kf),
                        ("attentive_bwd", bounds.attentive_bwd, kb)):
        work = bounds.total(f(*shape) for shape in shapes)
        record_bound(records[name], work)
        print(f"{name}: bound {work.bound_ms:.4f} ms ({work.bound_by}; {work.bytes} bytes "
              f"= {work.bytes_ms:.4f} ms, {work.operations} operations = "
              f"{work.operations_ms:.4f} ms; share {work.bound_ms / ms:.3f}) per RandLA pass")
    for (K, M, D), (fn, fx, w), (g1, g2) in zip(shapes[::2], calls[::2], cots[::2]):
        with torch.no_grad():
            ms = device_ms(lambda: attentive.attentive_pool_fused(fn, fx, w))
        bf = bounds.attentive_fwd(K, M, D)
        print(f"  attentive fwd [{K}, {M}, {D}]: {ms:.4f} ms (bound {bf.bound_ms:.4f} ms, "
              f"{bf.bound_by})")
        for want_dw in (False, True):
            lv = (fn.clone().requires_grad_(True), fx.clone().requires_grad_(True),
                  w.clone().requires_grad_(want_dw))
            out = attentive.attentive_pool_fused(*lv)
            wrt = lv if want_dw else lv[:2]
            ms = device_ms(lambda: torch.autograd.grad(out, wrt, (g1, g2), retain_graph=True))
            bb = bounds.attentive_bwd(K, M, D, want_dw)
            print(f"  attentive bwd [{K}, {M}, {D}] dW={want_dw}: {ms:.4f} ms "
                  f"(bound {bb.bound_ms:.4f} ms, {bb.bound_by})")


def phase_fused_model(dev, feats: torch.Tensor, sd: dict) -> None:
    """The full-width RandLA with ap_impl="fused" against the reference
    composition on one sampler batch of 4 × 40960 points: logits within
    1e-4 of the largest. The colour gradient of a cross-entropy is held
    against a float64 evaluation of the reference: the random calibrated
    model's gradient is ill-conditioned in float32 (the float32 reference
    itself misses float64 by ~0.3 % in L2 at 4 × 2048 points on the CPU),
    so the fused gradient must come as close to it as the float32
    reference does, within a factor of 2."""
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

    pyr = build_pyramid(feats[..., :3])
    labels = torch.randint(0, 13, feats.shape[:2], device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))
    out = {}
    for ap_impl, dtype in (("reference", torch.float64), ("reference", torch.float32),
                           ("fused", torch.float32)):
        model = RandLANet(ap_impl=ap_impl)
        model.load_state_dict(sd)
        model.to(dev, dtype).eval().requires_grad_(False)
        f = feats.to(dtype)
        p = dict(pyr, xyz=tuple(x.to(dtype) for x in pyr["xyz"]))
        colors = f[..., 3:6].clone().requires_grad_(True)
        logits = model(torch.cat([f[..., :3], colors], dim=-1), p)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 13), labels.reshape(-1))
        out[ap_impl, dtype] = (logits.detach(), torch.autograd.grad(loss, colors)[0].double())
        del model
    torch.cuda.synchronize()
    g64 = out["reference", torch.float64][1]
    (lr, gr), (lf, gf) = out["reference", torch.float32], out["fused", torch.float32]
    err = (lf - lr).abs().max().item()
    tol = 1e-4 * max(1.0, lr.abs().max().item())
    ref_gerr = (gr - g64).abs().max().item()
    fused_gerr = (gf - g64).abs().max().item()
    rel = [(torch.linalg.norm(g - g64) / torch.linalg.norm(g64)).item() for g in (gr, gf)]
    print(f"fused vs reference RandLA at [{RANDLA_BATCH}, {RANDLA_POINTS}]: logits max "
          f"|diff| {err:.3e} (tolerance {tol:.3e}); colour gradient vs float64 max |diff| "
          f"reference {ref_gerr:.3e}, fused {fused_gerr:.3e} (max |g| "
          f"{g64.abs().max().item():.3e}), relative L2 reference {rel[0]:.3e}, "
          f"fused {rel[1]:.3e}; fused vs reference max |diff| "
          f"{(gf - gr).abs().max().item():.3e}")
    if not (torch.isfinite(lf).all() and err <= tol):
        raise AssertionError("fused RandLA logits disagree with the reference")
    if not (torch.isfinite(gf).all() and fused_gerr <= 2 * ref_gerr):
        raise AssertionError("the fused colour gradient is further from float64 than "
                             "twice the float32 reference's")


def phase_randla_reference(dev, prep: str) -> None:
    """RandLA on the card (kernels) vs on the CPU (plain versions) on one
    8192-point cloud, with the reference and the fused attentive pooling:
    pyramid indices equal at every level; logits on the same pyramid
    within 1e-4 of the largest magnitude."""
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

    feats = randla_batch(prep, dev, num_points=8192, batch=1)
    sd = randla_state_dict(1, dev, feats)
    pyr_gpu = build_pyramid(feats[..., :3])
    pyr_cpu = build_pyramid(feats[..., :3].cpu())
    for key in ("neigh_idx", "sub_idx", "interp_idx"):
        for level, (g, c) in enumerate(zip(pyr_gpu[key], pyr_cpu[key])):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"card/CPU pyramid {key}[{level}] differ")
    for ap_impl in ("reference", "fused"):
        model = RandLANet(ap_impl=ap_impl)
        model.load_state_dict(sd)
        model.eval()
        with torch.no_grad():
            lg = model.to(dev)(feats, pyr_gpu).cpu()
            lc = model.cpu()(feats.cpu(), pyr_cpu)
        # float32 sums run in another order on the card than on the CPU;
        # the bound is relative to the largest logit
        err = (lg - lc).abs().max().item()
        tol = 1e-4 * max(1.0, lc.abs().max().item())
        print(f"randla {ap_impl}: pyramid indices equal card vs CPU at all 5 levels; "
              f"logits max |diff| {err:.3e} (tolerance {tol:.3e})")
        if not (lg.shape == (1, 8192, 13) and torch.isfinite(lg).all() and err <= tol):
            raise AssertionError(f"card RandLA ({ap_impl}) logits disagree with the CPU")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels_only", action="store_true",
                        help="build the kernels and run only the kernel-vs-plain phases "
                             "(3, 4, 5 and 8); the last line then carries \"ok\": false, "
                             "because the slices were not driven")
    args = parser.parse_args(argv)
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
    print("max SM clock:", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
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
            if "Compiling entry function" in line:
                print("  ptxas:", line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print("  ptxas:  ", line.replace("ptxas info    :", "").strip())

    records = {
        "fps": {"name": "fps", "route": "cuda",
                "source": "pointsecguard_tpu_torch/csrc/fps.cu",
                "replaces": "pointsecguard_tpu/ops/pallas/fps.py:27",
                "library_ms": None, "library_call": None},
        "bottom_k": {"name": "bottom_k", "route": "cuda",
                     "source": "pointsecguard_tpu_torch/csrc/bottomk.cu",
                     "replaces": "pointsecguard_tpu/ops/pallas/bottomk.py:66"},
        "knn": {"name": "knn", "route": "cuda",
                "source": "pointsecguard_tpu_torch/csrc/knn.cu",
                "replaces": "pointsecguard_tpu/ops/pallas/knn.py:52",
                "library_ms": None, "library_call": None},
        "bottom_k_chunked": {"name": "bottom_k_chunked", "route": "cuda",
                             "source": "pointsecguard_tpu_torch/csrc/bottomk_chunked.cu",
                             "replaces": "pointsecguard_tpu/ops/pallas/bottomk.py:206"},
        "attentive_fwd": {"name": "attentive_fwd", "route": "cuda",
                          "source": "pointsecguard_tpu_torch/csrc/attentive.cu",
                          "replaces": "pointsecguard_tpu/ops/pallas/attentive.py:100",
                          "library_ms": None, "library_call": None},
        "attentive_bwd": {"name": "attentive_bwd", "route": "cuda",
                          "source": "pointsecguard_tpu_torch/csrc/attentive.cu",
                          "replaces": "pointsecguard_tpu/ops/pallas/attentive.py:115",
                          "library_ms": None, "library_call": None},
    }
    from pointsecguard_tpu_torch.data import make_synthetic_rooms

    data = os.path.join(WORK, "data")
    make_synthetic_rooms(data, points_per_room=ROOM_POINTS, seed=0)
    prep = prepare_randla(data)
    phase_kernels(dev, records)
    phase_attentive_kernels(dev, records)
    feats = randla_batch(prep, dev)
    xyz = feats[..., :3].contiguous()
    phase_randla_kernels(dev, records, xyz)
    phase_routes(records, xyz)
    del xyz
    if args.kernels_only:
        print(json.dumps({"kernels": list(records.values())}))
        print(card)
        print(json.dumps({"ok": False, "kernels_only": True}))
        return 1
    phase_slice(dev, records, data)
    phase_reference(dev)
    phase_pointnet2_nu(data, records)
    sd = randla_state_dict(0, dev, feats)
    phase_fused_model(dev, feats, sd)
    del feats
    phase_randla(dev, records, prep, sd)
    phase_randla_nu(prep, records)
    phase_randla_reference(dev, prep)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "calls_per_batch")
    for r in records.values():
        if not r["launches"] > 0:
            raise AssertionError(f"kernel {r['name']} never launched on its main path")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: r[k] for k in ("cw_step", "ns_per_step") if k in r}}
        for r in records.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
