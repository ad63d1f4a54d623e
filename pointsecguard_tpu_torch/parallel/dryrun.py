"""The multi-rank programs and their check (the port's counterpart of
``__graft_entry__.py:dryrun_multichip``).

Each ``*_program(ctx, ...)`` runs on one rank of a mesh (``spawn``) or, with
``ctx=None``, as the one-process reference on the whole batch. Inputs are
whole numpy arrays made from a seed in the caller; each rank takes its part
(``make_batch_put``) and returns numpy results, so that the caller can hold
the ranks against the one-process run. The functions live in the package
so that a spawned rank imports torch and this package only.

``dryrun_multichip(mesh)`` runs the six programs of the JAX dry run — a
PointNet++ SSG train step, a RandLA-Net forward + backward with the points
sharded, a ResGCN train step, an NB attack, a device-sampler multi-step and
whole-scene voting eval — on the ranks of ``mesh`` and in this process,
and raises unless indices are equal, losses within rtol 1e-6, gradients
within atol 1e-5 (the tolerances of ``tests/test_parallel.py``), and the
parameters equal on every rank. The two train steps are held there in
float64 as well as float32: in float32 the random-initialised train-mode
networks turn the ranks' other summation order of the BatchNorm statistics
into gradients a few per cent apart (a float64 run puts the same two
gradients 1e-12 apart), so in float32 only the loss, the statistics and
the parameters' equality across ranks are held, and the gradients'
relative distance is recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from pointsecguard_tpu_torch.parallel.mesh import (
    TIMEOUT,
    Mesh,
    RankContext,
    flat_view,
    make_batch_put,
    spawn,
)
from pointsecguard_tpu_torch.parallel.spmd_ops import (
    _gather,
    dp_map,
    gather_rows,
    knn_points_sharded,
    points_sharded_forward,
)

LOSS_RTOL, GRAD_ATOL = 1e-6, 1e-5


def _device(ctx: RankContext | None, device: str) -> torch.device:
    return torch.device(device) if ctx is None else ctx.device


def _rows(ctx, x, device, *, shard_points=False):
    """The rank's rows (and points shard) of a whole numpy array, on the
    rank's device."""
    return make_batch_put(ctx, shard_points=shard_points, device=device)(x)


def _whole_rows(ctx, t: torch.Tensor) -> np.ndarray:
    """The data slices' ``t`` gathered back into the whole batch."""
    return gather_rows(t.detach(), ctx).cpu().numpy()


def _sum(ctx, value: torch.Tensor) -> float:
    value = value.detach().clone()
    if ctx is not None and ctx.world_size > 1:
        dist.all_reduce(value, group=ctx.group)
    return float(value)


def knn_program(ctx, query: np.ndarray, points: np.ndarray, k: int,
                device: str = "cpu"):
    """(sq_dists, idx) of ``knn_points_sharded`` on the rank's rows and query
    shard (``ops.knn`` on the whole arrays without a mesh), and the rank's
    ``psg::knn`` launches in it."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.ops.cuda import knn as knn_kernel

    dev = _device(ctx, device)
    q, p = _rows(ctx, query, dev), _rows(ctx, points, dev)
    knn_kernel.launches = 0
    d, i = ops.knn(q, p, k) if ctx is None else knn_points_sharded(q, p, k, ctx)
    return d.cpu().numpy(), i.cpu().numpy(), knn_kernel.launches


def knn_errors_program(ctx, device: str = "cpu") -> list[str]:
    """The messages of ``knn_points_sharded``'s two ValueErrors (a points
    axis that does not divide, k > N), raised before any collective."""
    dev = _device(ctx, device)
    out = []
    for q, p, k in ((torch.zeros(1, 31, 3), torch.zeros(1, 64, 3), 4),
                    (torch.zeros(1, 64, 3), torch.zeros(1, 64, 3), 128)):
        try:
            knn_points_sharded(q.to(dev), p.to(dev), k, ctx)
        except ValueError as e:
            out.append(str(e))
    return out


def pyramid_program(ctx, xyz: np.ndarray, device: str = "cpu", **kw) -> dict:
    """The RandLA pyramid of the rank's rows (``build_pyramid(sp=ctx)``),
    index tables of whole levels, and the rank's ``psg::knn`` launches."""
    from pointsecguard_tpu_torch.models import build_pyramid
    from pointsecguard_tpu_torch.ops.cuda import knn as knn_kernel

    dev = _device(ctx, device)
    knn_kernel.launches = 0
    pyr = build_pyramid(_rows(ctx, xyz, dev), sp=ctx, **kw)
    out = {f: [t.cpu().numpy() for t in pyr[f]] for f in ("neigh_idx", "sub_idx", "interp_idx")}
    out["launches"] = knn_kernel.launches
    return out


def randla_grad_program(ctx, feats: np.ndarray, labels: np.ndarray, state: dict,
                        device: str = "cpu", d_out=(16, 64, 128, 256, 512)):
    """Mean cross-entropy of an evaluation-mode RandLA-Net over the whole
    batch and its gradient on the features, with the points axis sharded:
    the rank holds its rows and points shard, the forward is
    ``points_sharded_forward`` over ``build_pyramid(sp=ctx)``. Returns
    (loss, the whole batch's gradient) on every rank."""
    from pointsecguard_tpu_torch.models import RandLANet, build_pyramid

    dev = _device(ctx, device)
    model = RandLANet(d_out=d_out)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.to(dev).eval().requires_grad_(False)
    sp = ctx is not None and ctx.points_size > 1
    f = _rows(ctx, feats, dev, shard_points=sp).requires_grad_(True)
    y = _rows(ctx, labels, dev, shard_points=sp).long()

    def forward(whole):
        return model(whole, build_pyramid(whole[..., :3], sp=ctx if sp else None))

    logits = points_sharded_forward(forward, ctx)(f) if sp else forward(f)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, -1, y[..., None]).sum() / labels.size
    nll.backward()
    g = f.grad
    if sp:
        g = _gather(g, ctx.points_group, 1)
    return _sum(ctx, nll), _whole_rows(ctx, g)


def _narrow_model(kind: str, **kw):
    from pointsecguard_tpu_torch.models import DenseDeepGCN, PointNet2SemSegSSG

    if kind == "pointnet2":
        return PointNet2SemSegSSG()
    return DenseDeepGCN(**{"n_blocks": 3, "n_filters": 8, "k": 4, **kw})


def train_step_program(ctx, kind: str, points: np.ndarray, labels: np.ndarray,
                       weights: np.ndarray, state: dict, lr: float = 1e-3,
                       bn_momentum: float = 0.1, seed: int | None = 1, device: str = "cpu",
                       steps: int = 1, dtype: str = "float32", dropout_mask=None,
                       graphs=None, model_kw: dict | None = None):
    """``steps`` train steps of the PointNet++ SSG (``kind="pointnet2"``,
    weighted NLL, weight decay 1e-4) or a narrow ResGCN (``"resgcn"``, mean
    CE) from ``state`` on the batch, the rank's part of it (rows, and its
    points shard where the mesh has a points axis). FPS starts, dropout and
    dilation draws come from a generator of ``seed``; ``seed=None`` starts
    FPS at index 0 and takes ``dropout_mask`` (the whole batch's) instead.
    ``graphs`` pins ResGCN's graphs (the whole batch's); ``model_kw`` sizes
    the ResGCN. ``dtype="float64"`` runs the model and the batch in float64
    (the neighbour search stays float32). Returns the losses, the last
    step's summed gradient, the parameters and the BatchNorm statistics
    (flat)."""
    from pointsecguard_tpu_torch.models import weighted_nll_loss
    from pointsecguard_tpu_torch.models.resgcn import ce_loss
    from pointsecguard_tpu_torch.train.trainer import (
        POINTNET2,
        TrainState,
        make_train_step,
        resgcn_family,
    )

    dev = _device(ctx, device)
    model = _narrow_model(kind, **(model_kw or {}))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    dt = getattr(torch, dtype)
    ts = TrainState(model.to(dev, dt))
    if kind == "pointnet2":
        step = make_train_step(model, weighted_nll_loss, family=POINTNET2, ctx=ctx)
    else:
        step = make_train_step(model, ce_loss, weight_decay=0.0, family=resgcn_family(),
                               ctx=ctx)
    sp = ctx is not None and ctx.points_size > 1
    pts = _rows(ctx, points, dev, shard_points=sp).to(dt)
    ys = _rows(ctx, labels, dev, shard_points=sp).long()
    w = torch.from_numpy(weights).to(dev, dt)
    gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
    # pinned plans hold the rank's rows and, like the step, whole clouds
    kw = {}
    if dropout_mask is not None:
        kw["dropout_mask"] = _rows(ctx, dropout_mask, dev)
    if graphs is not None:
        kw["geometry"] = tuple(_rows(ctx, g, dev) for g in graphs)
    losses = [float(step(ts, pts, ys, w, lr, bn_momentum, gen, **kw)) for _ in range(steps)]
    return (np.array(losses), ts.grads.cpu().numpy(), ts.params.cpu().numpy(),
            ts.stats.cpu().numpy())


def attack_program(ctx, points: np.ndarray, labels: np.ndarray, state: dict,
                   iters: int = 2, device: str = "cpu"):
    """The NB attack (``attack_preset("pointnet2", "nb")`` cut to ``iters``)
    on an evaluation-mode PointNet++ SSG, each data slice on its rows (the
    ranks of a points group alike); returns the whole batch's adversarial
    points, per-cloud L2 and adversarial predictions."""
    from pointsecguard_tpu_torch.attacks import attack_preset, pgd_color_attack
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, build_geometry

    dev = _device(ctx, device)
    model = PointNet2SemSegSSG()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.to(dev).eval().requires_grad_(False)
    pts, ys = _rows(ctx, points, dev), _rows(ctx, labels, dev).long()
    geo = build_geometry(pts[..., :3])
    cfg = dataclasses.replace(attack_preset("pointnet2", "nb"), iters=iters)
    res = pgd_color_attack(lambda p: model(p, geometry=geo)[0], pts, ys, cfg)
    return (_whole_rows(ctx, res.points_adv), _whole_rows(ctx, res.l2_dist),
            _whole_rows(ctx, res.adv_pred))


def sampler_program(ctx, room_points: list, room_labels: list, state: dict,
                    batch_size: int, device: str = "cpu", steps: int = 2,
                    dtype: str = "float64"):
    """``steps`` device-sampled PointNet++ steps (``--device_sampler``) from
    rooms given as arrays, data-parallel over every rank of the mesh: each
    rank draws the global batch from the same generator and keeps its
    rows; the model runs in ``dtype`` (float64 by default: see the module
    doc). Returns the losses and the parameters."""
    from pointsecguard_tpu_torch.data.device_sampler import (
        make_device_block_sampler,
        make_sampled_multi_train_step,
        stage_rooms,
    )
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG, weighted_nll_loss
    from pointsecguard_tpu_torch.train.trainer import TrainState, make_train_step

    dev = _device(ctx, device)
    with contextlib.nullcontext() if ctx is None else flat_view(ctx, "data") as view:
        staged, num_max = stage_rooms(_roomset(room_points, room_labels), dev)
        sample_fn = make_device_block_sampler(batch_size=batch_size, num_point=64,
                                              num_max=num_max, min_points=16)
        model = PointNet2SemSegSSG()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        dt = getattr(torch, dtype)
        ts = TrainState(model.to(dev, dt))
        train = make_train_step(model, weighted_nll_loss, ctx=view)
        step = make_sampled_multi_train_step(
            lambda state, pts, *args: train(state, pts.to(dt), *args), sample_fn, view)
        gen = torch.Generator(device=dev).manual_seed(6)
        losses = step(ts, staged, torch.ones(13, device=dev, dtype=dt), 1e-3, 0.1, steps,
                      gen)
    return losses.cpu().numpy(), ts.params.cpu().numpy()


def eval_program(ctx, room_points: np.ndarray, room_labels: np.ndarray, state: dict,
                 block_points: int, batch_size: int, device: str = "cpu"):
    """Whole-scene voting eval of one room with an evaluation-mode
    PointNet++ SSG (``evaluate_whole_scenes``), the predict step
    data-parallel (``dp_map``); returns the room's predicted labels and its
    mIoU."""
    from pointsecguard_tpu_torch.models import PointNet2SemSegSSG
    from pointsecguard_tpu_torch.train.evaluator import evaluate_whole_scenes
    from pointsecguard_tpu_torch.train.trainer import make_eval_step

    dev = _device(ctx, device)
    model = PointNet2SemSegSSG()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.to(dev).eval().requires_grad_(False)
    rooms = _roomset([room_points], [room_labels])
    preds = []

    def predict(chunk):
        out = make_eval_step(model, dev)(chunk)
        preds.append(out)
        return out

    total, _ = evaluate_whole_scenes(dp_map(predict, ctx), rooms, batch_size=batch_size,
                                     block_points=block_points,
                                     rng=np.random.default_rng(0))
    return float(total.miou), np.concatenate(preds) if preds else np.zeros(0)


def _roomset(points: list, labels: list):
    from pointsecguard_tpu_torch.data import RoomSet

    return RoomSet([f"room_{i}" for i in range(len(points))], list(points), list(labels),
                   [p[:, :3].min(0) for p in points], [p[:, :3].max(0) for p in points])


def _state(model) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def dryrun_inputs(data_size: int, world_size: int, seed: int = 0) -> dict:
    """The six programs' inputs and initial weights, from ``seed``."""
    from pointsecguard_tpu_torch.data.synthetic import make_room
    from pointsecguard_tpu_torch.models import RandLANet, init_parameters

    rng = np.random.RandomState(seed)
    B, N = max(2, data_size), 256
    inp = {"B": B, "N": N, "sampler_batch": max(2, world_size)}
    inp["points"] = rng.rand(B, N, 9).astype(np.float32)
    inp["labels"] = rng.randint(0, 13, (B, N))
    ssg = _narrow_model("pointnet2")
    init_parameters(ssg, torch.Generator().manual_seed(0))
    inp["ssg"] = _state(ssg)
    inp["feats"] = rng.rand(data_size, 512, 6).astype(np.float32)
    inp["randla_labels"] = rng.randint(0, 13, (data_size, 512))
    randla = RandLANet()
    init_parameters(randla, torch.Generator().manual_seed(2))
    inp["randla"] = _state(randla)
    inp["gpts"] = rng.rand(B, 128, 9).astype(np.float32)
    inp["glabels"] = rng.randint(0, 13, (B, 128))
    gcn = _narrow_model("resgcn")
    init_parameters(gcn, torch.Generator().manual_seed(3), scale=2.0)
    inp["resgcn"] = _state(gcn)
    inp["apts"] = rng.rand(B, N, 9).astype(np.float32)
    inp["alabels"] = rng.randint(0, 13, (B, N))
    gen = np.random.default_rng(seed + 1)
    rooms = [make_room(n, rng=gen) for n in (512, 512, 3000)]
    inp["rooms"] = [(r[:, :6], r[:, 6].astype(np.int64)) for r in rooms[:2]]
    inp["eval_room"] = (rooms[2][:, :6], rooms[2][:, 6].astype(np.int64))
    return inp


def dryrun_programs(ctx, inp: dict, device: str = "cpu") -> dict:
    """The six programs on ``inp`` (``dryrun_inputs``)."""
    out = {}
    for dt in ("float32", "float64"):
        out[f"ssg_{dt}"] = train_step_program(ctx, "pointnet2", inp["points"], inp["labels"],
                                              np.ones(13, np.float32), inp["ssg"],
                                              device=device, dtype=dt)
        out[f"resgcn_{dt}"] = train_step_program(ctx, "resgcn", inp["gpts"], inp["glabels"],
                                                 np.ones(13, np.float32), inp["resgcn"],
                                                 device=device, dtype=dt)
    if ctx is None or ctx.points_size > 1:
        out["randla"] = randla_grad_program(ctx, inp["feats"], inp["randla_labels"],
                                            inp["randla"], device=device)
        out["pyramid"] = pyramid_program(ctx, inp["feats"][..., :3], device=device)
    out["attack"] = attack_program(ctx, inp["apts"], inp["alabels"], inp["ssg"],
                                   device=device)
    out["sampler"] = sampler_program(ctx, [r[0] for r in inp["rooms"]],
                                     [r[1] for r in inp["rooms"]], inp["ssg"],
                                     batch_size=inp["sampler_batch"], device=device)
    out["eval"] = eval_program(ctx, *inp["eval_room"], inp["ssg"], block_points=inp["N"],
                               batch_size=inp["B"], device=device)
    return out


def _close(name, got, want, *, rtol=0.0, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    # NaN where both have it: the xyz gradient through a point's zero
    # distance to itself (numpy's assert_allclose, as tests/test_parallel.py
    # compares, takes NaN as equal too)
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol, atol=atol,
                                                  equal_nan=True):
        diff = (np.nanmax(np.abs(got - want)) if got.shape == want.shape
                else f"shapes {got.shape} vs {want.shape}")
        raise AssertionError(f"dryrun {name}: ranks differ from one process ({diff})")
    return float(np.nanmax(np.abs(got - want))) if got.size else 0.0


def check_dryrun(ranks: list, one: dict, points: int) -> dict:
    """Hold every rank's results (``dryrun_programs`` on a mesh) to the
    one-process run; returns the largest differences."""
    diffs = {}
    for name in ("ssg_float32", "ssg_float64", "resgcn_float32", "resgcn_float64"):
        loss, grads, params, stats = one[name]
        for r, res in enumerate(ranks):
            diffs[f"{name}_loss"] = _close(f"{name} loss, rank {r}", res[name][0], loss,
                                           rtol=LOSS_RTOL)
            if name.endswith("float64"):
                diffs[f"{name}_grad"] = _close(f"{name} grad, rank {r}", res[name][1], grads,
                                               atol=GRAD_ATOL)
            else:  # recorded: summation order, amplified by train-mode BatchNorm
                diffs[f"{name}_grad_rel_l2"] = float(
                    np.linalg.norm(res[name][1] - grads) / np.linalg.norm(grads))
            diffs[f"{name}_stats"] = _close(f"{name} stats, rank {r}", res[name][3], stats,
                                            rtol=1e-5, atol=GRAD_ATOL)
            _close(f"{name} params, rank {r} vs 0", res[name][2], ranks[0][name][2])
    if points > 1:
        loss, grad = one["randla"]
        for r, res in enumerate(ranks):
            diffs["randla_loss"] = _close(f"randla loss, rank {r}", res["randla"][0], loss,
                                          rtol=LOSS_RTOL)
            diffs["randla_grad"] = _close(f"randla grad, rank {r}", res["randla"][1], grad,
                                          atol=GRAD_ATOL)
            for f in ("neigh_idx", "sub_idx", "interp_idx"):
                for lvl, want in enumerate(one["pyramid"][f]):
                    d = ranks[r]["pyramid"][f][lvl]
                    b = len(d)
                    _close(f"pyramid {f} level {lvl}, rank {r}", d,
                           want[(r // points) * b : (r // points + 1) * b])
    adv, l2, pred = one["attack"]
    for r, res in enumerate(ranks):
        diffs["attack_l2"] = _close(f"attack l2, rank {r}", res["attack"][1], l2, atol=1e-5)
        diffs["attack_adv"] = _close(f"attack points, rank {r}", res["attack"][0], adv,
                                     atol=1e-5)
        losses, params = res["sampler"]
        diffs["sampler_loss"] = _close(f"sampler loss, rank {r}", losses,
                                       one["sampler"][0], rtol=LOSS_RTOL)
        _close(f"sampler params, rank {r} vs 0", params, ranks[0]["sampler"][1])
        miou, preds = res["eval"]
        diffs["eval_miou"] = _close(f"eval mIoU, rank {r}", miou, one["eval"][0])
    return diffs


def dryrun_multichip(mesh: Mesh, device: str = "cpu") -> dict:
    """The six programs on the ranks of ``mesh`` and in this process (on
    ``device``), held to each other (``check_dryrun``); returns the one
    process's losses and the largest differences."""
    inp = dryrun_inputs(mesh.size // mesh.points, mesh.size)
    ranks = spawn(dryrun_programs, mesh, (inp, device))
    one = dryrun_programs(None, inp, device)
    return {"ssg_loss": float(one["ssg_float32"][0][0]),
            "resgcn_loss": float(one["resgcn_float32"][0][0]),
            "diffs": check_dryrun(ranks, one, mesh.points)}


def _device_ms(fn, reps: int = 5) -> float:
    """Milliseconds of ``fn()`` on the card alone: the launches queue behind
    a spin kernel, so the host's time to send them is hidden."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def pyramid_timing_program(ctx, xyz: np.ndarray, k: int = 16, device: str = "cuda"):
    """The points-sharded RandLA pyramid of the whole batch ``xyz`` (every
    rank holds the same data slice: a mesh of points ranks only) and the
    rank's ``psg::knn`` launches in it; then, one rank at a time so that
    ranks sharing a card do not overlap, the card milliseconds of the top
    level's self-kNN on the rank's query shard against the whole cloud.
    Without a mesh, the same for the whole cloud."""
    from pointsecguard_tpu_torch import ops
    from pointsecguard_tpu_torch.models import build_pyramid
    from pointsecguard_tpu_torch.ops.cuda import knn as knn_kernel
    from pointsecguard_tpu_torch.parallel.spmd_ops import points_shard

    dev = _device(ctx, device)
    x = torch.from_numpy(xyz).to(dev)
    torch.cuda.synchronize()
    knn_kernel.launches = 0
    pyr = build_pyramid(x, k=k, sp=ctx)
    torch.cuda.synchronize()
    out = {f: [t.cpu().numpy() for t in pyr[f]] for f in ("neigh_idx", "sub_idx", "interp_idx")}
    out["launches"] = knn_kernel.launches
    q = x if ctx is None else points_shard(x, ctx)
    out["query_shape"] = tuple(q.shape)
    for r in range(1 if ctx is None else ctx.world_size):
        if ctx is not None:
            dist.barrier(group=ctx.group)
        if ctx is None or r == ctx.rank:
            out["device_ms"] = _device_ms(lambda: ops.knn(q, x, k))
    if ctx is not None:
        dist.barrier(group=ctx.group)
    return out


def cli_program(ctx, cli: str, argv: list, deterministic: bool = False):
    """The body of ``python -m pointsecguard_tpu_torch.cli.<cli> argv`` as
    rank ``ctx.rank`` of its ``--devices`` runs it (``run_cli`` starts these
    ranks one card each; here the caller's mesh places them), with the
    kernel launch counters reset first. ``deterministic`` runs it under
    ``torch.use_deterministic_algorithms`` (the gathers' backward then adds
    in a fixed order on a card, so that two runs can be held bit for bit).
    Returns (the body's result, this rank's launches)."""
    import importlib

    from pointsecguard_tpu_torch.ops import cuda as kernels

    mod = importlib.import_module(f"pointsecguard_tpu_torch.cli.{cli}")
    args = mod._parser().parse_args(argv)
    mod._refuse_unported(args)
    if cli == "benchmark":
        mod._check_task(args)
    body = {"train": "_train", "eval": "_eval", "attack": "_attack",
            "attack_object": "_attack_object", "benchmark": "_benchmark"}[cli]
    if ctx is not None and ctx.device.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic or before, warn_only=True)
    try:
        result = getattr(mod, body)(args, ctx)
    finally:
        torch.use_deterministic_algorithms(before)
    if ctx is not None and ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return result, kernels.launch_counts()


def collective_program(ctx, xyz: np.ndarray, k: int = 16):
    """One all-reduce and ``knn_points_sharded`` on the top level of a
    whole batch held by every rank (a mesh of points ranks only): the
    all-reduce's sum of the ranks' ids, the rank's (sq_dists, idx) and its
    ``psg::knn`` launches."""
    from pointsecguard_tpu_torch.ops.cuda import knn as knn_kernel

    x = torch.from_numpy(xyz).to(ctx.device)
    ids = torch.full((4,), float(ctx.rank), device=ctx.device)
    dist.all_reduce(ids, group=ctx.group)
    knn_kernel.launches = 0
    d, i = knn_points_sharded(x, x, k, ctx)
    return ids.cpu().numpy(), d.cpu().numpy(), i.cpu().numpy(), knn_kernel.launches


WAIT = 1800  # seconds a rank outside a program of fewer ranks may wait for the others


def wait_program(ctx, path: str, timeout: float = WAIT) -> float:
    """Wait until the file ``path`` exists, the caller's go-ahead, for up to
    ``timeout`` seconds; → the seconds waited. As the first program, it
    lets the ranks start up while the caller still works on the card."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.1)
    return time.perf_counter() - t0


def programs(ctx, calls: list, *, timed: bool = False) -> list:
    """Several programs of this module in one start of the ranks: each
    ``(name, args, kwargs)`` of ``calls`` is ``name(ctx, *args, **kwargs)``,
    in order; a ``kwargs["view"]`` of ``"data"`` or ``"points"`` runs it on
    ``flat_view(ctx, view)``, and a ``kwargs["ranks"]`` n on the first n
    ranks alone, as a mesh of their own (the view's axis, "points" by
    default): the other ranks skip it (its result None) and wait for the
    rest at the end, for up to ``WAIT`` seconds, so calls of fewer ranks
    must come after every call of all of them. Returns their results, with ``timed``
    each as (result, seconds on this rank's clock)."""
    sizes = sorted({c[2]["ranks"] for c in calls if c[2].get("ranks")}) if ctx else []
    # every rank creates every group, in one order
    groups = {n: dist.new_group(list(range(n)), timeout=timedelta(seconds=TIMEOUT))
              for n in sizes}
    done = dist.new_group(timeout=timedelta(seconds=WAIT)) if sizes else None
    out = []
    for name, args, kwargs in calls:
        kwargs = dict(kwargs)
        view, ranks = kwargs.pop("view", None), kwargs.pop("ranks", None)
        if ctx is not None and ranks is not None and ctx.rank >= ranks:
            out.append((None, 0.0) if timed else None)
            continue
        t0 = time.perf_counter()
        if ctx is None or (view is None and ranks is None):
            scope = contextlib.nullcontext(ctx)
        else:
            scope = flat_view(ctx, view or "points", ranks=ranks, group=groups.get(ranks))
        with scope as c:
            result = globals()[name](c, *args, **kwargs)
        out.append((result, time.perf_counter() - t0) if timed else result)
        if ctx is not None and ctx.device.type == "cuda":
            torch.cuda.empty_cache()  # ranks sharing a card hand back their cached blocks
    if done is not None:
        dist.barrier(group=done)
    return out


def timed_programs(ctx, calls: list) -> list:
    """``programs(ctx, calls, timed=True)``, for ``spawn``."""
    return programs(ctx, calls, timed=True)
