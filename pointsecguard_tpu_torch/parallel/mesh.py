"""Rank layout, batch slicing and the rank launcher (port of
``pointsecguard_tpu/parallel/mesh.py``).

JAX lays its devices out as one ``Mesh``: a 1-D ``data`` axis, or a 2-D
``data × points`` grid (row-major, points innermost), and lets GSPMD place
every collective. Eager PyTorch has no partitioner, so here a mesh is a
list of rank devices and a points size, and every rank is a process of its
own (``spawn``) joined by ``torch.distributed``: rank ``d · P + p`` holds
data slice ``d`` and points shard ``p``. A ``RankContext`` carries this
rank's device and two groups: the data group (the ranks of one points
shard across the data slices: BatchNorm statistics, gathered predictions)
and the points group (the ranks of one data slice: the points-sharded kNN).
Every collective the port runs is written out where it runs
(``spmd_ops.py``, ``models/common.py:BatchNorm``, ``train/trainer.py``), so
N ranks compute what one process computes on the whole batch.

The backend is NCCL for CUDA ranks on distinct cards and gloo otherwise;
``Mesh`` takes an explicit rank → device list and backend, so that several
gloo ranks can share one card. Every group is created with ``TIMEOUT``
seconds, and a rank that raises ends the whole run with the error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import sys
import traceback
from datetime import timedelta
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from pointsecguard_tpu_torch.utils.runtime import resolve_device, set_data_slice

TIMEOUT = 120  # seconds every group waits in a collective before it fails


class Mesh(NamedTuple):
    """The rank devices of a run and the size of its points axis; the data
    axis is ``len(devices) // points``."""

    devices: tuple[torch.device, ...]
    points: int = 1
    backend: str = "gloo"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {"data": self.size // self.points, "points": self.points}


def make_mesh(devices, *, points_axis: int = 1, backend: str | None = None) -> Mesh:
    """1-D data mesh by default; 2-D (data × points) if points_axis > 1.
    ``backend`` defaults to NCCL when every rank has a card of its own,
    gloo otherwise."""
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if points_axis > 1 and n % points_axis:
        raise ValueError(f"{n} devices not divisible by points axis {points_axis}")
    if backend is None:
        distinct = len(set(devices)) == n
        backend = "nccl" if all(d.type == "cuda" for d in devices) and distinct else "gloo"
    return Mesh(devices, max(points_axis, 1), backend)


def data_parallel_mesh(n_devices: int, shard_points: int = 1, *,
                       device: str = "cuda") -> Mesh | None:
    """Driver-facing mesh factory behind the CLIs' ``--devices`` flag: None
    for one device (no ranks, no collectives); else ``n_devices`` ranks,
    one a card (``--device cuda``, NCCL; no more than there are cards) or
    processes on the CPU (``--device cpu``, gloo), with a points axis of
    ``shard_points``. Raises with the JAX package's messages."""
    if n_devices is None or n_devices <= 1:
        if shard_points and shard_points > 1:
            raise ValueError(
                f"--shard_points {shard_points} requires --devices >= "
                f"{shard_points} (got {n_devices or 1}); a 1-device run "
                "would silently ignore the points sharding"
            )
        return None
    if device == "cuda":
        available = torch.cuda.device_count()
        if n_devices > available:
            raise ValueError(f"--devices {n_devices} > {available} available (gpu)")
        devs = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devs = [torch.device("cpu")] * n_devices
    if shard_points and shard_points > 1 and n_devices % shard_points:
        raise ValueError(
            f"--devices {n_devices} not divisible by --shard_points {shard_points}"
        )
    return make_mesh(devs, points_axis=shard_points or 1)


@dataclasses.dataclass
class RankContext:
    """One rank of a mesh: its global rank, device and groups (None where
    the axis has size 1: no collective is needed there). ``group`` holds
    every rank of the mesh: None for the default group of all processes,
    a group of its own for a mesh of fewer ranks (``flat_view``'s
    ``ranks``)."""

    rank: int
    mesh: Mesh
    device: torch.device
    data_group: object = None
    points_group: object = None
    group: object = None

    @property
    def world_size(self) -> int:
        return self.mesh.size

    @property
    def points_size(self) -> int:
        return self.mesh.points

    @property
    def data_size(self) -> int:
        return self.mesh.size // self.mesh.points

    @property
    def data_rank(self) -> int:
        return self.rank // self.mesh.points

    @property
    def points_rank(self) -> int:
        return self.rank % self.mesh.points

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def is_main(ctx: RankContext | None) -> bool:
    """True on the rank that writes a run's files (rank 0, or no mesh)."""
    return ctx is None or ctx.is_main


def init_rank(rank: int, mesh: Mesh, init_method: str) -> RankContext:
    """Join the process group of ``mesh`` as ``rank`` and build its data and
    points groups (every rank creates every group, in one order). The
    rank's device is resolved through ``utils.runtime.resolve_device``
    (TF32 off), and its data slice recorded for ``batch_draw``."""
    dev = mesh.devices[rank]
    device = resolve_device(dev.type, dev.index or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(device)
    timeout = timedelta(seconds=TIMEOUT)
    dist.init_process_group(mesh.backend, init_method=init_method, world_size=mesh.size,
                            rank=rank, timeout=timeout)
    P, D = mesh.points, mesh.size // mesh.points
    ctx = RankContext(rank, mesh, device)
    if D > 1:
        for p in range(P):
            ranks = [d * P + p for d in range(D)]
            g = dist.group.WORLD if P == 1 else dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                ctx.data_group = g
    if P > 1:
        for d in range(D):
            ranks = [d * P + p for p in range(P)]
            g = dist.group.WORLD if D == 1 else dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                ctx.points_group = g
    set_data_slice(ctx.data_rank, D)
    return ctx


@contextlib.contextmanager
def flat_view(ctx: RankContext, axis: str, *, ranks: int | None = None, group=None):
    """``ctx``'s ranks seen as a 1-D mesh over the world group: all along
    the data axis (``"data"``, as JAX's ``data_parallel_mesh(n)``) or all
    along the points axis (``"points"``); the rank's data slice is the
    view's inside the block. Lets one start of the ranks run programs of
    several layouts. With ``ranks`` n: the first n ranks only, over
    ``group``, the group of those ranks that every rank created (a rank
    past them must not enter the block)."""
    n = ranks or ctx.world_size
    if ctx.rank >= n:
        raise ValueError(f"rank {ctx.rank} is not one of the view's {n} ranks")
    world = group if ranks else (dist.group.WORLD if ctx.world_size > 1 else None)
    points = n if axis == "points" else 1
    view = RankContext(ctx.rank, ctx.mesh._replace(devices=ctx.mesh.devices[:n], points=points),
                       ctx.device, data_group=world if axis == "data" else None,
                       points_group=world if axis == "points" else None,
                       group=group if ranks else ctx.group)
    set_data_slice(view.data_rank, view.data_size)
    try:
        yield view
    finally:
        set_data_slice(ctx.data_rank, ctx.data_size)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _portable(value):
    """``value`` with every tensor as a numpy array, so that it crosses a
    process boundary without shared memory; None in place of any other
    object (a model, a train state)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_portable(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_portable(v) for v in value)
    if isinstance(value, dict):
        return {k: _portable(v) for k, v in value.items()}
    plain = (int, float, str, bool, type(None), np.ndarray, np.generic)
    return value if isinstance(value, plain) else None


def _rank_main(rank, fn, mesh, init_method, args, queue, threads):
    if mesh.devices[rank].type == "cpu":  # CPU ranks share the spawner's threads
        torch.set_num_threads(threads)
    ctx = init_rank(rank, mesh, init_method)
    try:
        result = fn(ctx, *args)
        queue.put((rank, _portable(result)))
        dist.barrier()  # no rank tears the store down under another
    except BaseException:
        # the spawner reports the first rank it sees fail, which may be one
        # that a failed peer left waiting: each rank says what it met
        print(f"rank {rank}:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, mesh: Mesh, args: tuple = ()) -> list:
    """Run ``fn(ctx, *args)`` on every rank of ``mesh``, each a process
    started with ``spawn`` (the ranks touch CUDA, so never ``fork``), and
    return the ranks' results in rank order (tensors as numpy arrays).
    ``fn`` must be importable by the children: a module-level function of
    this package. A CPU rank takes this process's torch threads divided by
    the ranks. A rank that raises makes this raise once the others are
    stopped. A mesh of one rank runs in this process. Under ``torchrun``
    (``WORLD_SIZE`` set) this process is one rank already: ``fn`` runs here
    and only its own result is returned, at its rank's index."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world != mesh.size:
            raise ValueError(f"torchrun WORLD_SIZE {world} != --devices {mesh.size}")
        if mesh.devices[rank].type == "cuda":
            local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
            mesh = mesh._replace(devices=tuple(
                local if i == rank else d for i, d in enumerate(mesh.devices)))
        init_method = "env://"
    elif mesh.size == 1:
        rank, init_method = 0, f"tcp://127.0.0.1:{_free_port()}"
    else:
        return _spawn_ranks(fn, mesh, args)
    ctx = init_rank(rank, mesh, init_method)
    try:
        result = _portable(fn(ctx, *args))
    finally:
        dist.destroy_process_group()
        set_data_slice(0, 1)
    return [result if i == rank else None for i in range(mesh.size)]


def _spawn_ranks(fn: Callable, mesh: Mesh, args: tuple) -> list:
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    threads = max(1, torch.get_num_threads() // mesh.size)
    procs = mp.start_processes(
        _rank_main, args=(fn, mesh, f"tcp://127.0.0.1:{_free_port()}", args, queue, threads),
        nprocs=mesh.size, join=False, start_method="spawn")
    results: dict = {}

    def drain():
        while not queue.empty():
            r, value = queue.get()
            results[r] = value

    while not procs.join(timeout=0.5):
        drain()
    drain()
    return [results.get(r) for r in range(mesh.size)]


def run_cli(fn: Callable, args, *, device: str):
    """``fn(args, ctx)`` as a CLI runs it: directly with ``ctx=None`` under
    ``--devices 1``, else on the ranks of ``data_parallel_mesh(--devices,
    --shard_points)``, returning rank 0's result."""
    mesh = data_parallel_mesh(getattr(args, "devices", 1),
                              getattr(args, "shard_points", 1), device=device)
    if mesh is None:
        return fn(args, None)
    return spawn(_cli_rank, mesh, (fn, args))[0]


def _cli_rank(ctx: RankContext, fn: Callable, args):
    return fn(args, ctx)


def _slices(ctx: RankContext, batch_size: int | None, shard_points: bool, axis: int):
    """The rank's slice of axes ``axis`` (batch) and ``axis + 1`` (points)
    of a host array; arrays of fewer than ``axis + 2`` dims are replicated."""
    n = ctx.data_size
    if batch_size is not None and batch_size % n:
        raise ValueError(f"batch size {batch_size} not divisible by the data axis ({n})")
    pa = ctx.points_size if shard_points else 1

    def put(x):
        if np.ndim(x) < axis + 2:
            return x
        shape = np.shape(x)
        if pa > 1 and shape[axis + 1] % pa:
            raise ValueError(f"points axis {shape[axis + 1]} not divisible by "
                             f"--shard_points {pa}")
        if shape[axis] % n:
            raise ValueError(f"batch size {shape[axis]} not divisible by the data axis ({n})")
        b, m = shape[axis] // n, shape[axis + 1] // pa
        index = [slice(None)] * axis + [slice(ctx.data_rank * b, (ctx.data_rank + 1) * b)]
        if pa > 1:
            index.append(slice(ctx.points_rank * m, (ctx.points_rank + 1) * m))
        return x[tuple(index)]

    return put


def make_batch_put(ctx: RankContext | None, *, batch_size: int | None = None,
                   shard_points: bool = False, device: torch.device | None = None):
    """host array → this rank's part of it: its rows of the batch axis (0),
    with ``shard_points`` also its shard of the points axis (1); arrays of
    fewer than 2 dims (class weights, cloud indices) are replicated, as in
    JAX. Validates that ``batch_size`` divides the data axis once up front.
    With ``device`` the part is copied there. ``ctx=None``: the whole
    array."""
    cut = (lambda x: x) if ctx is None else _slices(ctx, batch_size, shard_points, 0)
    if device is None:
        return cut
    return lambda x: torch.from_numpy(np.array(cut(x))).to(device)


def make_stacked_batch_put(ctx: RankContext | None, *, batch_size: int | None = None,
                           shard_points: bool = False, device: torch.device | None = None):
    """``make_batch_put`` for K-step stacks ``[K, B, ...]``
    (``data.loader.stack_batches``): the batch axis is axis 1, the points
    axis axis 2; arrays of fewer than 3 dims are replicated."""
    cut = (lambda x: x) if ctx is None else _slices(ctx, batch_size, shard_points, 1)
    if device is None:
        return cut
    return lambda x: torch.from_numpy(np.array(cut(x))).to(device)


def shard_batch(ctx: RankContext | None, tree, *, shard_points: bool = False):
    """``make_batch_put`` applied to every leaf of a tuple, list or dict of
    host arrays: the rank's part of each (1-D leaves whole, as in JAX)."""
    put = make_batch_put(ctx, shard_points=shard_points)
    if isinstance(tree, dict):
        return {k: put(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(put(v) for v in tree)
    return put(tree)


def replicate(ctx: RankContext | None, tensors):
    """Broadcast ``tensors`` (a module's parameters and buffers, or a list
    of tensors) from rank 0 in place, so every rank starts from rank 0's
    state; returns its argument."""
    if ctx is None:
        return tensors
    items = (list(tensors.parameters()) + list(tensors.buffers())
             if isinstance(tensors, torch.nn.Module) else list(tensors))
    with torch.no_grad():
        for t in items:
            dist.broadcast(t.data, src=0, group=ctx.group)
    return tensors

