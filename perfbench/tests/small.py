"""Cells at sizes a CPU test run holds: the benchmark's cells with a few
small blocks, ResGCN at 3 blocks (PointNet++ SSG keeps its sizes, which
the port fixes, on blocks of 2048 points)."""

from __future__ import annotations

import copy
import time

import torch

from perfbench.core import faults
from perfbench.core.cell import Cell
from perfbench.core.run import Run


def small_cell(name: str) -> Cell:
    cell = Cell(name)
    wl, cfg = copy.deepcopy(cell.workload), copy.deepcopy(cell.config)
    ssg = cfg["model"] == "pointnet2_ssg"
    wl.update(batch=2, points=2048 if ssg else 256,
              pool={"batches": 3, "room_points": 6000, "room_size": [2.0, 2.0, 2.8]})
    if wl["kind"] == "attack":
        wl.update(calibrate_blocks=2, check={**wl["check"], "batches": 2})
    if not ssg:
        cfg["n_blocks"] = 3
    return Cell(name, workload=wl, config=cfg)


def small_run(cell: Cell, *, seed: int = 2_200_000_011, seconds: float = 1.0,
              precision: str | None = None, fault: str | None = None, trace: bool = False):
    """The driver's record of one CPU run of ``cell``."""
    run = Run(device=torch.device("cpu"), seed=seed, seconds=seconds, trace=trace,
              started=time.perf_counter(), precision=precision,
              hooks=faults.hooks(cell.workload["kind"], fault))
    return cell.driver.run(cell, run)
