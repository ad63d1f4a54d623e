"""A cell and the files it is made of, found by the names in
``BENCHMARK.json``: ``workloads/<cell>.json`` (the traffic), the
``configs/<config>.json`` it names (the model's sizes), and the modules
``drivers/<kind>.py``, ``ports/<model>.py``, ``reference/<model>.py`` and
``metrics/<metric>.py``, each loaded from its file."""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    name = "perfbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files.
    ``workload`` and ``config`` may be given as dicts (the tests' small
    sizes); otherwise they are read by name under ``bench_dir``."""

    def __init__(self, name: str, bench_dir: Path = BENCH_DIR, *, workload: dict | None = None,
                 config: dict | None = None):
        self.name = name
        self.bench_dir = Path(bench_dir)
        self.workload = workload or load_json(self.bench_dir / "workloads" / f"{name}.json")
        self.config = config or load_json(
            self.bench_dir / "configs" / f"{self.workload['config']}.json")

    def module(self, folder: str, name: str):
        return load_module(self.bench_dir / folder / f"{name}.py")

    @functools.cached_property
    def driver(self):
        return self.module("drivers", self.workload["kind"])

    @functools.cached_property
    def port(self):
        return self.module("ports", self.config["model"])

    @functools.cached_property
    def reference(self):
        return self.module("reference", self.config["model"])

    def metric(self, name: str):
        return self.module("metrics", name)


def benchmark(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones; an entry with ``workloads`` only in
    the cells it lists."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
