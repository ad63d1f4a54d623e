"""The harness finds a cell's files by the names in ``BENCHMARK.json``: a
configuration, a traffic mix, a driver and a metric dropped into a copy
of the benchmark's folders run without an edit to any file already
there."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

from perfbench import run as runmod
from perfbench.core.cell import Cell, benchmark

DRIVER = '''
def run(cell, r):
    n = cell.workload["units"]
    return {"units": [(0.0, 1.0)] * n, "samples_per_unit": cell.workload["batch"],
            "window_s": float(n), "setup_s": 0.5, "attempted": n, "failed": 0,
            "memory_peak_bytes": 0, "size": cell.config["size"],
            "checks": {"dummy": {"value": 0.0, "limit": 1.0}}}
'''
METRIC = '''
def read(rec):
    return rec["size"] * len(rec["units"])
'''


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_is_found_by_name(tmp_path):
    src = runmod.ROOT
    shutil.copytree(src / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(src / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    bench_dir = tmp_path / "perfbench"
    (bench_dir / "configs" / "dummy-config.json").write_text(json.dumps({"size": 3}))
    (bench_dir / "workloads" / "dummy-cell.json").write_text(json.dumps(
        {"config": "dummy-config", "kind": "dummykind", "units": 4, "batch": 2}))
    (bench_dir / "drivers" / "dummykind.py").write_text(DRIVER)
    (bench_dir / "metrics" / "dummy_metric.py").write_text(METRIC)
    bench = benchmark(tmp_path)
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-cell", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_metric", "unit": "1", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy-cell"]})
    # the added entries only: every file that was there reads as before
    after = _digest(tmp_path)
    assert {k: after[k] for k in before} == before

    cell = Cell("dummy-cell", bench_dir=bench_dir)
    rec = cell.driver.run(cell, None)
    line = runmod.result(cell, bench, rec, False, {"platform": "gpu"})
    assert line["correct"] is True
    assert line["metrics"]["dummy_metric"] == {"value": 12, "unit": "1"}
    assert line["metrics"]["setup_s"]["value"] == 0.5
    assert "attack_samples_per_s" not in line["metrics"]
    assert list(line)[-1] == "checks"


def test_pool_with_fixed_rooms_deals_the_same_blocks_for_every_seed():
    from perfbench.core.traffic import make_pool

    spec = {"batches": 3, "room_points": 6000, "room_size": [2.0, 2.0, 2.8]}
    fixed = {**spec, "rooms_seed": 7}
    a, b = make_pool(fixed, 2, 256, 11), make_pool(fixed, 2, 256, 12)
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    assert sorted(x.tobytes() for p, _ in a for x in p) == \
        sorted(x.tobytes() for p, _ in b for x in p)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, make_pool(fixed, 2, 256, 11)))
    c, d = make_pool(spec, 2, 256, 11), make_pool(spec, 2, 256, 12)
    assert sorted(x.tobytes() for p, _ in c for x in p) != \
        sorted(x.tobytes() for p, _ in d for x in p)

