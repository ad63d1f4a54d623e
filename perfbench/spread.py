"""Run cells as the benchmark's check runs them, one process a run, and
give each metric's median and spread.

    python3 perfbench/spread.py --workload ssg-nb --seeds 11-16 --sets 2 \
        [--seconds 30] [--trace 0] [--out FILE]

Each set runs ``run.py`` once a seed, in order; with ``--sets 2`` the same
seeds again. Every run's result line (or its failure, with the end of its
standard error) goes to ``--out`` as a JSON line; at the end each set's
median and spread of each metric are printed: the distance between the
first and the third quartile (``statistics.quantiles(values, n=4)``) as
a share of the median. ``--seconds`` defaults to ``BENCHMARK.json``'s
``run_seconds``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> tuple[float, float]:
    """(median, (Q3 − Q1) / median)."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("nan")


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                           workload, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True)
    out = {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode,
           "wall_s": time.perf_counter() - t}
    lines = proc.stdout.strip().splitlines()
    try:
        out["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        out["stderr"] = proc.stderr[-4000:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first-last")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    first, _, last = args.seeds.partition("-")
    seeds = range(int(first), int(last or first) + 1)
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            r = one(args.workload, seed, seconds, args.trace)
            r["set"] = k
            runs.append(r)
            print(json.dumps(r), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
        sets.append(runs)
    for k, runs in enumerate(sets):
        ok = [r["result"] for r in runs if "result" in r]
        names = sorted({m for r in ok for m in r["metrics"]})
        summary = {"set": k, "runs": len(runs), "results": len(ok),
                   "correct": sum(bool(r["correct"]) for r in ok)}
        for m in names:
            vals = [r["metrics"][m]["value"] for r in ok if m in r["metrics"]]
            if len(vals) >= 2:
                summary[m] = dict(zip(("median", "spread"), spread(vals)), n=len(vals))
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
