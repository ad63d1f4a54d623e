"""Read a cell's compared numbers over many seeds in one process: the
port as the configuration states it, the lower-precision control, and
planted faults, each run through the cell's driver with a short window.
The limits in ``workloads/<cell>.json`` are set from these readings.

    python3 perfbench/calibrate.py --workload ssg-nb --seconds 3 \
        --runs program:101-112 control:201-203 half_batch:301-303 \
        [--out FILE]

A run is ``<what>:<first>-<last>`` over seeds, ``what`` being
``program``, ``control`` (``--precision`` of the control, bfloat16 by
default) or a fault of ``core/faults.py``. Prints one JSON line a seed
(also appended to ``--out``); needs a CUDA device like ``run.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(spec: str) -> tuple[str, list[int]]:
    what, _, span = spec.partition(":")
    first, _, last = span.partition("-")
    return what, list(range(int(first), int(last or first) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--runs", nargs="+", required=True)
    ap.add_argument("--precision", default="bfloat16", help="the control's precision")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.core import faults
    from perfbench.core.cell import Cell
    from perfbench.core.run import Run, verdict
    from pointsecguard_tpu_torch.utils.runtime import require_cuda

    dev = require_cuda()
    cell = Cell(args.workload)
    kind = cell.workload["kind"]
    for spec in args.runs:
        what, seed_list = seeds(spec)
        for seed in seed_list:
            t = time.perf_counter()
            run = Run(device=dev, seed=seed, seconds=args.seconds, trace=False, started=t,
                      precision=args.precision if what == "control" else None,
                      hooks=faults.hooks(kind, None if what in ("program", "control") else what))
            rec = cell.driver.run(cell, run)
            line = {"workload": args.workload, "what": what, "seed": seed,
                    "correct": verdict(rec["checks"]), "units": len(rec["units"]),
                    "memory_peak_bytes": rec["memory_peak_bytes"],
                    "seconds": time.perf_counter() - t,
                    "numbers": {k: c["value"] for k, c in rec["checks"].items()},
                    "look": rec.get("look")}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            del rec
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
