"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the port (``pointsecguard_tpu_torch``), on a machine with at least
as many CUDA devices as the cell asks for; without them it exits 2 and
prints no result. The cell's driver makes the weights and the inputs
from the seed, warms up, runs the window of ``--seconds``, with
``--trace 1`` also a profiled part after it, then compares the sampled
outputs with the plain reference. The last lines of standard error give
each number compared beside its limit; the last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``. A run
whose process holds a module of JAX, flax or the JAX package once the
window has closed exits 3 and prints no result.

Build and kernel caches stay in ``build/`` of the checkout: the port's
kernel library in ``build/kernels/`` (the port fixes it there), PyTorch's
extension and Triton caches in ``build/perfbench_cache/``.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded in a run (compared whole:
# the port's package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pointsecguard_tpu")


def forbidden_modules(names) -> list[str]:
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def result(cell, bench: dict, rec: dict, trace: bool, device: dict) -> dict:
    """The result line of a record: the cell's metrics by their readers."""
    from perfbench.core.cell import cell_metrics
    from perfbench.core.run import verdict

    metrics = {}
    for m in cell_metrics(bench, cell.name, trace):
        value = cell.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": verdict(rec["checks"]), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace and rec.get("trace"):
        t = rec["trace"]
        out["device"] = {**device, "busy_s": t["busy_s"], "window_s": t["window_s"]}
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["setup_parts"] = rec.get("setup_parts", {})
    # a number that is not finite (it failed) reads null, so the line stays JSON
    out["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else None,
                         "limit": c["limit"]} for k, c in rec["checks"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    cache = ROOT / "build" / "perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from perfbench.core.cell import Cell, benchmark
    from perfbench.core.run import Run

    bench = benchmark(ROOT)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import pointsecguard_tpu_torch
    from pointsecguard_tpu_torch.utils.runtime import require_cuda

    if Path(pointsecguard_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print(f"the port was loaded from {pointsecguard_tpu_torch.__file__}, not from "
              f"this checkout ({ROOT})", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    dev = require_cuda()
    rec = cell.driver.run(cell, Run(device=dev, seed=args.seed, seconds=args.seconds,
                                    trace=bool(args.trace), started=STARTED))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": entry["chips"], "memory_peak_bytes": rec["memory_peak_bytes"],
              "power_limit": power_limit()}
    line = result(cell, bench, rec, bool(args.trace), device)
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
