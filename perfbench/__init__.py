"""The benchmark of the PyTorch and CUDA port (``pointsecguard_tpu_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once on the first CUDA device and prints one JSON line.
What a cell runs is data: ``BENCHMARK.json`` names the cells and metrics,
``workloads/<cell>.json`` the traffic, ``configs/<config>.json`` the model's
sizes, and the harness finds ``drivers/<kind>.py``, ``ports/<model>.py``,
``reference/<model>.py`` and ``metrics/<metric>.py`` by those names.
Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
