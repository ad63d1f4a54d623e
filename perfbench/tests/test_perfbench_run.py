"""``run.py``'s guards: the look for JAX's modules compares whole
top-level names; without a card, and in a checkout that holds only
``BENCHMARK.json`` and ``perfbench/``, it exits with another code than 0
and prints no result."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from perfbench import run as runmod


def test_forbidden_modules_by_whole_top_level_name():
    names = ["pointsecguard_tpu_torch", "pointsecguard_tpu_torch.ops", "torch", "numpy.linalg"]
    assert runmod.forbidden_modules(names) == []
    assert runmod.forbidden_modules(names + ["jax.numpy", "flax", "pointsecguard_tpu.ops"]) == \
        ["flax", "jax", "pointsecguard_tpu"]
    assert runmod.forbidden_modules(["jaxlib.xla_client", "jaxtyping"]) == ["jaxlib"]


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "ssg-nb",
                           "--seed", "2200000013", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(runmod.ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_no_result_without_the_port(tmp_path):
    shutil.copytree(runmod.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(runmod.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
