"""On the card, at each cell's own sizes: a short run of ``run.py`` is
correct, and the bfloat16 control is not. Skips without a CUDA device;
run on the card with ``python -m pytest perfbench/tests -m card``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import run as runmod

CELLS = ["ssg-nb", "resgcn-train", "resgcn-nb"]
SECONDS = {"ssg-nb": 3, "resgcn-train": 3, "resgcn-nb": 15}


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(name):
    _need_card()
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                          "2200000021", "--seconds", str(SECONDS[name]), "--trace", "0"],
                         cwd=runmod.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    _need_card()
    out = subprocess.run([sys.executable, "perfbench/calibrate.py", "--workload", name,
                          "--seconds", str(SECONDS[name]), "--runs", "control:2200000031"],
                         cwd=runmod.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
