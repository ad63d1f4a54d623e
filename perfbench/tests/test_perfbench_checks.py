"""The correctness check drives a whole run below the look for a card,
here on the CPU at a small size: sound runs come out correct; the
bfloat16 control and each fault planted under the timed path come out
not correct (``core/faults.py``)."""

from __future__ import annotations

import pytest

from perfbench.core.faults import FAULTS
from perfbench.core.run import verdict
from perfbench.tests.small import small_cell, small_run

CELLS = ["ssg-nb", "resgcn-train", "resgcn-nb"]
FAULTED = [(c, f) for c in CELLS for f in sorted(FAULTS[small_cell(c).workload["kind"]])]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    rec = small_run(small_cell(name))
    assert verdict(rec["checks"]), rec["checks"]
    assert rec["units"] and rec["window_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    rec = small_run(small_cell(name), precision="bfloat16")
    assert not verdict(rec["checks"]), rec["checks"]


@pytest.mark.parametrize("name,fault", FAULTED)
def test_fault_is_not_correct(name, fault):
    rec = small_run(small_cell(name), fault=fault)
    assert not verdict(rec["checks"]), rec["checks"]
