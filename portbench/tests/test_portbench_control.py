"""The control of ``correct``: the reference in fp8, put in the program's
place, fails at least one of a cell's numbers under the cell's limits.
On the CPU at smoke size; ``portbench/harness/control.py`` reads the same
on the card at the cells' own sizes (``gpu``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import cell as C
from portbench.harness import checks, control
from portbench.tests.smoke import serving_cell, smoke_cell

ROOT = Path(__file__).resolve().parents[2]
TRAIN = ["internlm2-1.8b.train-b4s1024", "granite-moe-3b-a800m.train-b4s1024"]


@pytest.mark.parametrize("workload", TRAIN)
def test_the_training_control_fails(workload):
    cell, _ = smoke_cell(workload)
    got = control.train_readings(cell, 2 ** 32 + 7, torch.device("cpu"))
    for reading in ("fp8", "half_batch"):
        ok, table = checks.verdict(got[reading], cell.limits)
        assert not ok, (reading, table)


def test_the_serving_control_fails():
    cell, _ = serving_cell()
    got = control.serve_readings(cell, 2 ** 32 + 7, torch.device("cpu"), 6)
    ok, table = checks.verdict(got["fp8"], cell.limits)
    assert not ok, table


@pytest.mark.gpu
def test_the_control_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/harness/control.py", "--workload",
         "internlm2-1.8b.train-b4s1024", "--seeds", str(2 ** 32 + 21)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = C.load("internlm2-1.8b.train-b4s1024").limits
    for line in out.stdout.strip().splitlines():
        got = json.loads(line)
        ok, table = checks.verdict({k: tuple(v) for k, v
                                    in got["numbers"].items()}, limits)
        assert not ok, (got["reading"], table)
