"""The control of each cell's correctness check, on the card: the plain
reference put in the program's place and computed in TF32, the nearest
precision below the configurations' f32 with TF32 off, has to come out not
correct, and the program correct, at a size a test run holds (each cell's
``control_test`` parameters: smaller batches and windows than the cells';
``calibrate.py`` reads the same at the cells' own sizes), on as many cards
as the cell asks for. Skipped where there are fewer CUDA devices."""

import pytest
import torch

from bench_testlib import SPEC, WORKLOADS, cell_file
from benchmark import cells
from benchmark.calibrate import readings


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_tf32_is_not_correct(workload):
    chips = cells.cell_chips(SPEC, workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s): TF32 exists on the card only")
    cell = cell_file(workload)
    seconds = 0 if cell["kind"].startswith("train") else 1
    program = readings(workload, 71, seconds, params=cell["control_test"])
    control = readings(workload, 71, seconds, variant="control", params=cell["control_test"])
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
