"""The correctness check of every cell, driven on the CPU at the size its
file states through the harness's own run (no look for a card; over
several cards, gloo ranks on the CPU): a sound run of the program comes
out correct, and each fault the cell can have (its file's ``faults``),
planted in the program under the timed path, comes out not correct."""

import json
import math

import pytest
import torch

from bench_testlib import CELLS, cell_file, run_tiny
from benchmark import faults

CELL_FAULTS = [(w, f) for w in CELLS for f in cell_file(w)["faults"]]


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = run_tiny(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    for check in result["checks"].values():
        assert math.isfinite(check["value"]) and check["value"] <= check["limit"]


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_planted_fault_is_caught(workload, fault):
    result = run_tiny(workload, fault=fault)
    assert not result["correct"], result["checks"]
    json.dumps(result, allow_nan=False)  # the result line stays JSON


def test_faults_are_undone():
    from nbdt_torch import model, trainer
    from nbdt_torch.parallel.syncbn import CrossRankBatchNorm2d

    from torch.nn.parallel import DistributedDataParallel

    def now():
        return (model.NBDT.forward, model.NBDT.__call__, trainer.cross_entropy,
                torch.optim.SGD.step, DistributedDataParallel.forward,
                CrossRankBatchNorm2d.forward)

    before = now()
    for fault in faults.FAULTS + faults.RANK_FAULTS:
        with faults.plant(fault):
            assert now() != before
    assert before == now()
    with pytest.raises(ValueError):
        with faults.plant("no_such_fault"):
            pass


def test_a_run_reports_its_cells_metrics():
    result = run_tiny("resnet18_cifar10.offline")
    assert set(result["metrics"]) == {"serve_images_per_s", "setup_s"}
    assert result["metrics"]["serve_images_per_s"]["unit"] == "images/s"
    assert result["device"]["platform"] == "cpu"  # never a device metric's name from a CPU run
