"""A cell over several cards, on the CPU: its tiny form runs on gloo ranks
through the harness's launch (``ranks.py``), one process a rank. Rank 0
prints exactly one result line, whose checks are every rank's; a check
that fails on another rank makes the run not correct; a rank that exits
or hangs ends the run with no result."""

import math

import pytest

from bench_testlib import CELLS, SEED, launch_tiny, tiny_ranks
from benchmark import harness

SPREAD = [w for w in CELLS if tiny_ranks(w) > 1]


def run(fault=None, fault_ranks=None):
    spec = {"seed": SEED, "seconds": 0.2, "trace": 0}
    if fault:
        spec.update(fault=fault, fault_ranks=fault_ranks)
    return spec


@pytest.mark.parametrize("workload", SPREAD)
def test_rank_0_prints_one_result_line(workload):
    code, lines, err = launch_tiny(workload, [run()])
    assert code == 0, err[-3000:]
    assert len(lines) == 1
    (result,) = lines
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == tiny_ranks(workload)
    assert list(result)[-1] == "checks" and "replica_gap" in result["checks"]


@pytest.mark.parametrize("workload", SPREAD)
def test_a_check_that_fails_on_rank_1_makes_the_run_not_correct(workload):
    """Rank 1 alone leaves its weights unchanged: rank 0's own numbers
    hold, and rank 1's replica gap does not."""
    code, lines, err = launch_tiny(workload, [run("state_unchanged", [1])])
    assert code == 0 and len(lines) == 1, err[-3000:]
    checks = lines[0]["checks"]
    assert not lines[0]["correct"]
    assert checks["replica_gap"]["value"] > checks["replica_gap"]["limit"]
    assert all(c["value"] <= c["limit"] for name, c in checks.items() if name != "replica_gap")


@pytest.mark.parametrize("workload", SPREAD)
@pytest.mark.parametrize("fault", ["rank_exits", "rank_hangs"])
def test_a_rank_that_ends_ends_the_run_with_no_result(workload, fault):
    code, lines, err = launch_tiny(workload, [run(fault, [1])], timeout_s=30.0)
    assert code != 0 and lines == [], err[-3000:]


def test_merged_checks_take_each_numbers_worst_rank():
    merged = harness.merge_checks([{"a": (1e-4, 1e-3), "b": (0.0, 0.0)},
                                   {"b": (2e-3, 0.0)}, {"b": (float("nan"), 0.0)}])
    assert merged["a"] == (1e-4, 1e-3)
    assert merged["b"][0] == math.inf and merged["b"][1] == 0.0
