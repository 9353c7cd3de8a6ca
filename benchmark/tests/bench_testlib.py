"""Tiny versions of the benchmark's cells for the CPU tests: the real cell
and configuration files cut to the CPU size each cell states under its
``"tiny"`` key (parameters, the configuration's ``model`` sizes and
``program`` constructor, and ``ranks``: gloo processes on the CPU for a
cell over several cards), with a calibration batch of 32. ``CELLS`` are
BENCHMARK.json's cells and the cells whose files wait outside it
(``cells.waiting_cells``): the tests of the traffic kinds and the checks
run both."""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells, faults, harness, ranks  # noqa: E402

SPEC = cells.load_json(ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
WAITING = cells.waiting_cells(SPEC)
CELLS = WORKLOADS + WAITING
CONFIGS = [c["name"] for c in SPEC["configs"]]
SEED = 20261018


def cell_file(workload: str) -> dict:
    return cells.load_json(cells.BENCH / "workloads" / f"{workload}.json")


def cells_of_kind(kind: str) -> list:
    return [w for w in CELLS if cell_file(w)["kind"] == kind]


def chips_of(workload: str) -> int:
    return cells.cell_chips(cells.with_waiting(SPEC, workload), workload)


def tiny_cell(workload: str):
    """(BENCHMARK.json, the cell, its configuration), cut to a CPU size."""
    spec, cell, config = cells.cell_files(workload, cells.with_waiting(SPEC, workload))
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    tiny = cell["tiny"]
    cell["params"].update(tiny["params"])
    config["model"].update(tiny.get("model", {}))
    if "program" in tiny:
        config["program"] = tiny["program"]
    config["init"]["calibration_images"] = 32
    return spec, cell, config


def tiny_ranks(workload: str) -> int:
    return cell_file(workload)["tiny"].get("ranks", 1)


# rank 0 of a tiny run over several ranks, in a process of its own: the
# launch ends its process where a rank fails
LAUNCH = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from benchmark import ranks
torch.set_num_threads(1)
ranks.launch(json.loads(sys.argv[2]), report=lambda r: print(json.dumps(r), flush=True))
"""


def launch_tiny(workload: str, runs: list, timeout_s: float = 240.0):
    """Rank 0's process of a tiny run over the cell's ``ranks`` gloo ranks:
    its exit code, its result lines, its standard error."""
    spec, cell, config = tiny_cell(workload)
    job = ranks.job(workload, spec, cell, config, tiny_ranks(workload), "cpu", runs, timeout_s)
    out = subprocess.run([sys.executable, "-c", LAUNCH, str(ROOT), json.dumps(job)], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout_s + 60)
    lines = [json.loads(s) for s in out.stdout.splitlines() if s.startswith("{")]
    return out.returncode, lines, out.stderr


def run_tiny(workload: str, seed: int = SEED, fault: str = None, **kw) -> dict:
    """One tiny run of ``workload`` on the CPU, with ``fault`` planted
    (on every rank); in this process where the cell takes one card."""
    if tiny_ranks(workload) > 1:
        code, lines, err = launch_tiny(workload, [{"seed": seed, "seconds": 0.2, "trace": 0,
                                                   "fault": fault, **kw}])
        assert code == 0 and len(lines) == 1, err[-3000:]
        return lines[0]
    spec, cell, config = tiny_cell(workload)
    with faults.plant(fault) if fault else contextlib.nullcontext():
        return harness.run_cell(workload, seed, 0.2, False, device="cpu",
                                spec=spec, cell=cell, config=config, **kw)


class PixelNet(torch.nn.Module):
    """A tiny reference whose classifier is a 1x1 convolution and whose
    ``features`` are one row a pixel, as a segmentation head's."""

    def __init__(self, classes: int, dim: int):
        super().__init__()
        self.body = torch.nn.Sequential(torch.nn.Conv2d(3, dim, 3, padding=1),
                                        torch.nn.BatchNorm2d(dim), torch.nn.ReLU())
        self.classifier = torch.nn.Conv2d(dim, classes, 1)

    @classmethod
    def from_sizes(cls, m: dict):
        return cls(m["num_classes"], m["feature_dim"])

    def features(self, x):
        f = self.body(x)
        return f.permute(0, 2, 3, 1).reshape(-1, f.shape[1])

    def forward(self, x):
        return self.classifier(self.body(x))
