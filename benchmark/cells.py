"""A cell's files, found by name; no import of torch, so that a run over
several cards can start its other ranks before this process loads it."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_files(workload: str, spec: dict = None):
    """(BENCHMARK.json, the cell, its configuration) of a cell's name."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cell = load_json(BENCH / "workloads" / f"{workload}.json")
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None or (entry["config"], entry["traffic"]) != (cell["config"], cell["traffic"]):
        raise ValueError(f"{workload}: not in BENCHMARK.json as its file says")
    return spec, cell, load_json(BENCH / "configs" / f"{cell['config']}.json")


def cell_chips(spec: dict, workload: str) -> int:
    """The cards a cell asks for."""
    return next(w["chips"] for w in spec["workloads"] if w["name"] == workload)


def waiting_cells(spec: dict) -> list:
    """Cells whose files wait outside BENCHMARK.json for the PR that adds
    them: each file's ``waiting`` states the cards it will ask for and why
    it waits. ``run.py`` runs none of them; the CPU tests and
    ``calibrate.py`` do."""
    named = {w["name"] for w in spec["workloads"]}
    return sorted(p.stem for p in (BENCH / "workloads").glob("*.json")
                  if p.stem not in named and "waiting" in load_json(p))


def with_waiting(spec: dict, workload: str) -> dict:
    """``spec``, with the entry of ``workload`` added where its file waits
    outside it (:func:`waiting_cells`)."""
    if any(w["name"] == workload for w in spec["workloads"]):
        return spec
    cell = load_json(BENCH / "workloads" / f"{workload}.json")
    entry = {"name": workload, "config": cell["config"], "traffic": cell["traffic"],
             "chips": cell["waiting"]["chips"], "why": cell["why"]}
    return {**spec, "workloads": spec["workloads"] + [entry]}
