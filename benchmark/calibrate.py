"""The readings that the limits of a cell's correctness check are set
from. Not part of a benchmark run: one process (over several cards, one
rank a card, as ``run.py`` runs them) runs the cell once per seed (set-up,
a short window, the check) and prints each run's numbers as a JSON line,
for

- the program on ``--seeds`` (the lower readings),
- the control, the reference in TF32 in the program's place, on
  ``--control-seeds`` (upper readings),
- each fault of ``--faults`` planted in the program (``faults.py``; on
  every rank), on ``--fault-seeds``.

    python3 benchmark/calibrate.py --workload resnet18_cifar10.offline \\
        --seeds 1,2,3 --control-seeds 4,5,6 --seconds 2

A cell whose file waits outside BENCHMARK.json (``cells.waiting_cells``)
runs on the cards its file states.
"""

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import cells, faults, harness, ranks  # noqa: E402


def all_readings(workload: str, runs: list, seconds: float, params: dict = None,
                 report=None) -> list:
    """Runs on the card(s) that the cell asks for, one a ``(seed, variant,
    fault)`` of ``runs``: each run's compared numbers, end-to-end metrics
    and window facts, also handed to ``report`` as it comes; ``params``
    override the cell's."""
    spec = cells.with_waiting(cells.load_json(cells.ROOT / "BENCHMARK.json"), workload)
    spec, cell, config = cells.cell_files(workload, spec)
    cell = copy.deepcopy(cell)
    cell["params"].update(params or {})
    lines, t0 = [], time.perf_counter()

    def line(result):
        nonlocal t0
        seed, variant, fault = runs[len(lines)]
        now = time.perf_counter()
        lines.append({"workload": workload, "seed": seed, "variant": variant, "fault": fault,
                      "params": params or {}, "correct": result["correct"],
                      "attempted": result["attempted"], "failed": result["failed"],
                      "checks": {k: v["value"] for k, v in result["checks"].items()},
                      "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                      "seconds": now - t0, "facts": result["facts"]})
        t0 = now
        if report is not None:
            report(lines[-1])

    chips = cells.cell_chips(spec, workload)
    if chips > 1:
        job = ranks.job(workload, spec, cell, config, chips, "cuda",
                        [{"seed": s, "seconds": seconds, "trace": False, "variant": v,
                          "fault": f, "keep_facts": True} for s, v, f in runs],
                        ranks.time_limit(seconds, len(runs)))
        ranks.launch(job, t0=t0, report=line)
        return lines
    for seed, variant, fault in runs:
        with faults.plant(fault) if fault else contextlib.nullcontext():
            result = harness.run_cell(workload, seed, seconds, False, "cuda", variant,
                                      t0=t0, spec=spec, cell=cell, config=config,
                                      keep_facts=True)
        harness.free_memory("cuda")
        line(result)
    return lines


def readings(workload: str, seed: int, seconds: float, variant: str = "program",
             fault: str = None, params: dict = None) -> dict:
    """One run on the card(s): its compared numbers, end-to-end metrics and
    window facts; ``params`` override the cell's."""
    return all_readings(workload, [(seed, variant, fault)], seconds, params)[0]


def ints(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=ints, default=[])
    parser.add_argument("--control-seeds", type=ints, default=[])
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", type=ints, default=[])
    parser.add_argument("--out", default=None, help="also append the lines to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(harness.HOST_THREADS)
    runs = [(s, "program", None) for s in args.seeds]
    runs += [(s, "control", None) for s in args.control_seeds]
    runs += [(s, "program", f) for f in args.faults.split(",") if f for s in args.fault_seeds]
    out = open(args.out, "a") if args.out else None

    def report(reading):
        line = json.dumps(reading)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        all_readings(args.workload, runs, args.seconds, report=report)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
