"""Run one cell of the benchmark of ``nbdt_torch`` once, on the CUDA card
this process is started on, and print its result as one JSON line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are ``benchmark/workloads/*.json`` and ``BENCHMARK.json`` at the
checkout's root. A cell on one card runs in this process; a cell on more
runs one process a card (``ranks.py``), this one rank 0, which prints the
result. Exits with 2 and prints no result when there are fewer cards than
the cell asks for, with 3 when a rank loaded a module of JAX or of the JAX
package, and with 4 when a rank failed or the run outlasted its time limit.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# neither loads torch: a cell over several cards starts its other ranks first
from benchmark import cells, ranks  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec, cell, config = cells.cell_files(args.workload)
    chips = cells.cell_chips(spec, args.workload)
    started = None
    if chips > 1:
        run = {"seed": args.seed, "seconds": args.seconds, "trace": args.trace}
        started = ranks.Launch(ranks.job(args.workload, spec, cell, config, chips, "cuda",
                                         [run], ranks.time_limit(args.seconds)))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        if started is not None:
            started.end()
        print(f"no result: {args.workload} needs {chips} CUDA device(s), "
              f"this process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(harness.HOST_THREADS)
    try:
        if started is None:
            result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                      t0=T0, spec=spec, cell=cell, config=config)
        else:
            (result,) = started.run(t0=T0)
    except harness.BlockedModules as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    blocked = harness.loaded_blocked_modules()
    if blocked:
        print(f"no result: modules the port's runs may not load were loaded: {blocked}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
