"""Run one cell of the benchmark of ``nbdt_torch`` once, on the CUDA card
this process is started on, and print its result as one JSON line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are ``benchmark/workloads/*.json`` and ``BENCHMARK.json`` at the
checkout's root. Exits with 2 and prints no result when there is no card,
and with 3 when a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec, cell, config = harness.cell_files(args.workload)
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {args.workload} needs {chips} CUDA device(s), "
              f"this process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(harness.HOST_THREADS)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t0=T0, spec=spec, cell=cell, config=config)
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
