"""Runs of a cell over several cards, one process a card.

Rank 0 is the process that makes a :class:`Launch`. It starts ranks 1 to
``world - 1`` as ``python3 benchmark/ranks.py <job file>``, each with
``NBDT_COORDINATOR`` (a ``file://`` store in a temporary directory, so no
port is needed), ``NBDT_NUM_PROCESSES``, ``NBDT_PROCESS_ID`` and
``LOCAL_RANK``, and every rank joins the process group through the
program's own ``initialize_multihost()``, as ``--multihost`` does (NCCL
between cards, gloo on the CPU). Every rank then runs each run of the job
through ``harness.run_cell``, with the run's fault planted where the job
says; rank 0 alone gets the results. Ranks other than 0 print nothing on
standard output.

A rank that exits with an error, a rank 0 that is gone, or a job that
outlasts its time limit ends every rank with no result. Importing this
module loads no torch: rank 0 starts the others before it loads it.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import cells  # noqa: E402

POLL_S = 0.2
TEARDOWN_S = 60.0  # from the last run's end to every rank's exit
LAG = 2  # calls of ``Group.agree`` after which every rank has rank 0's reading
# Group formation and the collectives stay on the host: the ranks' own
# loopback, never another interface.
SOCKETS = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}


def time_limit(seconds: float, runs: int = 1) -> float:
    """Seconds a job of ``runs`` runs of ``seconds`` each may take, from its
    start to its last rank's exit."""
    return 240.0 + runs * (60.0 + 3.0 * seconds)


def job(workload: str, spec: dict, cell: dict, config: dict, world: int, device: str,
        runs: list, timeout_s: float) -> dict:
    """What every rank runs: the cell's files as given (with any
    overrides), ``world`` ranks on ``device`` ("cuda": each rank its own
    card; "cpu"), and ``runs``, each a dict of ``seed``, ``seconds``,
    ``trace`` and optionally ``variant``, ``fault`` (planted on
    ``fault_ranks``, by default every rank) and ``keep_facts``."""
    return {"workload": workload, "spec": spec, "cell": cell, "config": config,
            "world": world, "device": device, "runs": runs, "timeout_s": timeout_s}


class Group:
    """This rank's place in a run over several cards, and the harness's own
    exchanges between the ranks, over a gloo group beside the program's."""

    def __init__(self):
        import torch.distributed as dist

        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.host = dist.new_group(backend="gloo")
        self.pending = collections.deque()

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.host)

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` of :data:`LAG` calls ago (True for the first
        calls), on every rank: the broadcast runs in the background, so no
        rank's host waits for it. Once False, nothing is left pending."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(flag)])
        self.pending.append((t, dist.broadcast(t, src=0, group=self.host, async_op=True)))
        if len(self.pending) <= LAG:
            return True
        t, work = self.pending.popleft()
        work.wait()
        if t.item():
            return True
        while self.pending:
            self.pending.popleft()[1].wait()
        return False

    def gather(self, obj):
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        import torch.distributed as dist

        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.host)
        return out


def watch(failed, deadline: list, stop: threading.Event, on_fail=lambda: None) -> None:
    """A daemon thread that ends this process with no result once
    ``failed()`` names a cause or the monotonic ``deadline[0]`` passes: a
    collective that waits for a rank that is gone never returns."""

    def loop():
        while not stop.wait(POLL_S):
            cause = failed() or (time.monotonic() > deadline[0] and "the time limit passed")
            if cause:
                print(f"no result: {cause}", file=sys.stderr, flush=True)
                on_fail()
                os._exit(4)

    threading.Thread(target=loop, daemon=True).start()


def run_job(job: dict, group: Group, t0: float = None, report=None) -> list:
    """This rank's part of every run of ``job``; rank 0 gets the results
    (each also handed to ``report`` as it comes), the others Nones."""
    from benchmark import faults, harness

    device = job["device"] if job["device"] == "cpu" else f"cuda:{os.environ['LOCAL_RANK']}"
    results = []
    for i, run in enumerate(job["runs"]):
        fault = run.get("fault")
        planted = fault and group.rank in run.get("fault_ranks", range(group.world))
        with faults.plant(fault) if planted else contextlib.nullcontext():
            result = harness.run_cell(
                job["workload"], run["seed"], run["seconds"], bool(run["trace"]), device,
                run.get("variant", "program"), t0=t0 if i == 0 else None, spec=job["spec"],
                cell=job["cell"], config=job["config"], keep_facts=run.get("keep_facts", False),
                group=group)
        harness.free_memory(device)
        results.append(result)
        if report is not None and result is not None:
            report(result)
    return results


def join() -> Group:
    """This rank in the group that its environment names, as ``--multihost``
    joins it."""
    from nbdt_torch.parallel import initialize_multihost

    initialize_multihost()
    return Group()


def leave(group: Group, deadline: list) -> None:
    """Every rank together: NCCL's teardown waits for its peers'."""
    import torch.distributed as dist

    group.barrier()
    deadline[0] = min(deadline[0], time.monotonic() + TEARDOWN_S)
    dist.destroy_process_group()


class Launch:
    """Rank 0's side of a job: making it starts the other ranks, which
    import and join while this process goes on; :meth:`run` joins them."""

    def __init__(self, job: dict):
        self.job = job
        self.deadline = [time.monotonic() + job["timeout_s"]]
        self.tmp = Path(tempfile.mkdtemp(prefix="nbdt-bench-ranks-"))
        path = self.tmp / "job.json"
        path.write_text(json.dumps(job))
        self.env = {**SOCKETS, **os.environ,
                    "NBDT_COORDINATOR": f"file://{self.tmp / 'store'}",
                    "NBDT_NUM_PROCESSES": str(job["world"])}
        self.children = [
            subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(path)],
                             env={**self.env, "NBDT_PROCESS_ID": str(r), "LOCAL_RANK": str(r)},
                             stdout=sys.stderr, cwd=cells.ROOT)
            for r in range(1, job["world"])]

    def failed(self):
        for r, child in enumerate(self.children, 1):
            code = child.poll()
            if code not in (None, 0):
                return f"rank {r} exited with {code}"
        return None

    def end(self) -> None:
        """Ends the other ranks that still run, and removes the job's files."""
        for child in self.children:
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def run(self, t0: float = None, report=None) -> list:
        """Runs the job as rank 0 and returns its results (``t0``: the host
        clock's reading at which the first run's set-up began). Ends this
        process with no result where a rank fails or the job outlasts
        ``job["timeout_s"]``."""
        os.environ.update({**self.env, "NBDT_PROCESS_ID": "0", "LOCAL_RANK": "0"})
        stop = threading.Event()
        watch(self.failed, self.deadline, stop, self.end)
        done = False
        try:
            group = join()
            results = run_job(self.job, group, t0, report)
            leave(group, self.deadline)
            for r, child in enumerate(self.children, 1):
                code = child.wait(timeout=max(1.0, self.deadline[0] - time.monotonic()))
                if code != 0:
                    raise RuntimeError(f"rank {r} exited with {code}")
            done = True
            return results
        finally:
            stop.set()
            if not done:
                self.end()
            shutil.rmtree(self.tmp, ignore_errors=True)


def launch(job: dict, t0: float = None, report=None) -> list:
    """Runs ``job`` on ``job["world"]`` ranks, this process being rank 0:
    :meth:`Launch.run`."""
    return Launch(job).run(t0, report)


def main(argv=None) -> int:
    """A rank other than 0: runs the job file's runs, then exits."""
    import torch

    from benchmark import harness

    job = cells.load_json(Path((argv or sys.argv[1:])[0]))
    parent = os.getppid()
    deadline = [time.monotonic() + job["timeout_s"]]
    stop = threading.Event()
    watch(lambda: os.getppid() != parent and "rank 0 is gone", deadline, stop)
    torch.set_num_threads(harness.HOST_THREADS)
    group = join()
    run_job(job, group)
    leave(group, deadline)
    stop.set()
    return 0


if __name__ == "__main__":
    sys.exit(main())
