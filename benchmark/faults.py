"""Faults planted in the program under test, to show that the correctness
check catches them. Each is a context manager that breaks ``nbdt_torch``
in this process while it is open; the benchmark's own runs never open one.

- ``answer_altered``: one answer changed where it is produced (a served
  class probability, a training loss).
- ``half_batch``: only the first half of each batch computed, the rest
  filled from it (serving) or left out of the loss's mean (training).
- ``state_unchanged``: the training step leaves the weights and the
  optimizer's state as they were.
- ``exchange_left_out``: DDP's gradient all-reduce skipped, each rank
  stepping on its own rows' gradient.
- ``norm_exchange_left_out``: the cross-rank BatchNorm's all-gather and
  all-reduce skipped, each rank normalising by its own rows' statistics
  (``nn.BatchNorm2d``'s forward and backward).

And two that end a rank over several cards, for the launch's own tests:
``rank_exits`` (the process exits with 1 at its first optimizer step) and
``rank_hangs`` (it stops there for an hour).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

FAULTS = ("answer_altered", "half_batch", "state_unchanged", "exchange_left_out",
          "norm_exchange_left_out")
RANK_FAULTS = ("rank_exits", "rank_hangs")


@contextlib.contextmanager
def patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def plant(fault: str):
    """Open one of :data:`FAULTS` in the program."""
    from nbdt_torch import model, trainer

    if fault == "answer_altered":
        forward, criterion = model.NBDT.forward, trainer.cross_entropy

        def altered_forward(self, x):
            out = forward(self, x).clone()
            out[0] = out[0].roll(1)  # the first image's probabilities, shifted by a class
            return out

        def altered_loss(logits, targets):
            return criterion(logits, targets) * 1.01

        with patched(model.NBDT, "forward", altered_forward), \
                patched(model.NBDT, "__call__", altered_forward), \
                patched(trainer, "cross_entropy", altered_loss):
            yield
    elif fault == "half_batch":
        forward, criterion = model.NBDT.forward, trainer.cross_entropy

        def half_forward(self, x):
            n = x.shape[0]
            out = forward(self, x[:max(1, n // 2)])
            return torch.cat([out] * (n // out.shape[0] + 1))[:n]

        def half_loss(logits, targets):
            n = max(1, logits.shape[0] // 2)
            return criterion(logits[:n], targets[:n])

        with patched(model.NBDT, "forward", half_forward), \
                patched(model.NBDT, "__call__", half_forward), \
                patched(trainer, "cross_entropy", half_loss):
            yield
    elif fault == "state_unchanged":
        with patched(torch.optim.SGD, "step", lambda self, closure=None: None):
            yield
    elif fault == "exchange_left_out":
        from torch.nn.parallel import DistributedDataParallel

        forward = DistributedDataParallel.forward

        def unsynced_forward(self, *args, **kwargs):
            self.require_backward_grad_sync = False  # what ``no_sync()`` sets
            return forward(self, *args, **kwargs)

        with patched(DistributedDataParallel, "forward", unsynced_forward):
            yield
    elif fault == "norm_exchange_left_out":
        from nbdt_torch.parallel.syncbn import CrossRankBatchNorm2d

        with patched(CrossRankBatchNorm2d, "forward", torch.nn.BatchNorm2d.forward):
            yield
    elif fault in RANK_FAULTS:
        def end(self, closure=None):
            if fault == "rank_exits":
                os._exit(1)
            time.sleep(3600)

        with patched(torch.optim.SGD, "step", end):
            yield
    else:
        raise ValueError(f"no fault {fault!r}; the faults are {FAULTS + RANK_FAULTS}")
