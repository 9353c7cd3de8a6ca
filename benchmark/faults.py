"""Faults planted in the program under test, to show that the correctness
check catches them. Each is a context manager that breaks ``nbdt_torch``
in this process while it is open; the benchmark's own runs never open one.

- ``answer_altered``: one answer changed where it is produced (a served
  class probability, a training loss).
- ``half_batch``: only the first half of each batch computed, the rest
  filled from it (serving) or left out of the loss's mean (training).
- ``state_unchanged``: the training step leaves the weights and the
  optimizer's state as they were.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("answer_altered", "half_batch", "state_unchanged")


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
    else:
        raise ValueError(f"no fault {fault!r}; the faults are {FAULTS}")
