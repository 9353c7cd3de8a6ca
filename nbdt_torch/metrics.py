"""Top-k accuracy metrics (counterpart of ``nbdt_tpu/metrics.py``)."""

from __future__ import annotations

import numpy as np


class TopK:
    """Accumulating top-k accuracy over numpy (or host) batches."""

    def __init__(self, k: int = 1):
        self.k = k
        self.correct = 0
        self.total = 0

    def forward(self, outputs, targets) -> int:
        """Accumulate one batch; returns the batch hit count."""
        outputs = np.asarray(outputs)
        targets = np.atleast_1d(np.asarray(targets))
        if outputs.ndim == 1:
            outputs = outputs[None]
        k = min(self.k, outputs.shape[1])
        topk = np.argpartition(-outputs, kth=k - 1, axis=1)[:, :k]
        hits = (topk == targets[:, None]).any(axis=1)
        self.correct += int(hits.sum())
        self.total += len(targets)
        return int(hits.sum())

    __call__ = forward

    def report(self) -> float:
        return self.correct / self.total if self.total else 0.0

    def clear(self) -> None:
        self.correct = 0
        self.total = 0


def top1() -> TopK:
    return TopK(1)


def top2() -> TopK:
    return TopK(2)


def top5() -> TopK:
    return TopK(5)


def top10() -> TopK:
    return TopK(10)


names = ("top1", "top2", "top5", "top10")
