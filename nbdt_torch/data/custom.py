"""Label-subset dataset wrappers.

Counterpart of ``nbdt_tpu/data/custom.py``, numpy only. They drive the
unseen-class (zero-shot) runs: include, exclude or resample classes while
the labels stay in the original label space. Each wrapper exposes
``new_to_old`` (its sample index -> the base dataset's) and, over a
flat-array dataset, the base ``images``/``labels`` stores, so that the
``DataLoader`` and the trainer's cached store gather exactly the kept
samples.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _dataset_labels(dataset) -> np.ndarray:
    """All labels of ``dataset`` without materializing images: flat-array
    datasets answer from their label vector (composing any wrapper remap);
    streaming datasets fall back to per-sample label reads."""
    if hasattr(dataset, "labels") and dataset.labels is not None:
        labels = np.asarray(dataset.labels)
        inner_map = getattr(dataset, "new_to_old", None)
        return labels[np.asarray(inner_map)] if inner_map is not None else labels
    return np.array([dataset[i][1] for i in range(len(dataset))])


def _expose_flat_arrays(wrapper, dataset) -> None:
    """Let DataLoader keep its zero-copy fancy-index gather through wrapper
    chains: forward the base ``images``/``labels`` stores and compose this
    wrapper's new_to_old with any inner remap, so the map indexes the base
    store directly. ``wrapper.dataset`` is unwrapped to match (a flat inner
    wrapper's map is already base-space by induction), keeping __getitem__
    consistent with the composed map."""
    if hasattr(dataset, "images") and hasattr(dataset, "labels") \
            and dataset.images is not None:
        wrapper.images = dataset.images
        wrapper.labels = dataset.labels
        inner_map = getattr(dataset, "new_to_old", None)
        if inner_map is not None:
            wrapper.new_to_old = np.asarray(inner_map)[wrapper.new_to_old]
            wrapper.dataset = dataset.dataset


def _forward_to_wrapped(self, name):
    """Wrapper ``__getattr__``: surface the wrapped dataset's API the
    wrapper doesn't redefine — ``transform_train``/``transform_val``/
    ``transform_val_inverse``, ``mean``/``std`` — so wrapped runs keep the
    base dataset's transforms and normalization constants (the reference
    reaches them via generate_kwargs on the base class; without this,
    ``--include-labels`` runs silently trained on raw un-normalized
    pixels and ``--device-normalize`` refused datasets that have
    perfectly good constants)."""
    if name.startswith("_") or name == "dataset":
        raise AttributeError(name)
    return getattr(self.__dict__["dataset"], name)


class ResampleLabelsDataset:
    """Per-class inclusion probability with seeded index remap
    (reference custom.py:44-118).

    probability_labels: scalar p for all classes, or per-class list. A
    class with p<1 keeps each sample with probability p (seeded,
    deterministic).
    """

    def __init__(self, dataset, probability_labels=1.0, seed: int = 0):
        self.dataset = dataset
        self.classes = dataset.classes
        self.probability_labels = self._normalize(probability_labels, len(self.classes))
        rng = np.random.RandomState(seed)
        labels = _dataset_labels(dataset)
        keep = rng.rand(len(labels)) < np.asarray(self.probability_labels)[labels]
        self.new_to_old = np.flatnonzero(keep)
        _expose_flat_arrays(self, dataset)

    @staticmethod
    def _normalize(p, num_classes):
        if isinstance(p, str):
            p = [float(x) for x in p.split(",")]
        if isinstance(p, (int, float)):
            return [float(p)] * num_classes
        p = list(p)
        if len(p) == 1:
            return p * num_classes
        assert len(p) == num_classes
        return p

    def __len__(self):
        return len(self.new_to_old)

    def __getitem__(self, i):
        return self.dataset[int(self.new_to_old[i])]

    __getattr__ = _forward_to_wrapped


class IncludeLabelsDataset:
    """Keep only samples whose label is in ``include_labels``; labels are
    preserved in the original space (reference custom.py:121-161)."""

    def __init__(self, dataset, include_labels: Sequence[int]):
        self.dataset = dataset
        self.classes = dataset.classes
        include = set(int(x) for x in include_labels)
        labels = _dataset_labels(dataset)
        self.new_to_old = np.flatnonzero(np.isin(labels, list(include)))
        self.include_labels = sorted(include)
        _expose_flat_arrays(self, dataset)

    def __len__(self):
        return len(self.new_to_old)

    def __getitem__(self, i):
        return self.dataset[int(self.new_to_old[i])]

    __getattr__ = _forward_to_wrapped


class ExcludeLabelsDataset(IncludeLabelsDataset):
    """Complement of IncludeLabels (reference custom.py:164-207)."""

    def __init__(self, dataset, exclude_labels: Sequence[int]):
        exclude = set(int(x) for x in exclude_labels)
        include = [
            i for i in range(len(dataset.classes)) if i not in exclude
        ]
        super().__init__(dataset, include)


class IncludeClassesDataset(IncludeLabelsDataset):
    """Include by class name instead of index (reference custom.py:144-158)."""

    def __init__(self, dataset, include_classes: Sequence[str]):
        include_labels = [dataset.classes.index(c) for c in include_classes]
        super().__init__(dataset, include_labels)


def wrap_dataset(
    dataset,
    include_labels: Optional[Sequence[int]] = None,
    exclude_labels: Optional[Sequence[int]] = None,
    include_classes: Optional[Sequence[str]] = None,
    probability_labels=None,
):
    """Apply the reference's CLI wrapper semantics (custom.py:37-41 flags)."""
    if include_labels:
        dataset = IncludeLabelsDataset(dataset, include_labels)
    if exclude_labels:
        dataset = ExcludeLabelsDataset(dataset, exclude_labels)
    if include_classes:
        dataset = IncludeClassesDataset(dataset, include_classes)
    if probability_labels is not None and probability_labels != 1:
        dataset = ResampleLabelsDataset(dataset, probability_labels)
    return dataset
