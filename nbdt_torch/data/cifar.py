"""CIFAR10/100 and the synthetic datasets, as uint8 NHWC arrays.

Counterpart of ``nbdt_tpu/data/cifar.py``. CIFAR reads the python-pickle
batches from disk and raises when they are missing; nothing is downloaded.
The synthetic datasets make the same ``RandomState`` draws in the same
order as the JAX package's, so their bytes are identical per seed.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import List, Optional

import numpy as np

from .transforms import (
    CIFAR_MEAN,
    CIFAR_STD,
    InverseNormalize,
    make_train_transform,
    make_val_transform,
)

CIFAR10_CLASSES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]


class ArrayDataset:
    """In-memory uint8 image dataset: images [N, H, W, 3], labels [N]."""

    mean = CIFAR_MEAN
    std = CIFAR_STD

    def __init__(self, images: np.ndarray, labels: np.ndarray, classes: List[str]):
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"images must be uint8 [N, H, W, 3], got {images.dtype} "
                             f"{images.shape}")
        self.images = images
        self.labels = np.asarray(labels, dtype=np.int64)
        self.classes = list(classes)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])

    @classmethod
    def transform_train(cls, seed: int = 0, device_normalize: bool = False):
        return make_train_transform(cls.mean, cls.std, crop_pad=4, seed=seed,
                                    device_normalize=device_normalize)

    @classmethod
    def transform_val(cls, device_normalize: bool = False):
        return make_val_transform(cls.mean, cls.std, device_normalize=device_normalize)

    @classmethod
    def transform_val_inverse(cls):
        return InverseNormalize(cls.mean, cls.std)


def _unpickle(path: Path) -> dict:
    with open(path, "rb") as fh:
        return pickle.load(fh, encoding="latin1")


class CIFAR10(ArrayDataset):
    """CIFAR10 from the python-pickle batches under ``root``."""

    dir_name = "cifar-10-batches-py"

    def __init__(self, root: str = "./data", train: bool = True, download: bool = False):
        base = Path(root) / self.dir_name
        if download:
            raise ValueError("nbdt_torch downloads no datasets; place the CIFAR10 batches "
                             f"at {base}")
        if not base.exists():
            raise FileNotFoundError(
                f"CIFAR10 not found at {base}. Put the python-pickle batches there or "
                "point --data-root at them.")
        files = ([base / f"data_batch_{i}" for i in range(1, 6)] if train
                 else [base / "test_batch"])
        images, labels = [], []
        for f in files:
            entry = _unpickle(f)
            images.append(entry["data"])
            labels.extend(entry.get("labels", entry.get("fine_labels", [])))
        data = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        super().__init__(data.astype(np.uint8), np.array(labels), CIFAR10_CLASSES)


class CIFAR100(ArrayDataset):
    """CIFAR100 from the python-pickle files under ``root``."""

    dir_name = "cifar-100-python"

    def __init__(self, root: str = "./data", train: bool = True, download: bool = False):
        base = Path(root) / self.dir_name
        if download:
            raise ValueError("nbdt_torch downloads no datasets; place the CIFAR100 files "
                             f"at {base}")
        if not base.exists():
            raise FileNotFoundError(f"CIFAR100 not found at {base}.")
        entry = _unpickle(base / ("train" if train else "test"))
        data = np.asarray(entry["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        meta = _unpickle(base / "meta")
        super().__init__(data.astype(np.uint8), np.array(entry["fine_labels"]),
                         meta["fine_label_names"])


class LearnableSyntheticDataset(ArrayDataset):
    """Separable synthetic classes: a fixed random template per class blended
    with per-sample noise. ``train=False`` draws fresh samples from the same
    templates, so a model that learns the classes scores high on held-out
    data. ``groups`` (one group index per class) blends each class template
    with a shared per-group one, ``group_blend`` the class-unique weight."""

    def __init__(
        self,
        num_classes: int = 10,
        size: int = 512,
        image_size: int = 32,
        seed: int = 0,
        noise: float = 0.35,
        train: bool = True,
        classes: Optional[List[str]] = None,
        groups: Optional[List[int]] = None,
        group_blend: float = 0.5,
    ):
        trng = np.random.RandomState(seed)  # templates: shared by train and test
        templates = trng.randint(0, 256, (num_classes, image_size, image_size, 3)).astype(
            np.float32)
        if groups is not None:
            groups = np.asarray(groups)
            if len(groups) != num_classes:
                raise ValueError(f"groups must give one group per class: "
                                 f"{len(groups)} != {num_classes}")
            group_templates = trng.randint(
                0, 256, (int(groups.max()) + 1, image_size, image_size, 3)).astype(np.float32)
            templates = ((1.0 - group_blend) * group_templates[groups]
                         + group_blend * templates)
        srng = np.random.RandomState(seed + (1 if train else 2))
        labels = srng.randint(0, num_classes, size)
        noise_imgs = srng.randint(0, 256, (size, image_size, image_size, 3)).astype(np.float32)
        images = ((1.0 - noise) * templates[labels] + noise * noise_imgs).astype(np.uint8)
        super().__init__(images, labels, classes or [f"class{i}" for i in range(num_classes)])


class SyntheticDataset(ArrayDataset):
    """Random uint8 images with seeded labels: a shape-compatible stand-in
    where no data is on disk."""

    def __init__(
        self,
        num_classes: int = 10,
        size: int = 512,
        image_size: int = 32,
        seed: int = 0,
        classes: Optional[List[str]] = None,
    ):
        rng = np.random.RandomState(seed)
        images = rng.randint(0, 256, size=(size, image_size, image_size, 3), dtype=np.uint8)
        labels = rng.randint(0, num_classes, size=size)
        super().__init__(images, labels, classes or [f"class{i}" for i in range(num_classes)])
