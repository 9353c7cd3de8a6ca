"""TinyImagenet200 and Imagenet1000 from image folders on disk.

Counterpart of ``nbdt_tpu/data/imagenet.py``: TinyImagenet200 (64x64, 200
classes) is read into memory as uint8 NHWC; Imagenet1000 is a lazy folder
decoded a sample at a time and resized to 224. The port downloads nothing:
``download=True`` is refused and a missing directory raises
``FileNotFoundError``. PIL is imported only where an image file is read.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .cifar import ArrayDataset
from .transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    TINYIMAGENET_MEAN,
    TINYIMAGENET_STD,
    InverseNormalize,
    make_train_transform,
    make_val_transform,
)


def _read_rgb(path, size=None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size)
    return np.asarray(img, dtype=np.uint8)


class TinyImagenet200(ArrayDataset):
    """64x64, 200 classes, under ``root/tiny-imagenet-200``: the train split
    is an image folder (``train/<wnid>/images/``), the val split takes its
    labels from ``val/val_annotations.txt``. Classes are the sorted wnids.
    The transforms are ``ArrayDataset``'s (``crop_pad=4``) with this class's
    mean and std."""

    mean = TINYIMAGENET_MEAN
    std = TINYIMAGENET_STD

    def __init__(self, root: str = "./data", train: bool = True, download: bool = False):
        base = Path(root) / "tiny-imagenet-200"
        if download:
            raise ValueError("nbdt_torch downloads no datasets; place TinyImagenet200 "
                             f"at {base}")
        if not base.exists():
            raise FileNotFoundError(f"TinyImagenet200 not found at {base}; mount it there "
                                    "or point --data-root at it.")
        classes = sorted(w.strip() for w in open(base / "wnids.txt"))
        wnid_to_index = {w: i for i, w in enumerate(classes)}
        images, labels = [], []
        if train:
            for wnid in classes:
                img_dir = base / "train" / wnid / "images"
                for f in sorted(os.listdir(img_dir)):
                    images.append(_read_rgb(img_dir / f))
                    labels.append(wnid_to_index[wnid])
        else:
            with open(base / "val" / "val_annotations.txt") as fh:
                ann = dict(line.split("\t")[:2] for line in fh)
            img_dir = base / "val" / "images"
            for f in sorted(os.listdir(img_dir)):
                images.append(_read_rgb(img_dir / f))
                labels.append(wnid_to_index[ann[f]])
        super().__init__(np.stack(images).astype(np.uint8), np.array(labels), classes)


class Imagenet1000:
    """Image folder at ``root/imagenet-1000/{train,val}``, decoded lazily
    (one sample at a time through the loader) and resized to 224x224; its
    transforms take no crop padding."""

    mean = IMAGENET_MEAN
    std = IMAGENET_STD

    def __init__(self, root: str = "./data", train: bool = True, download: bool = False):
        base = Path(root) / "imagenet-1000" / ("train" if train else "val")
        if download:
            raise ValueError("nbdt_torch downloads no datasets; place Imagenet1000 "
                             f"at {base}")
        if not base.exists():
            raise FileNotFoundError(f"Imagenet1000 not found at {base}")
        self.base = base
        self.classes = sorted(d.name for d in base.iterdir() if d.is_dir())
        self.class_to_index = {c: i for i, c in enumerate(self.classes)}
        self.samples = [(p, self.class_to_index[d.name])
                        for d in sorted(base.iterdir()) if d.is_dir()
                        for p in sorted(d.iterdir())]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, label = self.samples[i]
        return _read_rgb(path, (224, 224)), label

    @classmethod
    def transform_train(cls, seed: int = 0, device_normalize: bool = False):
        return make_train_transform(cls.mean, cls.std, crop_pad=0, seed=seed,
                                    device_normalize=device_normalize)

    @classmethod
    def transform_val(cls, device_normalize: bool = False):
        return make_val_transform(cls.mean, cls.std, device_normalize=device_normalize)

    @classmethod
    def transform_val_inverse(cls):
        return InverseNormalize(cls.mean, cls.std)
