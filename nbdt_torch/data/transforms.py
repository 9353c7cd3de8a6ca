"""Batch-level numpy transforms and normalization constants.

Counterpart of ``nbdt_tpu/data/transforms.py``: augment whole uint8 NHWC
batches on the host (pad + random crop + flip), then normalize to f32, in
one pass of the native kernel (:mod:`nbdt_torch.native`) where it is built,
else in numpy; or ship uint8 and normalize on the device
(``device_normalize=True``). The random draws are the JAX package's, from
the same ``RandomState`` in the same order, on either path, so a batch
matches per seed (the native kernel's f32 within 1e-6 of numpy's).
"""

from __future__ import annotations

import numpy as np

from .. import native

# The reference's CIFAR values
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], dtype=np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], dtype=np.float32)
# TinyImagenet200
TINYIMAGENET_MEAN = np.array([0.4802, 0.4481, 0.3975], dtype=np.float32)
TINYIMAGENET_STD = np.array([0.2302, 0.2265, 0.2262], dtype=np.float32)
# torchvision's ImageNet values
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize(batch_u8: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> normalized float32 NHWC."""
    x = batch_u8.astype(np.float32) / 255.0
    return (x - mean) / std


def random_crop(batch: np.ndarray, pad: int, rng: np.random.RandomState) -> np.ndarray:
    """Pad and crop at a random offset per image (RandomCrop(size,
    padding=pad)), vectorized by offset groups."""
    n = batch.shape[0]
    ys = rng.randint(0, 2 * pad + 1, size=n)
    xs = rng.randint(0, 2 * pad + 1, size=n)
    return augment_uint8(batch, pad, ys, xs, np.zeros(n, np.uint8))


def random_hflip(batch: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    flips = rng.rand(batch.shape[0]) < 0.5
    out = batch.copy()
    out[flips] = out[flips, :, ::-1]
    return out


class InverseNormalize:
    """Un-normalize a batch (for analyzer image dumps)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return np.asarray(batch) * self.std + self.mean


def augment_uint8(batch_u8, pad, ys, xs, flips) -> np.ndarray:
    """Pad + crop at offsets (ys, xs) + flip where ``flips``, in uint8,
    grouped by offset so that it takes at most (2 pad + 1)^2 bulk slices."""
    n, h, w, c = batch_u8.shape
    padded = np.pad(batch_u8, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out = np.empty((n, h, w, c), dtype=np.uint8)
    for yo in np.unique(ys):
        sel = ys == yo
        rows = padded[sel, yo: yo + h]
        xoff = xs[sel]
        for xo in np.unique(xoff):
            sub = xoff == xo
            idx = np.flatnonzero(sel)[sub]
            out[idx] = rows[sub][:, :, xo: xo + w]
    fl = np.asarray(flips).astype(bool)
    out[fl] = out[fl, :, ::-1]
    return out


def apply_augment_numpy(batch_u8: np.ndarray, pad: int, ys: np.ndarray, xs: np.ndarray,
                        flips: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Pad + crop + flip + normalize with explicit offsets: the numpy twin of
    the native ``augment_batch`` (``native/augment.cpp``), bit for bit. The
    loaders never fall back on it; it is the kernel's oracle."""
    return normalize(augment_uint8(batch_u8, pad, ys, xs, flips), mean, std)


def make_train_transform(mean, std, crop_pad: int = 4, hflip: bool = True,
                         seed: int = 0, device_normalize: bool = False):
    """Train-time augmentation of uint8 batches: per batch, draws the crop
    offsets (rows, then columns) and the flips from one ``RandomState``,
    then crops, flips and normalizes, in the native kernel where it is
    built (or, with ``device_normalize``, leaves the normalization to the
    device and returns uint8)."""
    rng = np.random.RandomState(seed)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    use_native = not device_normalize and native.available()

    def transform(batch_u8: np.ndarray) -> np.ndarray:
        if not crop_pad and not hflip:
            return batch_u8 if device_normalize else normalize(batch_u8, mean, std)
        if use_native:
            return native.augment_batch(batch_u8, crop_pad, mean, std, rng, hflip=hflip)
        n = batch_u8.shape[0]
        ys = rng.randint(0, 2 * crop_pad + 1, size=n).astype(np.int32)
        xs = rng.randint(0, 2 * crop_pad + 1, size=n).astype(np.int32)
        flips = ((rng.rand(n) < 0.5).astype(np.uint8) if hflip
                 else np.zeros(n, dtype=np.uint8))
        out = augment_uint8(batch_u8, crop_pad, ys, xs, flips)
        return out if device_normalize else normalize(out, mean, std)

    return transform


def make_val_transform(mean, std, device_normalize: bool = False):
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)

    def transform(batch_u8: np.ndarray) -> np.ndarray:
        if device_normalize:
            return batch_u8
        out = native.normalize_batch(batch_u8, mean, std)
        return out if out is not None else normalize(batch_u8, mean, std)

    return transform
