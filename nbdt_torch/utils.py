"""Dataset registries, asset paths, device resolution and tensor coercion.

Counterpart of ``nbdt_tpu/utils.py``, kept to what the inference and
training paths need. The hierarchy JSONs and wnid lists are the JAX
package's vendored data files: they are read from ``nbdt_tpu/`` by
filesystem path, resolved from this file's own location, so nothing of that
package is imported.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch

DATASETS = (
    "CIFAR10",
    "CIFAR100",
    "TinyImagenet200",
    "Imagenet1000",
    "Cityscapes",
    "PascalContext",
    "LookIntoPerson",
    "ADE20K",
)

METHODS = ("wordnet", "random", "induced")

DATASET_TO_NUM_CLASSES = {
    "CIFAR10": 10,
    "CIFAR100": 100,
    "TinyImagenet200": 200,
    "Imagenet1000": 1000,
    "Cityscapes": 19,
    "PascalContext": 59,
    "LookIntoPerson": 20,
    "ADE20K": 150,
}

DATASET_TO_CLASSES = {
    "CIFAR10": [
        "airplane",
        "automobile",
        "bird",
        "cat",
        "deer",
        "dog",
        "frog",
        "horse",
        "ship",
        "truck",
    ],
}


def default_image_size(dataset: str) -> int:
    """Input resolution per classification dataset: 32px CIFAR crops, 64px
    TinyImagenet200, 224px Imagenet1000."""
    return {"TinyImagenet200": 64, "Imagenet1000": 224}.get(dataset, 32)


# The vendored data files live beside the JAX package: hierarchies/ and wnids/.
ASSETS_ROOT = Path(__file__).resolve().parent.parent / "nbdt_tpu"


def hierarchy_to_path_graph(dataset: str, hierarchy: str) -> str:
    return os.path.join(ASSETS_ROOT, f"hierarchies/{dataset}/graph-{hierarchy}.json")


def dataset_to_default_path_graph(dataset: str) -> str:
    return hierarchy_to_path_graph(dataset, "induced")


def dataset_to_default_path_wnids(dataset: str) -> str:
    return os.path.join(ASSETS_ROOT, f"wnids/{dataset}.txt")


def get_directory(dataset: str, root: str = str(ASSETS_ROOT / "hierarchies")) -> str:
    """``root/dataset``; by default the dataset's directory of vendored
    hierarchies."""
    return os.path.join(root, dataset)


def makeparentdirs(path) -> None:
    os.makedirs(Path(path).parent, exist_ok=True)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere in
    this package; asking for it where there is no card raises rather than
    running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def coerce_tensor(x, is_label: bool = False):
    """[N, H, W, C] -> [N*H*W, C] (labels [N, H, W] -> [N*H*W, 1])."""
    if is_label:
        return x.reshape(-1, 1)
    return x.reshape(-1, x.shape[-1])


def uncoerce_tensor(x, original_shape):
    """[N*H*W, C] -> [N, H, W, C]."""
    n, h, w, c = original_shape
    return x.reshape(n, h, w, c)


class Colors:
    RED = "\x1b[31m"
    GREEN = "\x1b[32m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    CYAN = "\x1b[36m"

    @classmethod
    def red(cls, *args):
        print(cls.RED + str(args[0]), *args[1:], cls.ENDC)

    @classmethod
    def green(cls, *args):
        print(cls.GREEN + str(args[0]), *args[1:], cls.ENDC)

    @classmethod
    def cyan(cls, *args):
        print(cls.CYAN + str(args[0]), *args[1:], cls.ENDC)

    @classmethod
    def bold(cls, *args):
        print(cls.BOLD + str(args[0]), *args[1:], cls.ENDC)


_bar_state = {"start": None, "last": None}


def progress_bar(current: int, total: int, msg: str = "", width: int = 40):
    """Render ``current/total`` as an in-place bar with step and total time."""
    now = time.time()
    if current == 0 or _bar_state["start"] is None:
        _bar_state["start"] = now
    step_time = now - (_bar_state["last"] or now)
    _bar_state["last"] = now
    total_time = now - _bar_state["start"]

    filled = int(width * (current + 1) / max(total, 1))
    bar = "=" * max(filled - 1, 0) + ">" + "." * (width - filled)
    line = (
        f" [{bar}]  Step: {step_time * 1e3:.0f}ms | Tot: {total_time:.1f}s"
        f"{' | ' + msg if msg else ''} {current + 1}/{total} "
    )
    end = "\n" if current + 1 >= total else "\r"
    sys.stdout.write(line + end)
    sys.stdout.flush()
    if current + 1 >= total:
        _bar_state["start"] = None
        _bar_state["last"] = None


def format_time(seconds: float) -> str:
    """A duration as at most its two most significant nonzero units of
    D/h/m/s/ms ("1D5m", "2m3s", "0ms"), the reference's format."""
    days, seconds = int(seconds / 3600 / 24), seconds % (3600 * 24)
    hours, seconds = int(seconds / 3600), seconds % 3600
    minutes, seconds = int(seconds / 60), seconds % 60
    whole = int(seconds)
    millis = int((seconds - whole) * 1000)
    parts = [f"{v}{unit}" for v, unit in ((days, "D"), (hours, "h"), (minutes, "m"),
                                          (whole, "s"), (millis, "ms")) if v > 0]
    return "".join(parts[:2]) or "0ms"


def get_mean_and_std(dataset):
    """Per-channel ``(mean, std)`` in [0, 1] units of a dataset of ``(HWC
    image, label)`` pairs: the average over samples of each sample's
    channel mean and unbiased std (the reference's estimator, not the
    pooled one); uint8 images are scaled by 1/255 first."""
    import numpy as np

    mean = np.zeros(3, dtype=np.float64)
    std = np.zeros(3, dtype=np.float64)
    for i in range(len(dataset)):
        x = np.asarray(dataset[i][0])
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        mean += x.mean(axis=(0, 1))
        std += x.std(axis=(0, 1), ddof=1)
    return mean / len(dataset), std / len(dataset)


def load_image_from_path(path):
    """A PIL image from a local path or an http(s) URL. PIL (the ``pillow``
    package) is imported here, not with the module: only the image CLIs
    need it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("load_image_from_path needs PIL (the pillow package) to decode "
                          "images; it is not installed") from e
    if isinstance(path, str) and path.startswith(("http://", "https://")):
        import io
        from urllib.request import Request, urlopen

        headers = {"User-Agent": "Mozilla/5.0 (compatible; nbdt-torch)"}
        with urlopen(Request(path, headers=headers)) as response:
            path = io.BytesIO(response.read())
    return Image.open(path)


def generate_checkpoint_fname(
    dataset,
    arch,
    path_graph,
    wnid=None,
    name="",
    trainset=None,
    include_labels=(),
    exclude_labels=(),
    include_classes=(),
    num_samples=0,
    tree_supervision_weight=1,
    fine_tune=False,
    loss="CrossEntropyLoss",
    lr=0.1,
    tree_supervision_weight_end=None,
    tree_supervision_weight_power=1,
    xent_weight=1,
    xent_weight_end=None,
    xent_weight_power=1,
    tree_start_epochs=None,
    tree_update_every_epochs=None,
    tree_update_end_epochs=None,
    **kwargs,
):
    """The reference's checkpoint file name (without extension), byte for
    byte, so that checkpoints of either package are found by the same
    flags."""
    if isinstance(loss, str):
        loss = (loss,)
    loss = tuple(loss)
    fname = "ckpt"
    fname += "-" + dataset
    fname += "-" + arch
    if lr != 0.1:
        fname += f"-lr{lr}"
    if name:
        fname += "-" + name
    if path_graph and any("TreeSupLoss" in l for l in loss):
        fname += "-" + Path(path_graph).stem.replace("graph-", "", 1)
    if include_labels:
        fname += "-incl" + ",".join(map(str, include_labels))
    if exclude_labels:
        fname += "-excl" + ",".join(map(str, exclude_labels))
    if include_classes:
        fname += "-incc" + ",".join(map(str, include_classes))
    if num_samples != 0 and num_samples is not None:
        fname += f"-samples{num_samples}"
    if len(loss) > 1 or loss[0] != "CrossEntropyLoss":
        fname += f'-{",".join(loss)}'
        if tree_supervision_weight not in (None, 1):
            fname += f"-tsw{tree_supervision_weight}"
        if tree_supervision_weight_end not in (tree_supervision_weight, None):
            fname += f"-tswe{tree_supervision_weight_end}"
        if tree_supervision_weight_power not in (None, 1):
            fname += f"-tswp{tree_supervision_weight_power}"
        if xent_weight not in (None, 1):
            fname += f"-xw{xent_weight}"
        if xent_weight_end not in (xent_weight, None):
            fname += f"-xwe{xent_weight_end}"
        if xent_weight_power not in (None, 1):
            fname += f"-xwp{xent_weight_power}"
    if any("SoftTreeLoss" in l for l in loss):
        if tree_start_epochs is not None:
            fname += f"-tse{tree_start_epochs}"
        if tree_update_every_epochs is not None:
            fname += f"-tueve{tree_update_every_epochs}"
        if tree_update_end_epochs is not None:
            fname += f"-tuene{tree_update_end_epochs}"
    return fname
