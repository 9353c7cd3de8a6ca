"""Input pipelines: datasets, batch transforms and the loader.

CIFAR10, CIFAR100, TinyImagenet200, Imagenet1000, the synthetic sets and
the label-subset wrappers; the segmentation datasets are still to be
ported."""

from .cifar import (
    CIFAR10,
    CIFAR100,
    CIFAR10_CLASSES,
    ArrayDataset,
    LearnableSyntheticDataset,
    SyntheticDataset,
)
from .custom import (
    ExcludeLabelsDataset,
    IncludeClassesDataset,
    IncludeLabelsDataset,
    ResampleLabelsDataset,
    wrap_dataset,
)
from .imagenet import Imagenet1000, TinyImagenet200
from .loader import DataLoader, PrefetchLoader
from .transforms import (
    CIFAR_MEAN,
    CIFAR_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    TINYIMAGENET_MEAN,
    TINYIMAGENET_STD,
    InverseNormalize,
    make_train_transform,
    make_val_transform,
    normalize,
)

DATASET_REGISTRY = {
    "CIFAR10": CIFAR10,
    "CIFAR100": CIFAR100,
    "TinyImagenet200": TinyImagenet200,
    "Imagenet1000": Imagenet1000,
    "SyntheticDataset": SyntheticDataset,
    "LearnableSyntheticDataset": LearnableSyntheticDataset,
}


def get_dataset(name: str):
    if name not in DATASET_REGISTRY:
        raise KeyError(f"Unknown dataset {name!r}: the port has {sorted(DATASET_REGISTRY)} "
                       "(the others are ROADMAP A10)")
    return DATASET_REGISTRY[name]
