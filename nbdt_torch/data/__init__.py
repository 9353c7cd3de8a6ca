"""Input pipelines: datasets, batch transforms and the loaders.

CIFAR10, CIFAR100, TinyImagenet200, Imagenet1000, the synthetic sets, the
label-subset wrappers, and the segmentation datasets (Cityscapes,
PascalContext, LookIntoPerson, ADE20K, SyntheticSegDataset) with their
SegDataLoader."""

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
from .segmentation import (
    ADE20K,
    Cityscapes,
    LookIntoPerson,
    PascalContext,
    SegDataLoader,
    SyntheticSegDataset,
)
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
    "Cityscapes": Cityscapes,
    "PascalContext": PascalContext,
    "LookIntoPerson": LookIntoPerson,
    "ADE20K": ADE20K,
    "SyntheticDataset": SyntheticDataset,
    "LearnableSyntheticDataset": LearnableSyntheticDataset,
}


def get_dataset(name: str):
    if name not in DATASET_REGISTRY:
        raise KeyError(f"Unknown dataset {name!r}: {sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name]
