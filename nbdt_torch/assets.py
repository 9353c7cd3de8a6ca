"""Dataset wnid lists (counterpart of ``nbdt_tpu/assets.py``)."""

from __future__ import annotations

import os
from typing import List, Optional

from .utils import DATASET_TO_NUM_CLASSES, dataset_to_default_path_wnids


def dataset_to_dummy_wnids(dataset: str) -> List[str]:
    """FakeSynset wnids (f########) in class order."""
    num_classes = DATASET_TO_NUM_CLASSES[dataset]
    return ["f{:08d}".format(i) for i in range(num_classes)]


def get_dataset_wnids(dataset: str, path_wnids: Optional[str] = None) -> List[str]:
    """Resolve a dataset's wnid list: explicit file > vendored file >
    FakeSynset dummies. Every dataset with embedded constants in the JAX
    package also has a vendored file, so the two resolve alike."""
    from .hierarchy.wnid import get_wnids

    if path_wnids and os.path.exists(str(path_wnids)):
        return get_wnids(path_wnids)
    default = dataset_to_default_path_wnids(dataset)
    if os.path.exists(default):
        return get_wnids(default)
    return dataset_to_dummy_wnids(dataset)
