"""Released checkpoints: the local cache, downloads and state-dict coercion.

Counterpart of ``nbdt_tpu/models/utils.py``. Released ``.pth`` checkpoints
are keyed by ``(arch, dataset[, hierarchy])`` in ``model_urls`` tables
(``nbdt_torch.model``, ``models.resnet``, ``models.wideresnet``); the last
key of a lookup that a table holds wins. A file is read from the cache
directory (``$NBDT_CHECKPOINT_DIR``, else the JAX package's
``~/.cache/nbdt_tpu/checkpoints``, so the two packages share it) and fetched
only when it is not there; offline, the fetch fails with a message naming
the path to place the file at. Loading tolerates ``net``/``state_dict``
wrapping and DataParallel's ``module.`` prefix.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch


def checkpoint_cache_dir() -> Path:
    root = os.environ.get(
        "NBDT_CHECKPOINT_DIR", os.path.expanduser("~/.cache/nbdt_tpu/checkpoints")
    )
    return Path(root)


def coerce_state_dict(state_dict, reference_state_dict=None) -> dict:
    """Unwrap ``net`` and then ``state_dict``, and drop a leading
    ``module.`` from every key. ``reference_state_dict`` is unused, kept
    for the reference's signature."""
    if "net" in state_dict and not hasattr(state_dict["net"], "shape"):
        state_dict = state_dict["net"]
    if "state_dict" in state_dict and not hasattr(state_dict["state_dict"], "shape"):
        state_dict = state_dict["state_dict"]
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def load_torch_checkpoint(path) -> dict:
    """A torch ``.pth`` file as a flat ``{key: tensor}`` dict, coerced,
    with entries that are not tensors (an epoch, an accuracy) left out."""
    data = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(data, dict):
        data = coerce_state_dict(data)
    return {k: v for k, v in data.items() if isinstance(v, torch.Tensor)}


def download_checkpoint(url: str, dest: Path) -> Path:
    from urllib.request import urlretrieve

    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(".tmp")
    urlretrieve(url, str(tmp))
    tmp.rename(dest)
    return dest


def cached_checkpoint(keys, model_urls: dict) -> Path:
    """The local file of the released checkpoint for the last of ``keys``
    that ``model_urls`` holds, fetched into the cache only if it is not
    there yet."""
    valid_keys = [key for key in keys if key in model_urls]
    if not valid_keys:
        raise KeyError(
            f"No pretrained checkpoint for any of {keys}. "
            f"Available: {sorted(model_urls)}"
        )
    url = model_urls[valid_keys[-1]]
    cached = checkpoint_cache_dir() / url.rsplit("/", 1)[-1]
    if not cached.exists():
        try:
            download_checkpoint(url, cached)
        except OSError as e:
            raise RuntimeError(
                f"Could not download pretrained checkpoint {url} "
                f"(offline?). Place the file at {cached} or pass "
                f"checkpoint_path=... explicitly. Original error: {e}"
            ) from e
    return cached


def load_state_dict_from_key(
    keys,
    model_urls: dict,
    pretrained: bool = True,
    checkpoint_path: Optional[str] = None,
) -> dict:
    """A released checkpoint's flat state dict by ``(arch, dataset[,
    hierarchy])`` keys, or ``checkpoint_path``'s when one is given."""
    return load_torch_checkpoint(checkpoint_path or cached_checkpoint(keys, model_urls))
