"""Tiny versions of the benchmark's cells for the CPU tests: the real cell
and configuration files with small batches, few images, one checked
training step and, for the ViT, a narrow two-layer model at 32px."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = {
    "resnet18_cifar10.offline": {"params": {"batch": 8, "pool": 2}},
    "vit_b16_imagenet1000.offline": {
        "params": {"batch": 4, "pool": 2},
        "model": {"image_size": 32, "hidden_size": 128, "num_layers": 2, "num_heads": 2,
                  "mlp_dim": 512, "feature_dim": 128},
        "program": {"model": "nbdt_torch.models.vit:ViT",
                    "kwargs": {"patch": 16, "dim": 128, "depth": 2, "heads": 2,
                               "num_classes": 1000, "ln_impl": "pallas", "image_size": 32}},
    },
    # one checked step: three free-running steps at batch 32 drift apart on the
    # CPU, where the program's channels-last convolutions round otherwise
    "resnet18_cifar10.train": {"params": {"batch": 32, "store_images": 96, "checked_steps": 1}},
}


def tiny_cell(workload: str):
    """(BENCHMARK.json, the cell, its configuration), cut to a CPU size."""
    spec, cell, config = harness.cell_files(workload)
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    over = TINY[workload]
    cell["params"].update(over["params"])
    config["model"].update(over.get("model", {}))
    if "program" in over:
        config["program"] = over["program"]
    config["init"]["calibration_images"] = 32
    return spec, cell, config


def run_tiny(workload: str, seed: int = 20261018, **kw) -> dict:
    spec, cell, config = tiny_cell(workload)
    return harness.run_cell(workload, seed, 0.2, False, device="cpu",
                            spec=spec, cell=cell, config=config, **kw)
