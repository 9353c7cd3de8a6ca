"""The control of each cell's correctness check, on the card: the plain
reference put in the program's place and computed in TF32, the nearest
precision below the configurations' f32 with TF32 off, has to come out not
correct, and the program correct, at a size a test run holds (smaller
batches and windows than the cells'; ``calibrate.py`` reads the same at the
cells' own sizes). Skipped where there is no CUDA device."""

import pytest
import torch

import bench_testlib  # noqa: F401  (puts the checkout on sys.path)
from benchmark.calibrate import readings

SMALL = {
    "resnet18_cifar10.offline": {"batch": 1024, "pool": 2},
    "vit_b16_imagenet1000.offline": {"batch": 32, "pool": 2},
    "resnet18_cifar10.train": {"batch": 512, "store_images": 4096},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists on the card only")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_in_tf32_is_not_correct(card, workload):
    seconds = 0 if workload.endswith(".train") else 1
    program = readings(workload, 71, seconds, params=SMALL[workload])
    control = readings(workload, 71, seconds, variant="control", params=SMALL[workload])
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]
