"""The port's native host kernels (nbdt_torch.native) against nbdt_tpu.native
and against their numpy twins.

The two packages build the same augment.cpp with the same g++ flags, so
their outputs are bitwise equal. Against numpy, the gather is bitwise equal
and the f32 outputs are within 1e-6 (tests/test_native.py's tolerance: the
kernel normalizes through a per-channel table, v * 1/(255 std) - mean/std).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nbdt_torch import native
from test_torch_port import torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
NUMPY_TOL = 1e-6
# (batch, height, width, channels, pad): CIFAR's shape, an odd one, one
# channel, and more channels than the kernel's table holds (8)
SHAPES = [(16, 32, 32, 3, 4), (5, 7, 9, 3, 2), (3, 6, 5, 1, 1), (2, 5, 6, 10, 3)]


@pytest.fixture
def built():
    if not native.available():
        pytest.skip(f"no native library: {native.build_error}")
    return native


def batch(shape, seed=3):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def constants(c, seed=4):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.3, 0.6, c).astype(np.float32),
            rng.uniform(0.15, 0.3, c).astype(np.float32))


@pytest.mark.parametrize("hflip", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_augment_equals_jax_and_numpy(built, shape, hflip):
    from nbdt_tpu import native as jnative

    from nbdt_torch.data.transforms import augment_uint8, normalize

    n, h, w, c, pad = shape
    x = batch((n, h, w, c))
    mean, std = constants(c)
    got = built.augment_batch(x, pad, mean, std, np.random.RandomState(7), hflip=hflip)
    want = jnative.augment_batch(x, pad, mean, std, np.random.RandomState(7), hflip=hflip)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(7)  # the same draws, in the same order
    ys, xs = rng.randint(0, 2 * pad + 1, size=n), rng.randint(0, 2 * pad + 1, size=n)
    flips = (rng.rand(n) < 0.5) if hflip else np.zeros(n, bool)
    np.testing.assert_allclose(got, normalize(augment_uint8(x, pad, ys, xs, flips), mean, std),
                               rtol=0, atol=NUMPY_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_normalize_and_gather_equal_jax_and_numpy(built, shape):
    from nbdt_tpu import native as jnative

    from nbdt_torch.data.transforms import normalize

    n, h, w, c, _ = shape
    x = batch((n, h, w, c))
    mean, std = constants(c)
    got = built.normalize_batch(x, mean, std)
    np.testing.assert_array_equal(got, jnative.normalize_batch(x, mean, std))
    np.testing.assert_allclose(got, normalize(x, mean, std), rtol=0, atol=NUMPY_TOL)
    idx = np.random.RandomState(5).randint(0, n, 2 * n)
    got = built.gather_batch_u8(x, idx)
    np.testing.assert_array_equal(got, jnative.gather_batch_u8(x, idx))
    np.testing.assert_array_equal(got, x[idx])


def test_calls_are_counted_and_bad_indices_refused(built):
    x = batch((4, 5, 5, 3))
    mean, std = constants(3)
    before = dict(built.calls)
    built.augment_batch(x, 1, mean, std, np.random.RandomState(0))
    built.normalize_batch(x, mean, std)
    built.gather_batch_u8(x, np.array([3, 0]))
    assert {k: built.calls[k] - before[k] for k in before} == {
        "augment_batch": 1, "normalize_batch": 1, "gather_batch_u8": 1}
    for bad in ([4], [-1]):
        with pytest.raises(IndexError):
            built.gather_batch_u8(x, np.array(bad))
    with pytest.raises(ValueError):
        built.normalize_batch(x, mean[:2], std[:2])


@pytest.mark.parametrize("device_normalize", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_and_transforms_take_native_like_jax(built, monkeypatch, shuffle,
                                                    device_normalize):
    """The port's DataLoader gathers and its train/val transforms augment
    through the library where the JAX package's do, with the same batches
    as the JAX package's (bitwise) and as the port's numpy path (within
    1e-6); the uint8 device-normalize transform stays on numpy."""
    import nbdt_tpu.data as jd

    import nbdt_torch.data as td

    jds = jd.SyntheticDataset(num_classes=10, size=40, seed=2)
    tds = td.SyntheticDataset(num_classes=10, size=40, seed=2)

    def batches(d, m, train):
        t = (d.transform_train(seed=6, device_normalize=device_normalize) if train
             else d.transform_val(device_normalize=device_normalize))
        return list(m.DataLoader(d, 16, shuffle=shuffle, transform=t, seed=1, drop_last=False))

    for train in (True, False):
        before = dict(built.calls)
        got = batches(tds, td, train)
        ran = {k: built.calls[k] - before[k] for k in before}
        augmented = 0 if device_normalize or not train else len(got)
        normalized = 0 if device_normalize or train else len(got)
        assert ran == {"augment_batch": augmented, "normalize_batch": normalized,
                       "gather_batch_u8": len(got)}
        for (tx, ty, tv), (jx, jy, jv) in zip(got, batches(jds, jd, train), strict=True):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_array_equal(tv, jv)
        with monkeypatch.context() as m:  # the port without its library
            m.setattr(built, "_load", lambda: None)
            plain = batches(tds, td, train)
        for (tx, ty, _), (px, py, _) in zip(got, plain, strict=True):
            assert px.dtype == tx.dtype
            np.testing.assert_allclose(px, tx, rtol=0, atol=NUMPY_TOL)
            np.testing.assert_array_equal(py, ty)


BUILD = """
import sys
from pathlib import Path
from nbdt_torch import native
native.BUILD_DIR = Path(sys.argv[1])
if len(sys.argv) > 2:
    native.SRC = Path(sys.argv[2])
print(native.available(), native.library_path())
print(native.build_error)
"""


def run_builds(n, build_dir, src=None):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    args = [sys.executable, "-c", BUILD, str(build_dir)] + ([str(src)] if src else [])
    procs = [subprocess.Popen(args, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(n)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(out.splitlines())
    return outs


def test_concurrent_builds_leave_one_library(built, tmp_path):
    """Two processes that build at once leave one whole library in their
    build directory, which loads, and nothing in the JAX package's
    directory (its own library aside, which its tests build)."""
    import ctypes

    from nbdt_tpu import native as jnative

    jdir = Path(jnative.__file__).parent
    before = set(os.listdir(jdir))
    outs = run_builds(2, tmp_path / "build")
    assert [o[0] for o in outs] == [f"True {tmp_path / 'build' / built.library_path().name}"] * 2
    (lib,) = os.listdir(tmp_path / "build")
    assert lib == built.library_path().name
    ctypes.CDLL(str(tmp_path / "build" / lib)).gather_batch_u8
    assert set(os.listdir(jdir)) - before <= {Path(jnative._LIB_PATH).name}
    assert built.library_path().parent == REPO / "build" / "nbdt_torch"


def test_build_error_is_readable(tmp_path):
    """A source g++ refuses: ``available()`` is False, ``build_error``
    carries the compiler's message, and no library or temporary is left."""
    src = tmp_path / "augment.cpp"
    src.write_text((REPO / "nbdt_torch" / "native" / "augment.cpp").read_text()
                   + "\nthis is not C++;\n")
    ((avail, error),) = ((o[0].split()[0], "\n".join(o[1:])) for o in
                         run_builds(1, tmp_path / "build", src))
    assert avail == "False"
    assert "g++ failed on augment.cpp" in error and "error" in error
    assert not (tmp_path / "build").exists() or not os.listdir(tmp_path / "build")
