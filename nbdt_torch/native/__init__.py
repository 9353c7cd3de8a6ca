"""Native (C++, OpenMP) kernels of the host input pipeline, loaded with ctypes.

Counterpart of ``nbdt_tpu/native``: ``augment_batch`` (pad + random crop +
random flip + normalize of a uint8 NHWC batch in one pass),
``normalize_batch`` and ``gather_batch_u8`` (the loader's shuffled gather).
They run on the host, not on the card. ``augment.cpp`` is built with
``g++`` at first use, never on import, into
``build/nbdt_torch/libaugment-<hash>.so`` at the checkout root; the hash
covers the source, the flags and the host CPU (``-march=native`` builds for
it), so an edited source, or a checkout copied to another machine, is
rebuilt. The build writes a temporary file and renames it into place, so
processes that build at once leave one whole library.

Each function returns ``None`` when no library could be built
(:data:`build_error` then says why), and the callers take their numpy
twins; :data:`calls` counts the calls that ran native code. The random
draws are the callers' own and are made in the JAX package's order, so a
batch is the same whichever path made it (within 1e-6 in f32: the kernel
normalizes through a per-channel table).

    from nbdt_torch import native
    if native.available(): out = native.augment_batch(u8, 4, mean, std, rng)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nbdt_torch"
# The JAX package's flags, so that the two libraries compute the same bits
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

calls: Dict[str, int] = {"augment_batch": 0, "normalize_batch": 0, "gather_batch_u8": 0}
build_error: Optional[str] = None  # why the library is missing, once a build failed

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> str:
    """The host CPU's model and instruction-set flags."""
    try:
        with open("/proc/cpuinfo") as f:
            return "\n".join(line for line in f.read().splitlines()[:40]
                             if line.startswith(("model name", "flags")))
    except OSError:
        return f"{platform.machine()} {platform.processor()}"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libaugment-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except subprocess.CalledProcessError as e:
            build_error = f"g++ failed on {SRC.name} (exit {e.returncode}):\n{e.stderr}"
            return None
        except (OSError, subprocess.TimeoutExpired) as e:
            build_error = f"{type(e).__name__}: {e}"
            return None
        i64, i32p, u8p, f32p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float))
        lib.augment_batch.argtypes = [u8p, i64, i64, i64, i64, i64, i32p, i32p, u8p, f32p,
                                      f32p, f32p]
        lib.normalize_batch.argtypes = [u8p, i64, i64, i64, f32p, f32p, f32p]
        lib.gather_batch_u8.argtypes = [u8p, ctypes.POINTER(ctypes.c_int64), i64, i64, u8p]
        for fn in (lib.augment_batch, lib.normalize_batch, lib.gather_batch_u8):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _constants(mean, std, c: int):
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    std = np.ascontiguousarray(std, dtype=np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"mean {mean.shape} and std {std.shape} must have the {c} channels")
    return mean, std


def augment_batch(images_u8: np.ndarray, pad: int, mean, std, rng: np.random.RandomState,
                  hflip: bool = True) -> Optional[np.ndarray]:
    """Pad + random crop + random flip + normalize, uint8 NHWC in, f32 NHWC
    out. Draws from ``rng`` the row offsets, the column offsets, then the
    flips (``rand(n) < 0.5``), as the JAX package does. ``None`` without
    the library (nothing is drawn then)."""
    lib = _load()
    if lib is None:
        return None
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    if images_u8.ndim != 4 or pad < 0:
        raise ValueError(f"augment_batch takes NHWC uint8 and pad >= 0, not "
                         f"{images_u8.shape} and {pad}")
    n, h, w, c = images_u8.shape
    ys = rng.randint(0, 2 * pad + 1, size=n).astype(np.int32)
    xs = rng.randint(0, 2 * pad + 1, size=n).astype(np.int32)
    flips = (rng.rand(n) < 0.5).astype(np.uint8) if hflip else np.zeros(n, dtype=np.uint8)
    mean, std = _constants(mean, std, c)
    out = np.empty((n, h, w, c), dtype=np.float32)
    lib.augment_batch(_ptr(images_u8, ctypes.c_uint8), n, h, w, c, pad,
                      _ptr(ys, ctypes.c_int32), _ptr(xs, ctypes.c_int32),
                      _ptr(flips, ctypes.c_uint8), _ptr(mean, ctypes.c_float),
                      _ptr(std, ctypes.c_float), _ptr(out, ctypes.c_float))
    calls["augment_batch"] += 1
    return out


def normalize_batch(images_u8: np.ndarray, mean, std) -> Optional[np.ndarray]:
    """(u8 / 255 - mean) / std over the last axis, f32; ``None`` without
    the library."""
    lib = _load()
    if lib is None:
        return None
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    c = images_u8.shape[-1]
    mean, std = _constants(mean, std, c)
    out = np.empty(images_u8.shape, dtype=np.float32)
    lib.normalize_batch(_ptr(images_u8, ctypes.c_uint8), images_u8.shape[0],
                        int(np.prod(images_u8.shape[1:-1])), c, _ptr(mean, ctypes.c_float),
                        _ptr(std, ctypes.c_float), _ptr(out, ctypes.c_float))
    calls["normalize_batch"] += 1
    return out


def gather_batch_u8(data: np.ndarray, indices: np.ndarray) -> Optional[np.ndarray]:
    """``data[indices]`` for a uint8 array and indices in ``[0, len(data))``;
    ``None`` without the library."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if indices.ndim != 1 or (len(indices) and not 0 <= indices.min() <= indices.max()
                             < len(data)):
        raise IndexError(f"gather_batch_u8 takes 1-d indices in [0, {len(data)})")
    out = np.empty((len(indices),) + data.shape[1:], dtype=np.uint8)
    lib.gather_batch_u8(_ptr(data, ctypes.c_uint8),
                        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(indices),
                        int(np.prod(data.shape[1:])), _ptr(out, ctypes.c_uint8))
    calls["gather_batch_u8"] += 1
    return out
