"""Build the port's CUDA kernels and load them with ctypes.

Each ``nbdt_torch/csrc/<name>.cu`` becomes ``build/nbdt_torch/lib<name>-<hash>.so``
at the checkout root: compiled by ``nvcc`` for ``sm_90a`` with a plain C
interface (no PyTorch headers, so a build takes seconds), at first CUDA use
and never on import. One ``nvcc`` runs per source, all started together.
The file name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused. :func:`aligned` gives a wrapper
the contiguous, 16-byte aligned tensor its kernel's vector loads need.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from ..profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nbdt_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (ptxas register/smem report) per source


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of nbdt_torch are built at first use on a machine with the "
        "CUDA toolkit"
    )


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> bool:
    """Compile every source whose library is missing; raise with nvcc's
    output if any compile fails. True if nvcc ran."""
    todo = [src for src in sorted(CSRC.glob("*.cu")) if not _target(src).exists()]
    if not todo:
        return False
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for src in todo:
        out = _target(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((src.stem, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return True


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernels' vector
    loads), copied only if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed (in
    a ``kernel_load`` span, ``built=True`` where nvcc ran)."""
    if name not in _libraries:
        with span("kernel_load", always=True, kernel=name) as attrs:
            attrs["built"] = build_all()
            _libraries[name] = ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))
    return _libraries[name]
