"""Where the fused soft head's time goes, phase by phase, on one CUDA card.

    python -m nbdt_torch.tools.soft_head_phases

Builds a copy of ``nbdt_torch/csrc/soft_head.cu`` in which thread 0 of every
block reads the card's global timer (``%globaltimer``, ns) and its SM clock
(``clock64``) at each phase boundary, runs the head through
``fused_soft_head`` at the ViT-B/16 head's shape (B=256, D=768, Imagenet1000)
and the ResNet18 head's (B=8192, D=512, CIFAR10), f32 and bf16 W, and prints
one JSON line per run: the median and largest time of each phase over the
blocks, the span from the first block's start to the last block's end, and
the SM clock the kernel saw. The stamps cost a few global stores per phase;
the kernel the package launches has none. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import soft_traversal as st
from ..tree import Tree

STAMPS = 10
# (instance, stamp index, text in the kernel source, insert "before" or "after")
ANCHORS = [
    ("cluster", 0, "  const T* ftile = feats + static_cast<size_t>(row0) * D;\n", "after"),
    ("cluster", 1, "  // 2. Classifier for this rank", "before"),
    ("cluster", 2, "    // Every warp leaves its partial sums", "before"),
    ("cluster", 3, "  cluster.sync();  // barrier 1", "before"),
    ("cluster", 4, "  cluster.sync();  // barrier 1: every rank's x is made; every feats tile is dead\n",
     "after"),
    ("cluster", 5, "  cp_async_wait<0>();\n  cluster.sync();  // barrier 2", "before"),
    ("cluster", 6, "  cluster.sync();  // barrier 2: every pull is done, so any block may leave after "
                   "this\n", "after"),
    ("cluster", 7, "    __syncthreads();\n    for (int n = threadIdx.x; n < N;", "before"),
    ("cluster", 8, "    for (int c = threadIdx.x; c < C; c += kThreads) {", "before"),
    ("cluster", 9, "    __syncthreads();  // the slot rows are free for the next group\n  }\n", "after"),
    ("stream", 0, "  load_rows<T, R, VL>(cur, feats, row0, B, D, nv, lane);  // in flight while the "
                  "block stages\n", "after"),
    ("stream", 1, "  float* xw = xw_s + warp * R * C;\n", "before"),
    ("stream", 2, "      for (int i = 0; i < VL; ++i) cur[r][i] = next[r][i];\n  }\n", "after"),
]
PHASES = {
    "cluster": ["stage feats", "classifier chunks", "classifier sums", "barrier 1 wait",
                "pull x + stage lists", "barrier 2 wait", "slot logits",
                "softmax (after the slowest warp's lists)", "leaf sums"],
    "stream": ["stage W and lists", "warp 0's row groups"],
}


def stamp(k: int) -> str:
    return ("  if (threadIdx.x == 0) { unsigned long long t_; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"g_stamp[blockIdx.x * {STAMPS} + {k}] = t_; "
            f"g_clock[blockIdx.x * {STAMPS} + {k}] = clock64(); }}\n")


def instrumented_source() -> str:
    """The kernel source with the stamps; raises if an anchor is missing."""
    src = (_build.CSRC / "soft_head.cu").read_text()
    src = src.replace("#include <cstdint>\n", f"#include <cstdint>\n#define STAMPS_N {STAMPS * 65536}\n", 1)
    src = src.replace("namespace {\n", "namespace {\n"
                      f"__device__ unsigned long long g_stamp[{STAMPS} * 65536];\n"
                      f"__device__ long long g_clock[{STAMPS} * 65536];\n", 1)
    for _, k, text, where in ANCHORS:
        if src.count(text) != 1:
            raise RuntimeError(f"anchor {k} found {src.count(text)} times: {text!r}")
        i = src.index(text) + (len(text) if where == "after" else 0)
        src = src[:i] + stamp(k) + src[i:]
    return src.replace('extern "C" {\n', 'extern "C" {\n'
                       "int nbdt_clear_stamps(int n) {\n"
                       "  static unsigned long long z[STAMPS_N];\n"
                       "  cudaError_t e = cudaMemcpyToSymbol(g_stamp, z, n * 8);\n"
                       "  return e ? e : cudaMemcpyToSymbol(g_clock, z, n * 8);\n}\n"
                       "int nbdt_read_stamps(void* t, void* c, int n) {\n"
                       "  cudaError_t e = cudaMemcpyFromSymbol(t, g_stamp, n * 8);\n"
                       "  return e ? e : cudaMemcpyFromSymbol(c, g_clock, n * 8);\n}\n", 1)


def build(source: str = None, tag: str = "") -> ctypes.CDLL:
    out = _build.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"soft_head_phases{tag}.cu", out / f"libsoft_head_phases{tag}.so"
    src.write_text(source or instrumented_source())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented copy:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def run(lib: ctypes.CDLL, ta, batch: int, dim: int, dtype: torch.dtype, seed: int) -> dict:
    """One stamped call (after three warm-up calls) and its phase times."""
    rng = np.random.RandomState(seed)
    W = (rng.randn(dim, ta.num_classes) / math.sqrt(dim)).astype(np.float32)
    hc = st.prepare_head_constants(ta, W, None, dtype=dtype)
    feats = torch.rand(batch, dim, device="cuda").to(dtype)
    for _ in range(3):
        st.fused_soft_head(feats, hc, want_aux=False)
    torch.cuda.synchronize()
    if lib.nbdt_clear_stamps(STAMPS * 65536):
        raise RuntimeError("clearing the stamps failed")
    st.fused_soft_head(feats, hc, want_aux=False)
    torch.cuda.synchronize()
    plan, grid = st.last_launch["plan"], st.last_launch["grid"]
    t = np.zeros(grid * STAMPS, np.int64)
    c = np.zeros(grid * STAMPS, np.int64)
    err = lib.nbdt_read_stamps(ctypes.c_void_p(t.ctypes.data), ctypes.c_void_p(c.ctypes.data),
                               grid * STAMPS)
    if err:
        raise RuntimeError(f"reading the stamps failed ({err})")
    names = PHASES[plan.instance]
    t = t.reshape(grid, STAMPS)[:, :len(names) + 1]
    c = c.reshape(grid, STAMPS)[:, :len(names) + 1]
    d = np.diff(t, axis=1) / 1e3
    # a block with no rows left for its rank skips the tree phases' stamps
    ok = (t[:, 1:] > 0) & (t[:, :-1] > 0)
    stats = {n: {"median": float(np.median(d[ok[:, i], i])), "max": float(d[ok[:, i], i].max()),
                 "blocks": int(ok[:, i].sum())} for i, n in enumerate(names)}
    live = (t > 0).all(axis=1)
    return {
        "instance": plan.instance, "q": plan.q, "rows": plan.rows, "grid": grid,
        "W": str(dtype)[6:], "batch": batch, "dim": dim, "classes": ta.num_classes,
        "span_us": float((t[:, -1].max() - t[:, 0].min()) / 1e3),
        "sm_clock_ghz": float(np.median((c[live, -1] - c[live, 0]) / (t[live, -1] - t[live, 0]))),
        "phases_us": stats,
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("soft_head_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build()
    # the instrumented library takes the place of the package's for these calls
    st._library.cache_clear()
    original = st.load_library
    st.load_library = lambda name: lib
    try:
        for name, batch, dim in (("Imagenet1000", 256, 768), ("CIFAR10", 8192, 512)):
            ta = Tree(name).arrays
            for dtype in (torch.float32, torch.bfloat16):
                print(json.dumps({"tree": name, **run(lib, ta, batch, dim, dtype, 8)}),
                      flush=True)
    finally:
        st.load_library = original
        st._library.cache_clear()
        st.max_clusters.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
