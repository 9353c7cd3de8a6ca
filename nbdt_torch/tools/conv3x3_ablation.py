"""The 3x3 conv kernel's design choices, measured against their alternatives
on one CUDA card.

    python -m nbdt_torch.tools.conv3x3_ablation [--batch 8192] [--iters 20]

Builds variants of ``nbdt_torch/csrc/conv3x3.cu``, each the committed source
with a few named text edits (``VARIANTS``; an edit that no longer finds its
text raises), and calls each through the same C entry point with the same
host plan as :func:`nbdt_torch.ops.conv3x3.conv3x3_bias_relu`:

- ``kernel``: the source as committed;
- ``base_offset``: the wgmma descriptors carry ``(addr >> 7) & 7`` in their
  base-offset field instead of 0 (the other reading of how the 128-byte
  swizzle treats a B operand that starts inside a 1 KB atom);
- ``unordered``: the two consumer warpgroups issue their products whenever
  their window has landed, not in turns;
- ``pitch40``: a 40-pixel window (the halo columns rounded up to 8), wgmma
  N = 160, 1.25x the MACs where the kernel takes 1.0625x;
- ``pitch40_unordered``: both of the above;
- ``regs2`` and ``regs36``: the first 2 taps' (or all 9 taps') weight
  fragments held in registers as wgmma's A operand, the rest read from
  shared memory.

Each variant is held to the plain version on three shapes (a wrong variant
is reported, not raised) and the right ones are timed at ``--batch`` x 32 x
32 in turns (each once forward, then once backward), by CUDA events behind a
GPU sleep. One JSON line per build, check and timing, then a summary line.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import conv3x3 as conv
from .probe_pallas_conv import time_cuda


def _wgmma_source(n: int) -> str:
    """``wgmma_m64n{n}k16`` with A and B from shared-memory descriptors, as
    the kernel's own ``wgmma_m64n136k16``."""
    acc = n // 2
    regs = ", ".join(f"%{i}" for i in range(acc))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(acc))
    return (f"__device__ __forceinline__ void wgmma_m64n{n}k16(float (&d)[{acc}], uint64_t a, "
            f"uint64_t b, int scale_d) {{\n  asm volatile(\n"
            f'      "{{\\n .reg .pred p;\\n setp.ne.b32 p, %{acc + 2}, 0;\\n"\n'
            f'      " wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
            f'      "{{{regs}}}, %{acc}, %{acc + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f'      : {outs}\n      : "l"(a), "l"(b), "r"(scale_d));\n}}\n\n')


def _register_a_edits(taps: int) -> list:
    """Edits that hold the first ``taps`` taps' A fragments in registers
    (ldmatrix from the swizzled weight once per block)."""
    regs = ", ".join(f"%{i}" for i in range(68))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(68))
    helpers = (
        "__device__ __forceinline__ void wgmma_rega(float (&d)[68], const uint32_t (&a)[4], "
        "uint64_t b, int scale_d) {\n  asm volatile(\n"
        '      "{\\n .reg .pred p;\\n setp.ne.b32 p, %73, 0;\\n"\n'
        '      " wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "\n'
        f'      "{{{regs}}}, {{%68, %69, %70, %71}}, %72, p, 1, 1, 0;\\n}}\\n"\n'
        f'      : {outs}\n'
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));\n}\n\n'
        "__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {\n"
        '  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"\n'
        '               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));\n}\n\n')
    load = (
        "    mbar_wait(w_bar, 0);\n"
        f"    uint32_t afr[{taps} * 4][4];\n"
        "    {\n"
        "      const int mi = lane / 8, r = 16 * warp + (mi % 2) * 8 + lane % 8;\n"
        "#pragma unroll\n"
        f"      for (int q = 0; q < {taps} * 4; ++q) {{\n"
        "        const int chunk = (q % 4 * 2 + mi / 2) ^ (r & 7);\n"
        "        ldmatrix_x4(w_s + q / 4 * kWTapBytes + r * kPixBytes + chunk * 16, afr[q]);\n"
        "      }\n    }\n")
    call = (
        "          const uint64_t b = desc_sw128(win + (dy * kPitch + dx) * kPixBytes + ks * 32);\n"
        f"          if (tap < {taps}) {{\n"
        "            wgmma_rega(acc, afr[tap * 4 + ks], b, (tap | ks) != 0);\n"
        "          } else {\n"
        "            const uint64_t a = desc_sw128(w_s + tap * kWTapBytes + ks * 32);\n"
        "            wgmma_m64n136k16(acc, a, b, (tap | ks) != 0);\n"
        "          }\n")
    return [
        ("__device__ __forceinline__ void stmatrix_x2_trans",
         helpers + "__device__ __forceinline__ void stmatrix_x2_trans"),
        ("    mbar_wait(w_bar, 0);\n", load),
        ("          const uint64_t a = desc_sw128(w_s + tap * kWTapBytes + ks * 32);\n"
         "          const uint64_t b = desc_sw128(win + (dy * kPitch + dx) * kPixBytes + ks * 32);\n"
         "          wgmma_m64n136k16(acc, a, b, (tap | ks) != 0);\n", call),
    ]


_BASE_OFFSET = [(
    "  d |= static_cast<uint64_t>(1) << 62;",
    "  d |= static_cast<uint64_t>((addr >> 7) & 7) << 49;\n  d |= static_cast<uint64_t>(1) << 62;")]
_UNORDERED = [
    ("      if (j >= 1) named_barrier(3 + g, 256);\n", ""),
    ("      if (j + 1 < block_tiles)  // hand the turn to the other warpgroup's next tile\n"
     '        asm volatile("bar.arrive %0, 256;" :: "r"(4 - g) : "memory");\n', ""),
]
_PITCH40 = [
    ("constexpr int kPitch = 34;", "constexpr int kPitch = 40;"),
    ("__device__ __forceinline__ void stmatrix_x2_trans",
     _wgmma_source(160) + "__device__ __forceinline__ void stmatrix_x2_trans"),
    ("          wgmma_m64n136k16(acc, a, b, (tap | ks) != 0);",
     "          wgmma_m64n160k16(acc, a, b, (tap | ks) != 0);"),
]
VARIANTS = {
    "kernel": [],
    "base_offset": _BASE_OFFSET,
    "unordered": _UNORDERED,
    "pitch40": _PITCH40,
    "pitch40_unordered": _PITCH40 + _UNORDERED,
    "regs2": _register_a_edits(2),
    "regs36": _register_a_edits(9),
}
CHECK_SHAPES = ((64, 32, 32), (5, 7, 5), (2, 33, 70))


def variant_source(name: str) -> str:
    src = (_build.CSRC / "conv3x3.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: edit found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def build_all() -> dict:
    """Compile every variant (one nvcc each, all started together); returns
    {name: (library, ptxas registers and spills line)}."""
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = variant_source(name)
        tag = hashlib.sha256(src.encode()).hexdigest()[:12]
        cu, so = out / f"conv3x3_{name}.cu", out / f"libconv3x3_{name}-{tag}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.nbdt_conv3x3_smem_bytes.restype = ctypes.c_int
        lib.nbdt_conv3x3_smem_bytes.argtypes = [ctypes.c_int]
        lib.nbdt_conv3x3.restype = ctypes.c_int
        lib.nbdt_conv3x3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.nbdt_conv3x3_error_string.restype = ctypes.c_char_p
        lib.nbdt_conv3x3_error_string.argtypes = [ctypes.c_int]
        ptxas = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line or "serialized" in line]
        libs[name] = (lib, ptxas)
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    return libs


def launcher(lib, x: torch.Tensor, wpk: torch.Tensor, b: torch.Tensor):
    """A function that runs the variant on x into a fresh y, with the
    package's plan but the variant's own ring depth."""
    N, H, W, _ = x.shape
    plan = conv.plan_conv3x3(N, H, W, torch.cuda.get_device_properties(x.device).multi_processor_count)
    stages = max(s for s in range(2, conv.MAX_STAGES + 1)
                 if lib.nbdt_conv3x3_smem_bytes(s) <= conv.SMEM_LIMIT)
    smem = lib.nbdt_conv3x3_smem_bytes(stages)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run() -> torch.Tensor:
        y = torch.empty_like(x)
        err = lib.nbdt_conv3x3(x.data_ptr(), wpk.data_ptr(), b.data_ptr(), y.data_ptr(), N, H, W,
                               stages, plan.grid, smem, x.device.index or 0, stream)
        if err:
            raise RuntimeError(f"launch failed: {lib.nbdt_conv3x3_error_string(err)} ({err})")
        return y

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv3x3_ablation: no CUDA device", file=sys.stderr)
        return 1
    libs = build_all()
    g = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(3, 3, 64, 64, device="cuda", generator=g) * 0.05
    b = torch.randn(64, device="cuda", generator=g) * 0.01
    wpk = conv.pack_weight(w.bfloat16())
    right = []
    for name, (lib, _) in libs.items():
        worst = 0.0
        for shape in CHECK_SHAPES:
            x = torch.randn(*shape, 64, device="cuda", generator=g).bfloat16()
            got = launcher(lib, x, wpk, b)()
            want = conv.conv3x3_bias_relu_reference(x, w, b)
            torch.cuda.synchronize()
            far = ~torch.isclose(got.float(), want.float(), rtol=1.6e-2, atol=1e-5)
            worst = max(worst, float(far.float().mean()))
        print(json.dumps({"variant": name, "right": worst == 0.0,
                          "largest share of elements outside bf16 assert_close": worst}),
              flush=True)
        if worst == 0.0:
            right.append(name)
    x = torch.randn(args.batch, 32, 32, 64, device="cuda", generator=g).bfloat16()
    runs = {name: launcher(libs[name][0], x, wpk, b) for name in right}
    times = {name: [] for name in right}
    for name in right + right[::-1]:
        ms = time_cuda(runs[name], args.iters)
        times[name].append(ms)
        print(json.dumps({"variant": name, "batch": args.batch, "ms": ms}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "batch": args.batch, "ms": times,
                      "wrong": [n for n in libs if n not in right]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
