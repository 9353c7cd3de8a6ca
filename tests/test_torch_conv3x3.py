"""nbdt_torch.ops.conv3x3 and its probe against tools/probe_pallas_conv.py:
the three TPU kernels (B3a dy-packed, B3b row-pair, B3c full im2col) run in
interpret mode on the CPU, and the probe's native lax.conv_general_dilated
formula. The JAX probe is loaded by file path with its module-level
INTERPRET flag set on the loaded module; the file itself is not changed.
Batch 4, TPU tile 2. On the CPU the port's wrapper computes its plain
version and launches nothing. Tolerance: torch.testing.assert_close's bf16
defaults (rtol 1.6e-2, atol 1e-5), for f32 sums in another order followed by
one rounding to bf16."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_port import torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_pallas_conv", REPO / "tools" / "probe_pallas_conv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


def _inputs(batch=4, h=32, w=32, seed=0):
    """x [batch, h, w, 64], w HWIO, b: the JAX probe's scales, f32 numpy."""
    rng = np.random.RandomState(seed)
    wt = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    b = (rng.randn(64) * 0.01).astype(np.float32)
    return rng.randn(batch, h, w, 64).astype(np.float32), wt, b


def _jax_bf16(x):
    import jax.numpy as jnp

    return jnp.asarray(x).astype(jnp.bfloat16)


def _to_torch(y):
    """A JAX bf16 array as a torch bf16 tensor (exact through f32)."""
    import jax.numpy as jnp

    return torch.from_numpy(np.array(y.astype(jnp.float32))).bfloat16()


def _port(x, w, b):
    from nbdt_torch.ops.conv3x3 import conv3x3_bias_relu

    return conv3x3_bias_relu(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                             torch.from_numpy(b))


@pytest.mark.parametrize("form", ["a", "b", "c"])
def test_conv3x3_matches_tpu_kernel_interpret(jprobe, form):
    """The port against B3a/b/c, each with its own packed weight."""
    import jax.numpy as jnp

    from nbdt_torch.ops import conv3x3 as tconv

    make, pack = {
        "a": (jprobe.make_kernel_a, jprobe.pack_w_dy),
        "b": (lambda tb: jprobe.make_kernel_b(tb)[0], jprobe.pack_w_rowpair),
        "c": (jprobe.make_kernel_c, jprobe.pack_w_full),
    }[form]
    x, w, b = _inputs()
    want = make(2)(_jax_bf16(x), jnp.asarray(pack(w), jnp.bfloat16),
                   jnp.asarray(b).reshape(1, 64))
    before = tconv.launches
    got = _port(x, w, b)
    assert tconv.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (4, 32, 32, 64)
    torch.testing.assert_close(got, _to_torch(want))


@pytest.mark.parametrize("shape", [(4, 32, 32), (3, 7, 5), (2, 1, 1)])
def test_conv3x3_matches_native_xla_conv(shape):
    """The port against the JAX probe's native formula (its ``native``):
    lax.conv_general_dilated in f32 on bf16 values, + b, ReLU, bf16; at the
    probe's map and at maps the TPU kernels do not take."""
    import jax.numpy as jnp
    from jax import lax

    x, w, b = _inputs(*shape, seed=1)
    out = lax.conv_general_dilated(
        _jax_bf16(x), _jax_bf16(w), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    want = jnp.maximum(out + jnp.asarray(b), 0.0).astype(jnp.bfloat16)
    got = _port(x, w, b)
    assert got.shape == (*shape, 64)
    torch.testing.assert_close(got, _to_torch(want))


def test_plain_version_matches_f32_conv2d():
    """The plain version against F.conv2d in f32 on the bf16-rounded values,
    on an odd map (edges and a ragged tile on the card)."""
    from nbdt_torch.ops.conv3x3 import conv3x3_bias_relu_reference

    x, w, b = _inputs(3, 7, 5, seed=2)
    xb, wb, bt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), torch.from_numpy(b)
    ref = F.conv2d(xb.float().permute(0, 3, 1, 2), wb.float().permute(3, 2, 0, 1), bt, padding=1)
    want = ref.relu().permute(0, 2, 3, 1).bfloat16()
    got = conv3x3_bias_relu_reference(xb, wb, bt)
    torch.testing.assert_close(got, want)
    # an f32 weight is rounded to bf16 first, as the wrapper rounds it
    assert torch.equal(conv3x3_bias_relu_reference(xb, torch.from_numpy(w), bt), got)


def _refusal(case):
    bf = torch.bfloat16
    x, w, b = torch.zeros(1, 4, 4, 64, dtype=bf), torch.zeros(3, 3, 64, 64), torch.zeros(64)
    return {
        "x_not_bf16": ((x.float(), w, b), ValueError, "bf16"),
        "channels": ((torch.zeros(1, 4, 4, 32, dtype=bf), w, b), ValueError, "NHWC"),
        "w_shape": ((x, torch.zeros(3, 3, 64, 32), b), ValueError, "HWIO"),
        "b_shape": ((x, w, torch.zeros(32)), ValueError, r"b must be \[64\]"),
        "devices": ((x, w.to("meta"), b), ValueError, "x on cpu, w on meta"),
        "grad": ((x, torch.zeros(3, 3, 64, 64, requires_grad=True), b), RuntimeError,
                 "forward only"),
    }[case]


@pytest.mark.parametrize("case", ["x_not_bf16", "channels", "w_shape", "b_shape", "devices",
                                  "grad"])
def test_conv3x3_refusals(case):
    """x not bf16, C != 64, w not [3,3,64,64], b not [64], tensors on two
    devices, and inputs that would need a backward (the TPU kernels have no
    VJP); the same inputs pass under no_grad."""
    from nbdt_torch.ops.conv3x3 import conv3x3_bias_relu

    args, exc, match = _refusal(case)
    with pytest.raises(exc, match=match):
        conv3x3_bias_relu(*args)
    if case == "grad":
        with torch.no_grad():
            assert conv3x3_bias_relu(*args).shape == (1, 4, 4, 64)


def test_probe_inputs_are_the_jax_probes_draws(monkeypatch):
    """make_inputs draws what tools/probe_pallas_conv.py's main draws, in its
    order, also when the timing batch is drawn in chunks."""
    from nbdt_torch.tools import probe_pallas_conv as probe

    monkeypatch.setattr(probe, "DRAW_CHUNK", 2)
    inp = probe.make_inputs(5, 3, "cpu")
    rng = np.random.RandomState(0)
    w = (rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32)
    bias = (rng.randn(64) * 0.01).astype(np.float32)
    xs = rng.randn(3, 32, 32, 64).astype(np.float32)
    x = rng.randn(5, 32, 32, 64).astype(np.float32)
    assert torch.equal(inp.w, torch.from_numpy(w).bfloat16())
    assert inp.b.dtype == torch.float32 and torch.equal(inp.b, torch.from_numpy(bias))
    assert torch.equal(inp.x_parity, torch.from_numpy(xs).bfloat16())
    assert torch.equal(inp.x, torch.from_numpy(x).bfloat16())


def test_probe_bound_at_the_probe_shape():
    """0.641 ms by bytes at N=8192 (2 x 1.0737 GB over 3.35 TB/s), with the
    operations at 0.6254 ms (618.5 GFLOP over 989 TFLOP/s)."""
    from nbdt_torch.tools.probe_pallas_conv import PEAK_BF16_FLOPS, bound_ms

    x = torch.empty(8192, 32, 32, 64, dtype=torch.bfloat16, device="meta")
    w = torch.empty(3, 3, 64, 64, dtype=torch.bfloat16, device="meta")
    b = torch.empty(64, dtype=torch.float32, device="meta")
    ms, by = bound_ms(x, w, b)
    assert by == "bytes" and abs(ms - 0.64106) < 1e-4
    assert abs(2 * 8192 * 32 * 32 * 9 * 64 * 64 / PEAK_BF16_FLOPS * 1e3 - 0.62535) < 1e-4


def test_probe_cli_on_cpu(capsys):
    """``python -m nbdt_torch.tools.probe_pallas_conv --device cpu ...``: the
    parity phase and one request on the plain version, no timing."""
    from nbdt_torch.tools import probe_pallas_conv as probe

    assert probe.main(["--device", "cpu", "--batch", "4", "--parity-batch", "2",
                       "--iters", "1"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [next(iter(d)) for d in lines[:2]] == ["parity", "request"]
    result = lines[-1]
    assert set(result) == {"device", "batch", "parity_batch", "parity", "request", "bound_ms",
                           "bound_by", "timing"}
    assert result["device"] == "cpu" and result["timing"] is None
    assert result["parity"]["vs_plain"]["max_abs_err"] == 0.0
    assert result["request"] == {**result["request"], "launches": 0,
                                 "shape": [4, 32, 32, 64], "finite": True}
    assert 0.0 < result["request"]["zero_share"] < 1.0
