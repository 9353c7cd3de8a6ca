"""nbdt_torch.ops.layernorm against nbdt_tpu's Pallas LayerNorm run in
interpret mode, on the cases of tests/test_vit_variants.py. On the CPU the
port's wrapper computes its plain version and launches nothing. Tolerance:
f32 within rtol=atol=2e-5, test_vit_variants.py's."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F


def _inputs(rows, d, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, d).astype(np.float32), rng.randn(d).astype(np.float32),
            rng.randn(d).astype(np.float32))


@pytest.mark.parametrize("rows,d", [(300, 128), (257, 384)])
def test_layernorm_matches_pallas_interpret_f32(rows, d):
    import jax.numpy as jnp

    from nbdt_tpu.ops.layernorm import fused_layernorm as jax_layernorm
    from nbdt_torch.ops import layernorm as tln

    x, scale, bias = _inputs(rows, d)
    want = np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                    block_rows=128, interpret=True))
    before = tln.launches
    got = tln.fused_layernorm(torch.as_tensor(x), torch.as_tensor(scale), torch.as_tensor(bias))
    assert tln.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    ref = tln.layernorm_reference(torch.as_tensor(x), torch.as_tensor(scale),
                                  torch.as_tensor(bias))
    np.testing.assert_allclose(ref.numpy(), want, rtol=2e-5, atol=2e-5)
    # the same function as the library call, eps 1e-6 (flax's)
    lib = F.layer_norm(torch.as_tensor(x), (d,), torch.as_tensor(scale),
                       torch.as_tensor(bias), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=2e-5, atol=2e-5)


def test_layernorm_bf16_keeps_dtype_and_matches_pallas_interpret():
    """bf16 in, bf16 out; stats in f32 on both sides, one rounding at the end."""
    import jax.numpy as jnp

    from nbdt_tpu.ops.layernorm import fused_layernorm as jax_layernorm
    from nbdt_torch.ops.layernorm import fused_layernorm

    x, scale, bias = _inputs(64, 128, seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax_layernorm(xb, jnp.asarray(scale), jnp.asarray(bias), block_rows=64,
                         interpret=True)
    assert want.dtype == jnp.bfloat16
    got = fused_layernorm(torch.tensor(np.array(xb.astype(jnp.float32))).bfloat16(),
                          torch.as_tensor(scale), torch.as_tensor(bias))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, torch.tensor(np.array(want.astype(jnp.float32))).bfloat16())


def test_layernorm_keeps_leading_dims():
    from nbdt_torch.ops.layernorm import fused_layernorm, layernorm_reference

    x, scale, bias = _inputs(2 * 3 * 5, 256, seed=3)
    x3 = torch.as_tensor(x).reshape(2, 15, 256)
    w, b = torch.as_tensor(scale), torch.as_tensor(bias)
    got = fused_layernorm(x3, w, b)
    assert got.shape == (2, 15, 256)
    torch.testing.assert_close(got.reshape(30, 256), layernorm_reference(torch.as_tensor(x), w, b))


def test_layernorm_refusals():
    """D not a multiple of 128 (the JAX kernel's lane assertion), mis-sized
    affine, and inputs that would need a backward (the JAX kernel has no VJP)."""
    from nbdt_torch.ops.layernorm import fused_layernorm

    with pytest.raises(ValueError, match="multiple of 128"):
        fused_layernorm(torch.zeros(8, 100), torch.ones(100), torch.zeros(100))
    with pytest.raises(ValueError, match="weight and bias"):
        fused_layernorm(torch.zeros(8, 128), torch.ones(256), torch.zeros(256))
    w = torch.ones(128, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        fused_layernorm(torch.zeros(8, 128), w, torch.zeros(128))
    with torch.no_grad():
        assert fused_layernorm(torch.zeros(8, 128), w, torch.zeros(128)).shape == (8, 128)
