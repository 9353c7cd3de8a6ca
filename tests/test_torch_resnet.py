"""nbdt_torch.models (ResNet, fold, converter) against the JAX ResNet on the
same weights: ResNet10 at 32px, batch 2, f32."""

import numpy as np
import pytest
import torch

from test_torch_port import resnet_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def pair():
    return resnet_pair("ResNet10")


def _x(batch=2, img=32, seed=1):
    return np.random.RandomState(seed).randn(batch, img, img, 3).astype(np.float32)


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("features_only", [False, True], ids=["logits", "features"])
def test_resnet10_matches_flax(pair, features_only):
    module, variables, port = pair
    x = _x()
    want = np.asarray(module.apply(variables, x, train=False, features_only=features_only))
    with torch.no_grad():
        got = port(_nchw(x), features_only=features_only).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["ResNet10", "ResNet18"])
def test_state_dict_from_flax_matches_exporter(arch):
    """Same keys and values as nbdt_tpu's flax_to_torch_state_dict, whose
    output also loads into the port's module strictly."""
    from nbdt_tpu.models import init_model
    from nbdt_tpu.models.convert import flax_to_torch_state_dict

    import nbdt_torch.models as tm

    _, variables = init_model(arch, 10, (32, 32, 3))
    ours = tm.state_dict_from_flax(variables, arch)
    theirs = flax_to_torch_state_dict(variables, arch)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)
    getattr(tm, arch)(10).load_state_dict(
        {k: torch.tensor(np.asarray(v)) for k, v in theirs.items()}, strict=True)


def test_folded_matches_unfolded_and_jax_folded(pair):
    from nbdt_tpu.models.fold import fold_batchnorm as jax_fold

    from nbdt_torch.models import fold_batchnorm

    module, variables, port = pair
    x = _x(4)
    folded = fold_batchnorm(port)
    assert folded.folded and not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    with torch.no_grad():
        a = port(_nchw(x)).numpy()
        b = folded(_nchw(x)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    fmod, fvars = jax_fold(module, variables)
    np.testing.assert_allclose(b, np.asarray(fmod.apply(fvars, x, train=False)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(b.argmax(1), a.argmax(1))


def test_bf16_backbone_matches_flax_bf16(pair):
    """dtype=bf16: convs in bf16, BN in f32, head in f32, as in flax. The
    two frameworks round bf16 conv outputs in their own order, so logits
    agree only to bf16 precision."""
    import jax.numpy as jnp

    module, variables, port = pair
    x = _x(4)
    bport = port.clone(dtype=torch.bfloat16)
    bport.load_state_dict(port.state_dict())
    assert bport.conv1.weight.dtype == torch.bfloat16 and bport.bn1.weight.dtype == torch.float32
    with torch.no_grad():
        got = bport.eval()(_nchw(x)).numpy()
    want = np.asarray(module.clone(dtype=jnp.bfloat16).apply(variables, x, train=False))
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-2 * scale)
