"""The slice as a whole: nbdt_torch's SoftNBDT / HardNBDT / make_serving_fn
on ResNet10 with the CIFAR10 induced tree, against nbdt_tpu's on the same
weights and the same NHWC images."""

import numpy as np
import pytest
import torch

from test_torch_port import resnet_pair, tree_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

IMG = 16


@pytest.fixture(scope="module")
def setup():
    module, variables, port = resnet_pair("ResNet10", img=IMG)
    jtree, ttree = tree_pair("CIFAR10")
    x = np.random.RandomState(2).randn(6, IMG, IMG, 3).astype(np.float32)
    return module, variables, port, jtree, ttree, x


@pytest.mark.parametrize("fused", [False, True], ids=["rules", "fused"])
def test_soft_nbdt_matches_jax(setup, fused):
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import SoftNBDT

    module, variables, port, jtree, ttree, x = setup
    want = np.asarray(JSoftNBDT("CIFAR10", module, tree=jtree, params=variables, fused=fused)(x))
    got = SoftNBDT("CIFAR10", port, tree=ttree, fused=fused, device="cpu")(x)
    assert got._nbdt_output_flag
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))


def test_soft_nbdt_decisions_match_jax(setup):
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import SoftNBDT

    module, variables, port, jtree, ttree, x = setup
    jout, jdec = JSoftNBDT("CIFAR10", module, tree=jtree, params=variables).forward_with_decisions(x)
    tout, tdec = SoftNBDT("CIFAR10", port, tree=ttree, device="cpu").forward_with_decisions(x)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    for a, b in zip(jdec, tdec):
        assert [s["node"].wnid for s in a] == [s["node"].wnid for s in b]
        np.testing.assert_allclose([s["prob"] for s in b], [s["prob"] for s in a], atol=1e-4)


def test_hard_nbdt_matches_jax(setup):
    from nbdt_tpu.model import HardNBDT as JHardNBDT

    from nbdt_torch import HardNBDT

    module, variables, port, jtree, ttree, x = setup
    want = np.asarray(JHardNBDT("CIFAR10", module, tree=jtree, params=variables)(x))
    got = HardNBDT("CIFAR10", port, tree=ttree, device="cpu")(x).numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_array_equal(got, want)


def test_serving_fn_uint8_matches_jax(setup):
    from nbdt_tpu.serving import make_serving_fn as jax_make_serving_fn

    from nbdt_torch import make_serving_fn

    module, variables, port, jtree, ttree, _ = setup
    x = np.random.RandomState(3).randint(0, 256, (6, IMG, IMG, 3)).astype(np.uint8)
    want = np.asarray(jax_make_serving_fn(module, variables, jtree, bf16=False,
                                          uint8_input=True)(x))
    got = make_serving_fn(port, ttree, bf16=False, uint8_input=True, device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_serving_fn_folded_matches_plain(setup):
    """fold_bn (f32) serves the same function as the unfolded wrapper."""
    from nbdt_torch import SoftNBDT, make_serving_fn

    _, _, port, _, ttree, x = setup
    want = SoftNBDT("CIFAR10", port, tree=ttree, device="cpu")(x).numpy()
    got = make_serving_fn(port, ttree, bf16=False, fold_bn=True, device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pretrained_loads_local_checkpoint_only(setup, tmp_path, monkeypatch):
    """pretrained=True reads local files only here: a torch .pth, the JAX
    package's .msgpack of the same weights, or the released file that the
    table names in the checkpoint cache; a key no table holds raises
    before any fetch."""
    import flax.serialization

    from nbdt_torch import SoftNBDT
    from nbdt_torch.models import ResNet10

    _, variables, port, _, ttree, x = setup
    path = tmp_path / "ckpt.pth"
    torch.save({"net": {f"module.{k}": v for k, v in port.state_dict().items()}}, path)
    fresh = SoftNBDT("CIFAR10", ResNet10(10), arch="ResNet10", tree=ttree, pretrained=True,
                     checkpoint_path=str(path), device="cpu")
    want = SoftNBDT("CIFAR10", port, tree=ttree, device="cpu")(x)
    torch.testing.assert_close(fresh(x), want)
    flax_path = tmp_path / "ckpt.msgpack"
    flax_path.write_bytes(flax.serialization.to_bytes(variables))
    from_flax = SoftNBDT("CIFAR10", ResNet10(10), arch="ResNet10", tree=ttree, pretrained=True,
                         checkpoint_path=str(flax_path), device="cpu")
    torch.testing.assert_close(from_flax(x), want)
    with pytest.raises(ValueError, match=".msgpack"):
        SoftNBDT("CIFAR10", ResNet10(10), arch="ResNet10", tree=ttree, pretrained=True,
                 checkpoint_path=str(tmp_path / "ckpt.ckpt"), device="cpu")
    monkeypatch.setenv("NBDT_CHECKPOINT_DIR", str(tmp_path / "cache"))
    with pytest.raises(KeyError, match="No pretrained checkpoint"):
        SoftNBDT("CIFAR10", ResNet10(10), arch="ResNet10", tree=ttree, pretrained=True,
                 device="cpu")
    with pytest.raises(AssertionError, match="pick one"):
        SoftNBDT("CIFAR10", port, tree=ttree, fused=True, fold_bn=True, device="cpu")
