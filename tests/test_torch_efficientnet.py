"""nbdt_torch.models.efficientnet against the JAX EfficientNet on the same
weights, and the registry, CLI and NBDT wrappers around it.

``efficientnet_b0`` (symmetric padding) at 64px and ``efficientnet_b0b`` (TF
"SAME" padding: asymmetric at stride 2) at 64px and 65px, batch 2, from one
JAX init with perturbed BatchNorms (b0 and b0b share one parameter layout):
logits and pooled features in f32 within rtol=1e-4, atol=1e-5. The full-size
``efficientnet_b7b`` is held to JAX's pytorchcv spec from ``jax.eval_shape``
alone (no b7 forward in JAX on the CPU)."""

import numpy as np
import pytest
import torch

from test_torch_port import random_variables, tree_pair

CLASSES = 1000
RTOL, ATOL = 1e-4, 1e-5


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def b0():
    """(numpy variables with perturbed BatchNorms, {arch: flax module})."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model

    modules = {a: get_model(a, CLASSES) for a in ("efficientnet_b0", "efficientnet_b0b")}
    variables = jax.jit(modules["efficientnet_b0"].init)(jax.random.PRNGKey(0),
                                                         jnp.zeros((1, 64, 64, 3)))
    return random_variables(variables, 0), modules


def _port(arch, variables, dtype=torch.float32):
    import nbdt_torch.models as tm

    port = tm.get_model(arch, CLASSES)
    port.load_state_dict(tm.state_dict_from_flax(variables, arch), strict=True)
    if dtype != torch.float32:
        port = port.clone(dtype=dtype)
        port.load_state_dict(tm.state_dict_from_flax(variables, arch))
    return port.eval()


@pytest.fixture(scope="module")
def jax_out(b0):
    """{(arch, img): (images, logits, features)} of the JAX apply."""
    import jax

    variables, modules = b0
    out = {}
    for arch, img in (("efficientnet_b0", 64), ("efficientnet_b0b", 64), ("efficientnet_b0b", 65)):
        x = np.random.RandomState(img).randn(2, img, img, 3).astype(np.float32)
        fwd = jax.jit(lambda v, x, f, m=modules[arch]: m.apply(v, x, features_only=f),
                      static_argnums=2)
        out[arch, img] = (x, np.asarray(fwd(variables, x, False)),
                          np.asarray(fwd(variables, x, True)))
    return out


@pytest.mark.parametrize("arch,img", [("efficientnet_b0", 64), ("efficientnet_b0b", 64),
                                      ("efficientnet_b0b", 65)])
@pytest.mark.parametrize("features_only", [False, True], ids=["logits", "features"])
def test_efficientnet_matches_flax(b0, jax_out, arch, img, features_only):
    x, logits, feats = jax_out[arch, img]
    want = feats if features_only else logits
    with torch.no_grad():
        got = _port(arch, b0[0])(_nchw(x), features_only=features_only).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == (1280 if features_only else CLASSES)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_same_padding_is_tf_and_asymmetric():
    """TF "SAME" at stride 2: (0, 1) for a 3x3 on an even side, (1, 1) on an
    odd one, (1, 2) for a 5x5 on an even side; stride 1 pads kernel // 2 on
    both sides."""
    from nbdt_torch.models.efficientnet import _same_pad

    def pads(n, k, s):
        x = torch.zeros(1, 1, n, n)
        y = _same_pad(x + 1, k, s)
        rows = y[0, 0, :, y.shape[-1] // 2]
        top = int((rows == 0).cumprod(0).sum())
        bottom = int((rows.flip(0) == 0).cumprod(0).sum())
        return top, bottom

    assert pads(64, 3, 2) == (0, 1)
    assert pads(65, 3, 2) == (1, 1)
    assert pads(64, 5, 2) == (1, 2)
    assert pads(65, 5, 2) == (2, 2)
    assert pads(64, 5, 1) == (2, 2)
    assert pads(64, 1, 1) == (0, 0)


def test_efficientnet_bf16_matches_flax_bf16(b0, jax_out):
    """dtype=bf16: convs in bf16, BatchNorm, swish and the SE mean in f32, as
    in flax; the two frameworks round bf16 conv outputs in their own order,
    so the logits agree to 5% of the largest and on the argmax."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model

    variables, _ = b0
    x = jax_out["efficientnet_b0b", 64][0]
    want = np.asarray(jax.jit(get_model("efficientnet_b0b", CLASSES, dtype=jnp.bfloat16).apply)(
        variables, x))
    port = _port("efficientnet_b0b", variables, torch.bfloat16)
    assert port.features.stage2.unit1.conv2.conv.weight.dtype == torch.bfloat16
    assert port.output.fc.weight.dtype == torch.float32
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_efficientnet_b7b_keys_and_shapes_match_jax_spec():
    """The full b7b (2560 features, 55 MBConv blocks) on the meta device:
    its state dict, less num_batches_tracked, has exactly the keys of JAX's
    pytorchcv spec at the shapes of JAX's parameters (``jax.eval_shape``),
    and ``state_dict_from_flax`` emits that key set at those shapes."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model
    from nbdt_tpu.models.convert import _efficientnet_spec

    import nbdt_torch.models as tm
    from nbdt_torch.models.efficientnet import MBConv, round_channels

    shapes = jax.eval_shape(get_model("efficientnet_b7b", CLASSES).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))

    def at(tree, coll, path):
        node = tree[coll]
        for p in path:
            node = node[p]
        return tuple(node.shape)

    want = {}
    for key, coll, path, kind in _efficientnet_spec("b7"):
        s = at(shapes, coll, path)
        want[key] = (s[3], s[2], s[0], s[1]) if kind == "conv" else (
            s[::-1] if kind == "linear" else s)
    with torch.device("meta"):
        port = tm.efficientnet_b7b()
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
    assert port.num_features == round_channels(1280 * 2) == 2560
    assert sum(isinstance(m, MBConv) for m in port.modules()) == 55
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    converted = tm.state_dict_from_flax(zeros, "efficientnet_b7b")
    assert {k: tuple(v.shape) for k, v in converted.items()} == want


def test_state_dict_matches_jax_exporter_and_loads_strictly(b0):
    from nbdt_tpu.models.convert import flax_to_torch_state_dict

    import nbdt_torch.models as tm

    variables, _ = b0
    ours = tm.state_dict_from_flax(variables, "efficientnet_b0")
    theirs = flax_to_torch_state_dict(variables, "efficientnet_b0")
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)
    depthwise = ours["features.stage2.unit1.conv2.conv.weight"]
    assert depthwise.shape == (96, 1, 3, 3)
    tm.efficientnet_b0c(CLASSES).load_state_dict(
        {k: torch.tensor(np.asarray(v)) for k, v in theirs.items()}, strict=True)


def test_classifier_probe_finds_output_fc():
    """pytorchcv's head is ``output.fc`` inside an ``output`` container: the
    probe finds it, so SoftNBDT(fused=True) builds and induction has
    centers."""
    from nbdt_torch.hierarchy.generate import get_classifier_from_module
    import nbdt_torch.models as tm

    torch.manual_seed(0)
    model = tm.efficientnet_b0(10)
    kernel, bias = get_classifier_from_module(model)
    np.testing.assert_array_equal(kernel, model.output.fc.weight.detach().numpy().T)
    np.testing.assert_array_equal(bias, model.output.fc.bias.detach().numpy())


@pytest.fixture(scope="module")
def nbdt_setup(b0, jax_out):
    jtree, ttree = tree_pair("Imagenet1000-induced-efficientnet_b7b")
    variables, modules = b0
    x = jax_out["efficientnet_b0b", 64][0]
    return modules["efficientnet_b0b"], variables, _port("efficientnet_b0b", variables), \
        jtree, ttree, x


@pytest.mark.parametrize("fused", [False, True], ids=["rules", "fused"])
def test_soft_nbdt_matches_jax(nbdt_setup, fused):
    """The port's fused path (B1's plain twin on the CPU) and its rules
    against JAX's rules: the JAX kernel refuses an f32 W at D=1280 on
    Imagenet1000."""
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import SoftNBDT

    module, variables, port, jtree, ttree, x = nbdt_setup
    assert ttree.arrays.num_classes == CLASSES
    want = np.asarray(JSoftNBDT("Imagenet1000", module, tree=jtree, params=variables)(x))
    got = SoftNBDT("Imagenet1000", port, tree=ttree, fused=fused, device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_nbdt_decisions_match_jax(nbdt_setup):
    from nbdt_tpu.model import HardNBDT as JHardNBDT
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import HardNBDT, SoftNBDT

    module, variables, port, jtree, ttree, x = nbdt_setup
    for J, T in ((JSoftNBDT, SoftNBDT), (JHardNBDT, HardNBDT)):
        jout, jdec = J("Imagenet1000", module, tree=jtree,
                       params=variables).forward_with_decisions(x)
        tout, tdec = T("Imagenet1000", port, tree=ttree, device="cpu").forward_with_decisions(x)
        np.testing.assert_array_equal(tout.numpy().argmax(1), np.asarray(jout).argmax(1))
        for a, b in zip(jdec, tdec):
            assert [s["node"].wnid for s in a] == [s["node"].wnid for s in b]
            np.testing.assert_allclose([s["prob"] for s in b], [s["prob"] for s in a],
                                       atol=1e-4)


def test_serving_fn_on_efficientnet(nbdt_setup):
    """bf16 + uint8 serves; fold_bn raises TypeError, as in JAX."""
    from nbdt_torch import SoftNBDT, make_serving_fn
    from nbdt_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    _, _, port, _, ttree, _ = nbdt_setup
    u8 = np.random.RandomState(5).randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    norm = (IMAGENET_MEAN, IMAGENET_STD)
    f32 = make_serving_fn(port, ttree, bf16=False, uint8_input=True, normalize=norm,
                          device="cpu")(u8)
    x = (u8 / 255.0 - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    want = SoftNBDT("Imagenet1000", port, tree=ttree, device="cpu")(x.astype(np.float32))
    torch.testing.assert_close(f32, want.as_subclass(torch.Tensor), rtol=1e-4, atol=1e-6)
    bf16 = make_serving_fn(port, ttree, bf16=True, uint8_input=True, normalize=norm,
                           device="cpu")(u8)
    assert bf16.shape == (4, CLASSES) and bool(torch.isfinite(bf16).all())
    torch.testing.assert_close(bf16.sum(1), torch.ones(4), rtol=0, atol=1e-4)
    with pytest.raises(TypeError, match="ResNet family"):
        make_serving_fn(port, ttree, fold_bn=True, device="cpu")


def test_register_model_refuses_a_duplicate():
    import nbdt_torch.models as tm

    with pytest.raises(ValueError, match="already registered"):
        tm.register_model("efficientnet_b7b", tm.efficientnet_b0)
    assert tm.MODEL_REGISTRY["efficientnet_b7b"].__name__ == "efficientnet_b7b"

    @tm.register_model("_test_tiny_effnet")
    def tiny(num_classes=10, dtype=torch.float32):
        return tm.EfficientNet("b0", num_classes, dtype=dtype)

    try:
        assert "_test_tiny_effnet" in tm.get_model_choices()
        assert tm.get_model("_test_tiny_effnet", 3).output.fc.out_features == 3
        with pytest.raises(ValueError):
            tm.register_model("_test_tiny_effnet", tiny)
        assert tm.register_model("_test_tiny_effnet", tm.efficientnet_b0, override=True) \
            is tm.efficientnet_b0
    finally:
        del tm.MODEL_REGISTRY["_test_tiny_effnet"]
    with pytest.raises(KeyError, match="efficientnet_b7b"):
        tm.get_model("densenet121", 10)


def test_registry_has_every_jax_resnet_and_efficientnet():
    from nbdt_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    import nbdt_torch.models as tm

    names = [n for n in JAX_REGISTRY if n.lower().startswith(
        ("resnet", "resnext", "wide_resnet", "efficientnet"))]
    assert len(names) == 15 + 27
    assert set(names) <= set(tm.MODEL_REGISTRY)
    for name in names:
        assert tm.MODEL_REGISTRY[name].__name__ == JAX_REGISTRY[name].__name__


@pytest.mark.parametrize("bn_impl", ["auto", "f32", "bf16"])
def test_bn_impl_resolution_matches_jax(bn_impl):
    """``--bn-impl`` resolves as ``nbdt_tpu.main.resolve_bn_impl`` does, on
    backbones with and without the knob, at 32, 64 and 224px."""
    from nbdt_tpu.main import resolve_bn_impl as jax_resolve
    from nbdt_tpu.models import get_model as jax_get_model

    import nbdt_torch.models as tm
    from nbdt_torch.main import resolve_bn_impl

    for arch in ("ResNet18", "resnet50", "wrn28_10", "efficientnet_b0", "vit_s16"):
        with torch.device("meta"):
            port = tm.get_model(arch, 10)
        module = jax_get_model(arch, 10)
        for image in (32, 64, 224):
            assert resolve_bn_impl(bn_impl, port, image) == jax_resolve(bn_impl, module, image), \
                (arch, image)


def test_cli_eval_efficientnet_imagenet1000(tmp_path, capsys):
    """``--arch efficientnet_b0 --dataset Imagenet1000 --synthetic --eval``
    at 224px on the CPU, with the NBDT analyzer on the b7b induced tree; an
    explicit ``--bn-impl bf16`` on it exits with JAX's message."""
    import re

    from nbdt_torch.main import main

    argv = ["--arch", "efficientnet_b0", "--dataset", "Imagenet1000", "--synthetic", "--eval",
            "--device", "cpu", "--batch-size", "2", "--no-progress",
            "--checkpoint-dir", str(tmp_path), "--hierarchy", "induced-efficientnet_b7b",
            "--analysis", "SoftEmbeddedDecisionRules"]
    acc = main(argv)
    out = capsys.readouterr().out
    assert 0.0 <= acc <= 100.0
    found = re.findall(r"\[NBDT-Soft\] Accuracy: ([\d.]+)%, (\d+)/(\d+)", out)
    assert found and int(found[-1][2]) == 4, out
    with pytest.raises(SystemExit, match="only supported by the ResNet/WRN families"):
        main(argv + ["--bn-impl", "bf16"])
