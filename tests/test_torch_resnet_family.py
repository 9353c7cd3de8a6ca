"""nbdt_torch.models.resnet's Bottleneck, ImageNet stem, torchvision key
grammar and ``bn_impl`` against the JAX ResNets on the same weights.

``ResNet50`` (the CIFAR grammar) at 32px and ``resnet18`` (the torchvision
grammar, ImageNet stem) at 64px, and a ResNeXt-style
``ResNet(Bottleneck, (1, 1, 1, 1), groups=32, base_width=4,
imagenet_stem=True)`` built on both sides, batch 2, from JAX inits with
perturbed BatchNorms: logits and pooled features in f32 within rtol=1e-4,
atol=1e-5. The full-size key sets come from ``jax.eval_shape`` alone.
"""

import numpy as np
import pytest
import torch

from test_torch_port import random_variables

RTOL, ATOL = 1e-4, 1e-5


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


def _x(img, batch=2, seed=1):
    return np.random.RandomState(seed).randn(batch, img, img, 3).astype(np.float32)


def _resnext(lib, num_classes, **kw):
    """The same small ResNeXt (one Bottleneck a stage, 32 groups of width 4,
    the ImageNet stem) in the JAX package (``lib="jax"``) or the port."""
    if lib == "jax":
        from nbdt_tpu.models.resnet import Bottleneck, ResNet

        return ResNet(Bottleneck, (1, 1, 1, 1), num_classes, expansion=4, groups=32,
                      base_width=4, imagenet_stem=True, **kw)
    from nbdt_torch.models import Bottleneck, ResNet

    return ResNet(Bottleneck, (1, 1, 1, 1), num_classes, groups=32, base_width=4,
                  imagenet_stem=True, **kw)


# (arch of the converter, image size, classes)
CASES = {"ResNet50": ("ResNet50", 32, 10), "resnet18": ("resnet18", 64, 1000),
         "resnext": ("resnext50_32x4d", 64, 20)}


@pytest.fixture(scope="module")
def pairs():
    """{case: (flax module, numpy variables, port module, images, JAX logits,
    JAX features)}."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model as jax_get_model

    import nbdt_torch.models as tm

    out = {}
    for case, (arch, img, classes) in CASES.items():
        if case == "resnext":
            module, port = _resnext("jax", classes), _resnext("torch", classes)
        else:
            module, port = jax_get_model(arch, classes), tm.get_model(arch, classes)
        variables = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)))
        variables = random_variables(variables, 0)
        port.load_state_dict(tm.state_dict_from_flax(variables, arch), strict=True)
        x = _x(img)
        fwd = jax.jit(lambda v, x, f, m=module: m.apply(v, x, features_only=f), static_argnums=2)
        out[case] = (module, variables, port.eval(), x, np.asarray(fwd(variables, x, False)),
                     np.asarray(fwd(variables, x, True)))
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("features_only", [False, True], ids=["logits", "features"])
def test_resnet_family_matches_flax(pairs, case, features_only):
    _, _, port, x, logits, feats = pairs[case]
    want = feats if features_only else logits
    with torch.no_grad():
        got = port(_nchw(x), features_only=features_only).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_grouped_conv_and_torchvision_names(pairs):
    """conv2 of the ResNeXt is grouped (width 128 = 4 x 32, 4 inputs a
    group); torchvision's stem, downsample.N and fc; no CIFAR names."""
    port = pairs["resnext"][2]
    conv2 = port.layer1[0].conv2
    assert conv2.groups == 32 and tuple(conv2.weight.shape) == (128, 4, 3, 3)
    assert tuple(port.conv1.weight.shape) == (64, 3, 7, 7)
    keys = set(port.state_dict())
    assert "fc.weight" in keys and "layer1.0.downsample.0.weight" in keys
    assert not any("shortcut" in k or k.startswith("linear") for k in keys)
    cifar = pairs["ResNet50"][2].state_dict()
    assert not any("downsample" in k or k.startswith("fc") for k in cifar)


@pytest.mark.parametrize("case", ["ResNet50", "resnext"])
def test_folded_bottleneck_matches_unfolded(pairs, case):
    """BN folded into conv biases (the stem, Bottleneck's conv3/bn3 and the
    shortcut or downsample included) serves the same function in f32, and
    the JAX folded module's."""
    from nbdt_tpu.models.fold import fold_batchnorm as jax_fold

    from nbdt_torch.models import fold_batchnorm

    module, variables, port, x, logits, _ = pairs[case]
    folded = fold_batchnorm(port)
    assert folded.folded and not any(isinstance(m, torch.nn.BatchNorm2d)
                                     for m in folded.modules())
    assert folded.groups == port.groups and folded.imagenet_stem == port.imagenet_stem
    with torch.no_grad():
        got = folded(_nchw(x)).numpy()
    np.testing.assert_allclose(got, logits, rtol=RTOL, atol=1e-4)
    fmod, fvars = jax_fold(module, variables)
    np.testing.assert_allclose(got, np.asarray(fmod.apply(fvars, x, train=False)),
                               rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("case", ["ResNet50", "resnext"])
def test_bn_impl_f32_stream_is_the_f32_norm(pairs, case):
    """With an f32 stream, ``bn_impl="bf16"`` is the f32 norm: the same
    logits bit for bit; ``clone`` keeps groups, base width and stem."""
    _, _, port, x, _, _ = pairs[case]
    other = port.clone(bn_impl="bf16")
    other.load_state_dict(port.state_dict())
    assert (other.groups, other.base_width, other.imagenet_stem, other.bn_impl) == (
        port.groups, port.base_width, port.imagenet_stem, "bf16")
    with torch.no_grad():
        torch.testing.assert_close(other.eval()(_nchw(x)), port(_nchw(x)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="bn_impl"):
        port.clone(bn_impl="fp8")


@pytest.mark.parametrize("bn_impl", ["f32", "bf16"])
def test_bf16_backbone_bn_impl_matches_flax(pairs, bn_impl):
    """A bf16 stream with each ``bn_impl``: ``"f32"`` normalizes in f32,
    ``"bf16"`` in bf16 (flax ``dtype=bf16``, ``force_float32_reductions=False``).
    The frameworks round bf16 in their own order, so the logits agree to 5%
    of the largest and on the argmax."""
    import jax
    import jax.numpy as jnp

    module, variables, port, x, _, _ = pairs["resnext"]
    jm = module.clone(dtype=jnp.bfloat16, bn_impl=bn_impl)
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    ours = port.clone(dtype=torch.bfloat16, bn_impl=bn_impl)
    ours.load_state_dict(port.state_dict())
    seen = []
    hook = ours.layer1[0].bn1.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        got = ours.eval()(_nchw(x)).numpy()
    hook.remove()
    assert seen == [torch.float32 if bn_impl == "f32" else torch.bfloat16]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_wrn_bn_impl():
    """The WRN has the knob too: bf16 runs its norms in the stream dtype,
    and with an f32 stream it is the f32 norm."""
    from nbdt_torch.models import WRN

    torch.manual_seed(0)
    wrn = WRN(10, 1, 10).eval()
    other = wrn.clone(bn_impl="bf16")
    other.load_state_dict(wrn.state_dict())
    x = _nchw(_x(16))
    with torch.no_grad():
        torch.testing.assert_close(other.eval()(x), wrn(x), rtol=0, atol=0)
        bf = wrn.clone(dtype=torch.bfloat16, bn_impl="bf16")
        bf.load_state_dict(wrn.state_dict())
        seen = []
        bf.features.post_activ.bn.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
        assert bf.eval()(x).dtype == torch.float32
    assert seen == [torch.bfloat16]


@pytest.mark.parametrize("arch", ["resnet50", "ResNet50", "wide_resnet50_2"])
def test_full_size_keys_match_jax_exporter(arch):
    """The full-size key set of the JAX exporter (from ``jax.eval_shape``;
    zeros at each shape) is the port's, in the grammar of the arch's case,
    at the same shapes, and loads strictly."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model as jax_get_model
    from nbdt_tpu.models.convert import flax_to_torch_state_dict

    import nbdt_torch.models as tm

    shapes = jax.eval_shape(jax_get_model(arch, 1000).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    theirs = flax_to_torch_state_dict(zeros, arch)
    ours = tm.state_dict_from_flax(zeros, arch)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(np.shape(v)) for k, v in theirs.items()}
    tv = arch[0].islower()
    assert ("fc.weight" in ours) == tv and ("linear.weight" in ours) != tv
    port = tm.get_model(arch, 1000)
    port.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in theirs.items()},
                         strict=True)


def test_init_model_and_make_eval_fn():
    """``init_model`` draws the same weights from the same seed, others from
    another, and leaves the caller's random state as it was;
    ``make_eval_fn`` is the module's eval forward on NHWC images."""
    import nbdt_torch.models as tm

    torch.manual_seed(123)
    before = torch.rand(3)
    torch.manual_seed(123)
    a = tm.init_model("resnet18", 10, (64, 64, 3), seed=1, device="cpu")
    after = torch.rand(3)
    torch.testing.assert_close(after, before)
    b = tm.init_model("resnet18", 10, (64, 64, 3), seed=1, device="cpu")
    c = tm.init_model("resnet18", 10, (64, 64, 3), seed=2, device="cpu")
    assert not a.training
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    assert not torch.equal(a.fc.weight, c.fc.weight)
    x = _x(64)
    with torch.no_grad():
        want = a(_nchw(x))
    torch.testing.assert_close(tm.make_eval_fn(a, device="cpu")(x), want)
    vit = tm.init_model("vit_s16", 10, (32, 32, 3), device="cpu")
    assert vit.image_size == 32


def test_converter_refuses_an_unknown_arch():
    import nbdt_torch.models as tm

    with pytest.raises(NotImplementedError, match="efficientnet_"):
        tm.state_dict_from_flax({"params": {}}, "densenet121")


def test_cli_bn_impl(tmp_path, monkeypatch):
    """``--bn-impl bf16`` runs (it once exited): the CLI's backbone is the
    clone with ``bn_impl="bf16"`` and the same weights as the f32 one it
    builds from the same seed; ``auto`` is f32 at 32px."""
    import nbdt_torch.trainer as trainer
    from nbdt_torch.main import main

    built = []

    class Spy(trainer.Trainer):
        def __init__(self, config, model, *a, **kw):
            built.append(model)
            super().__init__(config, model, *a, **kw)

    monkeypatch.setattr(trainer, "Trainer", Spy)
    argv = ["--synthetic", "--device", "cpu", "--arch", "ResNet10", "--eval", "--batch-size",
            "4", "--no-progress", "--checkpoint-dir", str(tmp_path)]
    for flag in ("bf16", "auto"):
        assert 0.0 <= main(argv + ["--bn-impl", flag]) <= 100.0
    bf16, auto = built
    assert (bf16.bn_impl, auto.bn_impl) == ("bf16", "f32")
    for k, v in auto.state_dict().items():
        torch.testing.assert_close(bf16.state_dict()[k], v, rtol=0, atol=0)


def test_count_work_from_shapes():
    """``tools/count_work.py`` on the meta device: resnet18 at 224px is
    torchvision's 1.82 GMACs an image, all in dense convs but the
    classifier; an EfficientNet's depthwise convs count as grouped; bytes
    are counted for every op."""
    from nbdt_torch.tools.count_work import count_work

    r18 = count_work("resnet18", 2, 224)
    assert r18["conv_flops"]["grouped"] == 0
    assert r18["flops"] == r18["conv_flops"]["dense"] + 2 * 2 * 512 * 1000
    assert abs(r18["flops"] / 2 / 2 / 1e9 - 1.82) < 0.01
    assert r18["bytes"] == sum(r18["bytes_by_op"].values()) > 0
    b0 = count_work("efficientnet_b0", 1, 224, num_classes=10)
    assert b0["conv_flops"]["grouped"] > 0 and b0["bytes_by_op"]["silu"] > 0
