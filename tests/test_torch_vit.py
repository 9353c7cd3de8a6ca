"""nbdt_torch's ViT (models/vit.py, the ViT half of the converter, the
classifier probe, and the slice as a whole: SoftNBDT and make_serving_fn on
a ViT) against nbdt_tpu's on the same weights and the same NHWC images.

Small: dim 128, 2 heads, depth 2, 10 classes, 32px (and 41px, which is not a
multiple of the patch). The JAX side runs its Pallas LayerNorm in interpret
mode, as tests/test_vit_variants.py does. f32 tolerance 1e-4."""

from collections import OrderedDict

import numpy as np
import pytest
import torch
import torch.nn as nn

from test_torch_port import tree_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

SMALL = dict(patch=16, dim=128, depth=2, heads=2, num_classes=10)
VARIANTS = [
    {},
    {"ln_impl": "bf16"},
    {"attention_impl": "jax"},
    {"ln_impl": "pallas"},
    {"ln_impl": "bf16", "attention_impl": "jax"},
    {"ln_impl": "pallas", "attention_impl": "jax"},
]


def _jax_vit(**kw):
    from nbdt_tpu.models.vit import ViT

    if kw.get("ln_impl") == "pallas":
        kw = {**kw, "ln_interpret": True}
    return ViT(**SMALL, **kw)


def vit_pair(img=32, seed=0):
    """(flax module, variables, port ViT loaded from them) at ``img`` px."""
    import jax
    import jax.numpy as jnp

    import nbdt_torch.models as tm

    module = _jax_vit()
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = tm.ViT(**SMALL, image_size=img)
    port.load_state_dict(tm.state_dict_from_flax(variables, "ViT"), strict=True)
    return module, variables, port.eval()


@pytest.fixture(scope="module")
def pair():
    return vit_pair()


def _x(batch=2, img=32, seed=1):
    return np.random.RandomState(seed).randn(batch, img, img, 3).astype(np.float32)


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


def _port_variant(port, **kw):
    m = port.clone(**kw)
    m.load_state_dict(port.state_dict(), strict=True)
    return m.eval()


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: "-".join(kw.values()) or "base")
def test_vit_variant_matches_flax(pair, kw):
    """Every ln_impl/attention_impl variant, f32 stream: logits and
    features_only equal flax's apply on the same weights within 1e-4."""
    _, variables, port = pair
    module = _jax_vit(**kw)
    m = _port_variant(port, **kw)
    x = _x()
    for features_only in (False, True):
        want = np.asarray(module.apply(variables, x, train=False, features_only=features_only))
        with torch.no_grad():
            got = m(_nchw(x), features_only=features_only).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():  # the fused head on the card takes only contiguous feats
        assert m(_nchw(x), features_only=True).is_contiguous()


@pytest.fixture(scope="module")
def pair41():
    return vit_pair(img=41, seed=3)


@pytest.mark.parametrize("ln_impl", ["f32", "pallas"])
def test_vit_same_padding_at_41px(pair41, ln_impl):
    """41 is not a multiple of the patch: flax's conv pads SAME to 48 (3
    pixels before, 4 after; 3 patches a side, 10 tokens); the port pads the
    same way."""
    _, variables, port = pair41
    assert port.encoder.pos_embedding.shape == (1, 10, 128)
    x = _x(img=41)
    kw = {} if ln_impl == "f32" else {"ln_impl": "pallas"}
    want = np.asarray(_jax_vit(**kw).apply(variables, x, train=False))
    with torch.no_grad():
        got = _port_variant(port, **kw)(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="built for"):
        port(_nchw(_x(img=32)))


@pytest.mark.parametrize("ln_impl", ["f32", "pallas"])
def test_vit_bf16_stream_matches_flax_bf16(pair, ln_impl):
    """bf16 stream, LN and head params f32: logits agree to bf16 precision
    (5% of the largest logit; the two frameworks round matmul outputs in
    their own order), features come back in f32."""
    import jax.numpy as jnp

    _, variables, port = pair
    m = _port_variant(port, dtype=torch.bfloat16, ln_impl=ln_impl)
    blk = m.encoder.layers.encoder_layer_0
    assert blk.self_attention.in_proj_weight.dtype == torch.bfloat16
    assert blk.ln_1.weight.dtype == torch.float32 and m.heads.head.weight.dtype == torch.float32
    x = _x(4)
    want = np.asarray(_jax_vit(ln_impl=ln_impl, dtype=jnp.bfloat16).apply(
        variables, x, train=False))
    with torch.no_grad():
        got = m(_nchw(x)).numpy()
        feats = m(_nchw(x), features_only=True)
    assert got.dtype == np.float32 and feats.dtype == torch.float32
    np.testing.assert_allclose(got, want, atol=5e-2 * np.abs(want).max())


def test_state_dict_from_flax_matches_exporter_vit_s16():
    """Same keys and values as nbdt_tpu's flax_to_torch_state_dict for
    vit_s16, whose output also loads into the port's vit_s16 strictly."""
    import jax
    import jax.numpy as jnp

    from nbdt_tpu.models.convert import flax_to_torch_state_dict
    from nbdt_tpu.models.vit import vit_s16 as jax_vit_s16

    import nbdt_torch.models as tm

    variables = jax.jit(lambda k: jax_vit_s16(10).init(k, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.PRNGKey(0))
    ours = tm.state_dict_from_flax(variables, "vit_s16")
    theirs = flax_to_torch_state_dict(variables, "vit_s16")
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)
    tm.vit_s16(10, image_size=32).load_state_dict(
        {k: torch.tensor(np.asarray(v)) for k, v in theirs.items()}, strict=True)


@pytest.mark.parametrize("fused", [False, True], ids=["rules", "fused"])
def test_soft_nbdt_on_vit_matches_jax(pair, fused):
    """SoftNBDT on a ViT with the CIFAR10 induced tree; fused=True runs the
    Pallas LayerNorm and head on the JAX side, their plain versions here."""
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import SoftNBDT

    _, variables, port = pair
    jtree, ttree = tree_pair("CIFAR10")
    kw = {"ln_impl": "pallas"} if fused else {}
    x = _x(6, seed=2)
    want = np.asarray(JSoftNBDT("CIFAR10", _jax_vit(**kw), tree=jtree, params=variables,
                                fused=fused)(x))
    got = SoftNBDT("CIFAR10", _port_variant(port, **kw), tree=ttree, fused=fused,
                   device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_soft_nbdt_on_vit_decisions_match_jax(pair):
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import SoftNBDT

    module, variables, port = pair
    jtree, ttree = tree_pair("CIFAR10")
    x = _x(4, seed=4)
    jout, jdec = JSoftNBDT("CIFAR10", module, tree=jtree, params=variables).forward_with_decisions(x)
    tout, tdec = SoftNBDT("CIFAR10", port, tree=ttree, device="cpu").forward_with_decisions(x)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    for a, b in zip(jdec, tdec):
        assert [s["node"].wnid for s in a] == [s["node"].wnid for s in b]
        np.testing.assert_allclose([s["prob"] for s in b], [s["prob"] for s in a], atol=1e-4)


def test_serving_fn_on_vit_matches_jax(pair):
    """uint8 input normalized with the ImageNet constants, f32 stream, the
    plain rules on both sides; fold_bn refuses a ViT on both sides."""
    from nbdt_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from nbdt_tpu.serving import make_serving_fn as jax_make_serving_fn

    from nbdt_torch import make_serving_fn
    from nbdt_torch.data import transforms

    module, variables, port = pair
    np.testing.assert_array_equal(transforms.IMAGENET_MEAN, IMAGENET_MEAN)
    np.testing.assert_array_equal(transforms.IMAGENET_STD, IMAGENET_STD)
    jtree, ttree = tree_pair("CIFAR10")
    norm = (transforms.IMAGENET_MEAN, transforms.IMAGENET_STD)
    x = np.random.RandomState(3).randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    want = np.asarray(jax_make_serving_fn(module, variables, jtree, bf16=False,
                                          uint8_input=True, normalize=norm)(x))
    got = make_serving_fn(port, ttree, bf16=False, uint8_input=True, normalize=norm,
                          device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    with pytest.raises(TypeError, match="folded"):
        make_serving_fn(port, ttree, fold_bn=True, device="cpu")


def test_serving_fn_on_vit_bf16_pallas(pair):
    """bf16 + ln_impl="pallas": a leaf distribution of the right shape whose
    argmax mostly agrees with the f32 path (bf16 rounding, reported by the
    chip run at full size; here a loose floor)."""
    from nbdt_torch import make_serving_fn

    _, _, port = pair
    _, ttree = tree_pair("CIFAR10")
    x = np.random.RandomState(5).randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    f32 = make_serving_fn(port, ttree, bf16=False, uint8_input=True, device="cpu")(x)
    bf16 = make_serving_fn(_port_variant(port, ln_impl="pallas"), ttree, bf16=True,
                           uint8_input=True, device="cpu")(x)
    assert bf16.shape == (8, 10) and bf16.dtype == torch.float32
    assert bool(torch.isfinite(bf16).all())
    torch.testing.assert_close(bf16.sum(1), torch.ones(8), rtol=0, atol=1e-4)
    assert float((bf16.argmax(1) == f32.argmax(1)).float().mean()) >= 0.75


@pytest.mark.parametrize("name", ["linear", "fc", "classifier", "head", "output", "heads.head"])
def test_classifier_probe_finds_each_name(name):
    from nbdt_torch.hierarchy.generate import get_classifier_from_module

    layer = nn.Linear(6, 4)
    if name == "heads.head":
        module = nn.Module()
        module.heads = nn.Sequential(OrderedDict(head=layer))
    else:
        module = nn.Module()
        setattr(module, name, layer)
        module.other = nn.Linear(6, 3)
    kernel, bias = get_classifier_from_module(module)
    np.testing.assert_array_equal(kernel, layer.weight.detach().numpy().T)
    np.testing.assert_array_equal(bias, layer.bias.detach().numpy())


def test_classifier_probe_order_and_none():
    """The JAX package's order wins (``linear`` before ``output``); a module
    named like a classifier but not a Linear is skipped; none gives None."""
    from nbdt_torch.hierarchy.generate import get_classifier_from_module
    from nbdt_torch.models import ViT

    module = nn.Module()
    module.output = nn.Linear(6, 4)
    module.linear = nn.Linear(6, 5)
    assert get_classifier_from_module(module)[0].shape == (6, 5)
    module = nn.Module()
    module.fc = nn.Sequential(nn.Linear(6, 4))
    module.body = nn.Linear(6, 4)
    assert get_classifier_from_module(module) == (None, None)
    kernel, _ = get_classifier_from_module(ViT(dim=128, depth=1, heads=2, num_classes=7,
                                               image_size=16))
    assert kernel.shape == (128, 7)


def test_get_model_registry():
    import nbdt_torch.models as tm

    with torch.device("meta"):  # full width without the init's cost
        vit = tm.get_model("vit_b16", 12, dtype=torch.bfloat16, ln_impl="pallas", image_size=32)
    assert isinstance(vit, tm.ViT) and vit.dim == 768 and vit.depth == 12
    assert vit.dtype == torch.bfloat16 and vit.ln_impl == "pallas"
    assert vit.encoder.pos_embedding.shape == (1, 5, 768)
    assert isinstance(tm.get_model("ResNet18", 10), tm.ResNet)
    resnets = ["ResNet10", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
               "resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
               "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2"]
    effnets = [f"efficientnet_b{i}{s}" for i in range(9) for s in ("", "b", "c")]
    zoo = ["mobilenet_v2", "densenet121", "densenet161", "densenet169", "densenet201",
           "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
           "alexnet", "googlenet", "inception_v3", "mnasnet0_5", "mnasnet0_75", "mnasnet1_0",
           "mnasnet1_3", "squeezenet1_0", "squeezenet1_1", "shufflenet_v2_x0_5",
           "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0"]
    assert sorted(tm.MODEL_REGISTRY) == sorted(
        resnets + effnets + zoo + ["WRN", "vit_b16", "vit_s16", "wrn28_10", "wrn28_10_cifar10",
                                   "wrn28_10_cifar100", "swin_b_w12_384"])
    with pytest.raises(KeyError, match="unknown arch"):
        tm.get_model("yournet18", 10)
    with pytest.raises(ValueError, match="ln_impl"):
        tm.vit_s16(10, ln_impl="fast")
