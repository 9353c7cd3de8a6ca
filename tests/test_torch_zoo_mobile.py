"""nbdt_torch's MobileNetV2, MNASNet, ShuffleNetV2 and SqueezeNet against
the JAX modules on the same weights (BatchNorms perturbed), and the
classifier probe, NBDT wrappers, serving fn and CLI around them.

Logits and pooled features in f32 within rtol=atol=1e-4 (both sum the same
f32 products in other orders): mobilenet_v2 at 32px, mnasnet0_5,
shufflenet_v2_x0_5 and squeezenet1_1 at 64px, batch 2. Every variant's
keys and shapes from ``jax.eval_shape`` alone (no init, no forward)."""

import numpy as np
import pytest
import torch

from test_torch_port import induced_tree_pair, zoo_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

CASES = {"mobilenet_v2": 32, "mnasnet0_5": 64, "shufflenet_v2_x0_5": 64, "squeezenet1_1": 64}
NAMES = ["mobilenet_v2", "mnasnet0_5", "mnasnet0_75", "mnasnet1_0", "mnasnet1_3",
         "squeezenet1_0", "squeezenet1_1", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
         "shufflenet_v2_x1_5", "shufflenet_v2_x2_0"]
RTOL = ATOL = 1e-4
# NBDT leaf and decision probabilities (values in [0, 1], from f32 logits that agree
# within 1e-4)
NBDT_ATOL = 1e-5


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def pairs():
    """arch -> test_torch_port.zoo_pair(arch, CASES[arch]), built once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = zoo_pair(arch, CASES[arch])
        return cache[arch]

    return get


@pytest.mark.parametrize("features_only", [False, True], ids=["logits", "features"])
@pytest.mark.parametrize("arch", list(CASES))
def test_zoo_matches_flax(pairs, arch, features_only):
    """Logits, and the pooled features the fused head takes; SqueezeNet has
    none and raises NotImplementedError in both packages."""
    _, variables, port, x, fwd = pairs(arch)
    if arch.startswith("squeezenet") and features_only:
        with pytest.raises(NotImplementedError, match="no exact"):
            fwd(variables, x, True)
        with pytest.raises(NotImplementedError, match="no exact"), torch.no_grad():
            port(_nchw(x), features_only=True)
        return
    want = np.asarray(fwd(variables, x, features_only))
    with torch.no_grad():
        got = port(_nchw(x), features_only=features_only).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _eval_shape_zeros(arch, img=96, **kw):
    """Zero numpy variables of the JAX module at 1000 classes, from
    ``jax.eval_shape`` (nothing is initialized or run)."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model

    shapes = jax.eval_shape(get_model(arch, 1000, **kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, img, img, 3)))
    return jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)


def keys_and_shapes(arch, **kw):
    """({key: shape} of the port's module on the meta device, of
    ``state_dict_from_flax`` and of the JAX exporter, or the exporter's
    ValueError) for ``arch`` at 1000 classes."""
    from nbdt_tpu.models.convert import flax_to_torch_state_dict

    import nbdt_torch.models as tm

    zeros = _eval_shape_zeros(arch, **kw)
    with torch.device("meta"):
        port = tm.get_model(arch, 1000, **kw)
    own = {k: tuple(v.shape) for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    ours = {k: tuple(v.shape) for k, v in tm.state_dict_from_flax(zeros, arch).items()}
    try:
        theirs = {k: tuple(np.shape(v)) for k, v in flax_to_torch_state_dict(zeros, arch).items()}
    except ValueError as e:
        theirs = e
    return own, ours, theirs


@pytest.mark.parametrize("arch", NAMES)
def test_keys_and_shapes_match_the_jax_exporter(arch):
    """The full-size module's state dict, ``state_dict_from_flax`` and the
    JAX exporter give one key set at one set of shapes."""
    own, ours, theirs = keys_and_shapes(arch)
    assert own == ours == theirs


@pytest.mark.parametrize("arch", list(CASES))
def test_probe_matches_jax(pairs, arch):
    """C6: the port's probe takes torchvision's head (``classifier.1``'s
    Linear, SqueezeNet's ``classifier.1`` 1x1 conv reshaped to ``[D, C]``,
    ``fc``) and gives JAX's kernel and bias on the same weights."""
    from nbdt_tpu.hierarchy.generate import get_classifier_from_flax_params

    from nbdt_torch.hierarchy.generate import get_classifier_from_module

    _, variables, port, _, _ = pairs(arch)
    kernel, bias = get_classifier_from_module(port)
    want_k, want_b = get_classifier_from_flax_params(variables["params"])
    assert kernel.shape == want_k.shape == (512 if arch.startswith("squeeze") else
                                            1024 if arch.startswith("shuffle") else 1280, 10)
    np.testing.assert_array_equal(kernel, want_k)
    np.testing.assert_array_equal(bias, want_b)


def _probed(model, name):
    layer = model.get_submodule(name)
    return layer.weight.detach().numpy().reshape(layer.weight.shape[:2]).T


@pytest.mark.parametrize("arch,name", [
    ("mobilenet_v2", "classifier.1"), ("mnasnet0_5", "classifier.1"),
    ("squeezenet1_1", "classifier.1"), ("shufflenet_v2_x0_5", "fc"), ("alexnet", "classifier.6"),
    ("densenet121", "classifier"), ("googlenet", "fc"),
    # what the probe found before the repair, unchanged
    ("ResNet18", "linear"), ("resnet18", "fc"), ("wrn28_10_cifar10", "output"),
    ("efficientnet_b0", "output.fc"), ("vit_s16", "heads.head")])
def test_probe_finds_each_backbones_classifier(arch, name):
    """Which layer the probe takes on each family: torchvision's heads
    inside a ``classifier`` Sequential (``classifier.6`` before
    ``classifier.1``: AlexNet's ``classifier.1`` is a hidden layer), and
    exactly what it took before on the backbones ported earlier."""
    from nbdt_torch.hierarchy.generate import get_classifier_from_module
    import nbdt_torch.models as tm

    torch.manual_seed(0)
    model = tm.get_model(arch, 10, image_size=32)
    kernel, bias = get_classifier_from_module(model)
    np.testing.assert_array_equal(kernel, _probed(model, name))
    np.testing.assert_array_equal(bias, model.get_submodule(name).bias.detach().numpy())


@pytest.fixture(scope="module")
def trees(pairs):
    """arch -> (nbdt_tpu Tree, nbdt_torch Tree) induced from the JAX
    module's classifier over CIFAR10's wnids."""
    from nbdt_tpu.hierarchy.generate import get_centers_from_flax_params

    from nbdt_torch.assets import get_dataset_wnids

    cache = {}

    def get(arch):
        if arch not in cache:
            centers = get_centers_from_flax_params(pairs(arch)[1]["params"])
            cache[arch] = induced_tree_pair(centers, get_dataset_wnids("CIFAR10"))
        return cache[arch]

    return get


@pytest.mark.parametrize("fused", [False, True], ids=["rules", "fused"])
@pytest.mark.parametrize("arch", ["mobilenet_v2", "mnasnet0_5", "shufflenet_v2_x0_5"])
def test_soft_nbdt_matches_jax(pairs, trees, arch, fused):
    """The port's SoftNBDT (fused: B1's plain twin on the CPU, on the
    classifier the probe found) against ``nbdt_tpu.model.SoftNBDT`` on a
    tree induced from the model's own classifier; before C6's repair the
    fused wrapper raised on these backbones (no classifier found)."""
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import SoftNBDT

    module, variables, port, x, _ = pairs(arch)
    jtree, ttree = trees(arch)
    want = np.asarray(JSoftNBDT(None, module, tree=jtree, params=variables)(x))
    got = SoftNBDT(None, port, tree=ttree, fused=fused, device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NBDT_ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("arch", ["mobilenet_v2", "mnasnet0_5", "shufflenet_v2_x0_5",
                                  "squeezenet1_1"])
def test_nbdt_decisions_match_jax(pairs, trees, arch):
    from nbdt_tpu.model import HardNBDT as JHardNBDT
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import HardNBDT, SoftNBDT

    module, variables, port, x, _ = pairs(arch)
    jtree, ttree = trees(arch)
    for J, T in ((JSoftNBDT, SoftNBDT), (JHardNBDT, HardNBDT)):
        jout, jdec = J(None, module, tree=jtree, params=variables).forward_with_decisions(x)
        tout, tdec = T(None, port, tree=ttree, device="cpu").forward_with_decisions(x)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=NBDT_ATOL)
        for a, b in zip(jdec, tdec):
            assert [s["node"].wnid for s in a] == [s["node"].wnid for s in b]
            np.testing.assert_allclose([s["prob"] for s in b], [s["prob"] for s in a],
                                       rtol=0, atol=NBDT_ATOL)


def test_squeezenet_has_no_fused_head(pairs, trees):
    """SqueezeNet's logits are no linear function of pooled features, so the
    fused wrapper raises NotImplementedError at its first call in both
    packages (it never serves through the plain rules in its place)."""
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import SoftNBDT

    module, variables, port, x, _ = pairs("squeezenet1_1")
    jtree, ttree = trees("squeezenet1_1")
    with pytest.raises(NotImplementedError):
        JSoftNBDT(None, module, tree=jtree, params=variables, fused=True)(x)
    with pytest.raises(NotImplementedError):
        SoftNBDT(None, port, tree=ttree, fused=True, device="cpu")(x)


def test_shufflenet_bf16_matches_flax_bf16(pairs):
    """dtype=bf16: the convs and ``fc`` in bf16 (the JAX module's Dense takes
    the stream's dtype, and its f32 pooled mean is not cast before it), the
    BatchNorms in f32; the logits are bf16 on both sides and agree to 5% of
    the largest (each framework rounds bf16 conv outputs in its own
    order)."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model

    _, variables, port, x, _ = pairs("shufflenet_v2_x0_5")
    want = jax.jit(get_model("shufflenet_v2_x0_5", 10, dtype=jnp.bfloat16).apply)(variables, x)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    bf16 = port.clone(dtype=torch.bfloat16)
    bf16.load_state_dict(port.state_dict())
    assert bf16.fc.weight.dtype == bf16.stage2[0].branch2[0].weight.dtype == torch.bfloat16
    assert bf16.conv5[1].weight.dtype == torch.float32
    with torch.no_grad():
        feats = bf16.eval()(_nchw(x), features_only=True)
        got = bf16(_nchw(x))
    assert feats.dtype == torch.float32 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05 * np.abs(want).max())


def test_mnasnet_train_statistics_match_jax(pairs):
    """One train-mode forward of mnasnet0_5: the logits (batch statistics)
    within 1e-4, and every BatchNorm's running statistics updated with
    torchvision's momentum 1 - 0.9997 as flax's 0.9997 updates them; torch
    takes the unbiased batch variance, flax the biased one, so the JAX
    running variances are mapped through n/(n-1) (n: the values a channel
    normalizes over) and neither side is changed."""
    import jax

    import nbdt_torch.models as tm

    module, variables, port, x, _ = pairs("mnasnet0_5")
    logits, new = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    want = tm.state_dict_from_flax({"params": variables["params"], **new}, "mnasnet0_5")
    init = tm.state_dict_from_flax(variables, "mnasnet0_5")
    train = port.clone()
    train.load_state_dict(port.state_dict())
    bns = {n: m for n, m in train.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    assert len(bns) == 52 and {m.momentum for m in bns.values()} == {1 - 0.9997}
    counts = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: counts.__setitem__(n, i[0].numel() // i[0].shape[1]))
        for n, m in bns.items()]
    with torch.no_grad():
        got = train.train()(_nchw(x))
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=RTOL, atol=ATOL)
    keep = 0.9997
    for name in bns:
        k = f"{name}.running_var"
        n = counts[name]
        var = keep * init[k] + n / (n - 1) * (want[k] - keep * init[k])
        torch.testing.assert_close(train.state_dict()[k], var, rtol=2e-4, atol=2e-6, msg=k)
        k = f"{name}.running_mean"
        torch.testing.assert_close(train.state_dict()[k], want[k], rtol=2e-4, atol=2e-6, msg=k)
        assert not torch.equal(want[k], init[k]), k


def test_serving_fn_on_the_zoo(pairs, trees):
    """bf16 + uint8 serves a MobileNetV2 (finite, normalized leaf
    probabilities; f32 equal to the wrapper's plain rules); fold_bn raises
    TypeError on every new family, as in JAX."""
    from nbdt_torch import SoftNBDT, make_serving_fn
    from nbdt_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    _, _, port, _, _ = pairs("mobilenet_v2")
    _, ttree = trees("mobilenet_v2")
    u8 = np.random.RandomState(5).randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    norm = (IMAGENET_MEAN, IMAGENET_STD)
    f32 = make_serving_fn(port, ttree, bf16=False, uint8_input=True, normalize=norm,
                          device="cpu")(u8)
    x = ((u8 / 255.0 - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)).astype(np.float32)
    want = SoftNBDT(None, port, tree=ttree, device="cpu")(x)
    torch.testing.assert_close(f32, want.as_subclass(torch.Tensor), rtol=1e-4, atol=1e-6)
    bf16 = make_serving_fn(port, ttree, bf16=True, uint8_input=True, normalize=norm,
                           device="cpu")(u8)
    assert bf16.shape == (4, 10) and bool(torch.isfinite(bf16).all())
    torch.testing.assert_close(bf16.sum(1), torch.ones(4), rtol=0, atol=1e-4)
    import nbdt_torch.models as tm

    for arch in ("mobilenet_v2", "mnasnet0_5", "shufflenet_v2_x0_5", "squeezenet1_1",
                 "densenet121", "alexnet", "vgg11", "googlenet", "inception_v3"):
        with torch.device("meta"):
            model = tm.get_model(arch, 10)
        with pytest.raises(TypeError, match="ResNet family"):
            make_serving_fn(model, ttree, fold_bn=True, device="cpu")


def test_cli_eval_mobilenet_v2(tmp_path, capsys):
    """``--arch mobilenet_v2 --dataset CIFAR10 --synthetic --eval`` on the
    CPU, with the NBDT analyzer on a hierarchy the CLI induces from the
    fresh backbone's ``classifier.1`` (the probe of C6)."""
    import re

    from nbdt_torch.main import main

    acc = main(["--arch", "mobilenet_v2", "--dataset", "CIFAR10", "--synthetic", "--eval",
                "--device", "cpu", "--batch-size", "4", "--no-progress",
                "--checkpoint-dir", str(tmp_path), "--analysis", "SoftEmbeddedDecisionRules"])
    out = capsys.readouterr().out
    assert 0.0 <= acc <= 100.0
    found = re.findall(r"\[NBDT-Soft\] Accuracy: ([\d.]+)%, (\d+)/(\d+)", out)
    assert found and int(found[-1][2]) == 8, out
    assert (tmp_path / "CIFAR10" / "graph-induced-mobilenet_v2.json").exists()
