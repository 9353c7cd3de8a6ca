"""nbdt_torch's DenseNet, AlexNet, VGG, GoogLeNet and Inception v3 against
the JAX modules on the same weights (BatchNorms perturbed), and the
classifier probe, NBDT wrappers, checkpoint loader and registry around
them.

Logits and features in f32 within rtol=atol=1e-4 (both sum the same f32
products in other orders; the JAX zoo test allows Inception 2e-3 against
torchvision, the port needs no more than 1e-4): densenet121 and vgg11_bn
(both heads) at 32px, googlenet and alexnet at 64px (AlexNet's adaptive
pool upsamples there), alexnet at 224px, inception_v3 at 96px, batch 2.
Every variant's keys and shapes from ``jax.eval_shape`` alone."""

import numpy as np
import pytest
import torch

from test_torch_port import induced_tree_pair, zoo_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)
from test_torch_zoo_mobile import keys_and_shapes

# name -> (arch, image, constructor keywords)
CASES = {
    "densenet121": ("densenet121", 32, {}),
    "vgg11_bn": ("vgg11_bn", 32, {}),
    "vgg11_bn-classic": ("vgg11_bn", 32, {"classic_head": True}),
    "googlenet": ("googlenet", 64, {}),
    "alexnet-64": ("alexnet", 64, {}),
    "alexnet-224": ("alexnet", 224, {}),
    "inception_v3": ("inception_v3", 96, {}),
}
FEATURES = {"densenet121": 1024, "vgg11_bn": 512, "vgg11_bn-classic": 4096, "googlenet": 1024,
            "alexnet-64": 4096, "alexnet-224": 4096, "inception_v3": 2048}
NBDT_CASES = ["densenet121", "vgg11_bn", "vgg11_bn-classic", "googlenet", "alexnet-64",
              "inception_v3"]
RTOL = ATOL = 1e-4
NBDT_ATOL = 1e-5
VGG = [f"vgg{d}{s}" for s in ("", "_bn") for d in (11, 13, 16, 19)]


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(case):
        if case not in cache:
            arch, img, kw = CASES[case]
            cache[case] = zoo_pair(arch, img, **kw)
        return cache[case]

    return get


@pytest.mark.parametrize("features_only", [False, True], ids=["logits", "features"])
@pytest.mark.parametrize("case", list(CASES))
def test_zoo_matches_flax(pairs, case, features_only):
    _, variables, port, x, fwd = pairs(case)
    want = np.asarray(fwd(variables, x, features_only))
    with torch.no_grad():
        got = port(_nchw(x), features_only=features_only).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == (FEATURES[case] if features_only else 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["densenet121", "densenet161", "densenet169", "densenet201",
                                  "alexnet", "googlenet", "inception_v3"] + VGG[:2]
                         + ["vgg16_bn"])
def test_keys_and_shapes_match_the_jax_exporter(arch):
    """With torchvision's head (VGG: ``classic_head=True``), the full-size
    module's state dict, ``state_dict_from_flax`` and the JAX exporter give
    one key set at one set of shapes."""
    kw = {"classic_head": True} if arch.startswith("vgg") else {}
    own, ours, theirs = keys_and_shapes(arch, **kw)
    assert own == ours == theirs


@pytest.mark.parametrize("arch", VGG)
def test_collapsed_vgg_keys_are_the_ports_own(arch):
    """The JAX module's default VGG head (global mean + one Dense) has no
    torchvision form: the JAX exporter refuses it, and the port's converter
    maps it to the port's own ``classifier.weight``/``bias`` beside
    torchvision's ``features.*``, the keys of the port's module."""
    own, ours, theirs = keys_and_shapes(arch)
    assert isinstance(theirs, ValueError) and "classic_head=True" in str(theirs)
    assert own == ours
    assert own["classifier.weight"] == (1000, 512) and own["classifier.bias"] == (1000,)
    classic, _, _ = keys_and_shapes(arch, classic_head=True)
    assert {k: v for k, v in own.items() if k.startswith("features.")} == {
        k: v for k, v in classic.items() if k.startswith("features.")}


@pytest.mark.parametrize("case", ["densenet121", "vgg11_bn", "vgg11_bn-classic", "googlenet",
                                  "alexnet-64", "inception_v3"])
def test_probe_matches_jax(pairs, case):
    """C6: the port's probe gives JAX's classifier kernel and bias on the
    same weights: ``classifier.6`` for AlexNet and VGG's classic head,
    ``classifier`` for the collapsed VGG and DenseNet, ``fc`` else."""
    from nbdt_tpu.hierarchy.generate import get_classifier_from_flax_params

    from nbdt_torch.hierarchy.generate import get_classifier_from_module

    _, variables, port, _, _ = pairs(case)
    kernel, bias = get_classifier_from_module(port)
    want_k, want_b = get_classifier_from_flax_params(variables["params"])
    assert kernel.shape == want_k.shape == (FEATURES[case], 10)
    np.testing.assert_array_equal(kernel, want_k)
    np.testing.assert_array_equal(bias, want_b)


@pytest.fixture(scope="module")
def trees(pairs):
    from nbdt_tpu.hierarchy.generate import get_centers_from_flax_params

    from nbdt_torch.assets import get_dataset_wnids

    cache = {}

    def get(case):
        if case not in cache:
            centers = get_centers_from_flax_params(pairs(case)[1]["params"])
            cache[case] = induced_tree_pair(centers, get_dataset_wnids("CIFAR10"))
        return cache[case]

    return get


@pytest.mark.parametrize("fused", [False, True], ids=["rules", "fused"])
@pytest.mark.parametrize("case", NBDT_CASES)
def test_soft_nbdt_matches_jax(pairs, trees, case, fused):
    """The port's SoftNBDT (fused: B1's plain twin on the CPU) against
    ``nbdt_tpu.model.SoftNBDT`` on a tree induced from the model's own
    classifier, and the decision paths of both wrappers."""
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT

    from nbdt_torch import SoftNBDT

    module, variables, port, x, _ = pairs(case)
    jtree, ttree = trees(case)
    jsoft = JSoftNBDT(None, module, tree=jtree, params=variables)
    want = np.asarray(jsoft(x))
    tsoft = SoftNBDT(None, port, tree=ttree, fused=fused, device="cpu")
    got = tsoft(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NBDT_ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    if not fused:
        _, jdec = jsoft.forward_with_decisions(x)
        _, tdec = tsoft.forward_with_decisions(x)
        for a, b in zip(jdec, tdec):
            assert [s["node"].wnid for s in a] == [s["node"].wnid for s in b]
            np.testing.assert_allclose([s["prob"] for s in b], [s["prob"] for s in a],
                                       rtol=0, atol=NBDT_ATOL)


def test_classic_vgg_bf16_matches_flax_bf16(pairs):
    """dtype=bf16 with torchvision's head: convs in bf16, BatchNorms in
    f32, the pooled map flattened and cast to f32, ``classifier.0/3/6`` in
    f32 (the JAX module's fc1/fc2 ``dtype=float32``); the logits agree to
    5% of the largest (each framework rounds bf16 conv outputs in its own
    order)."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models import get_model

    _, variables, port, x, _ = pairs("vgg11_bn-classic")
    module = get_model("vgg11_bn", 10, dtype=jnp.bfloat16, classic_head=True)
    want = np.asarray(jax.jit(module.apply)(variables, x).astype(jnp.float32))
    bf16 = port.clone(dtype=torch.bfloat16)
    bf16.load_state_dict(port.state_dict())
    assert bf16.features[0].weight.dtype == torch.bfloat16
    assert {bf16.classifier[i].weight.dtype for i in (0, 3, 6)} == {torch.float32}
    with torch.no_grad():
        got = bf16.eval()(_nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.05 * np.abs(want).max())


@pytest.mark.parametrize("case", ["googlenet", "inception_v3"])
def test_transform_input(pairs, case):
    """``transform_input=True`` is ``transform_input_rescale`` (torchvision's
    per-channel affine) followed by the plain model, as on the JAX side,
    whose plain model gives the same logits on the rescaled images."""
    from nbdt_tpu.models.googlenet import transform_input_rescale as jax_rescale

    import nbdt_torch.models as tm
    from nbdt_torch.models.googlenet import transform_input_rescale

    _, variables, port, x, fwd = pairs(case)
    ti = tm.get_model(case, 10, transform_input=True)
    assert ti.transform_input and not port.transform_input
    ti.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        got = ti.eval()(_nchw(x))
        plain = port(transform_input_rescale(_nchw(x)))
    # the rescale's output has another memory layout than the permuted view,
    # so the CPU conv may sum in another order: f32 rounding only
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)
    rescaled = np.asarray(jax_rescale(x))
    np.testing.assert_allclose(transform_input_rescale(_nchw(x)).permute(0, 2, 3, 1).numpy(),
                               rescaled, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(fwd(variables, rescaled, False)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case,aux", [("googlenet", ("aux1.conv.conv.weight", "aux2.fc2.bias")),
                                      ("inception_v3", ("AuxLogits.fc.weight",))])
def test_load_checkpoint_drops_aux_heads_and_warns(pairs, tmp_path, case, aux):
    """A torchvision GoogLeNet or Inception v3 ``.pth`` carries train-only
    auxiliary heads that neither package builds: ``load_checkpoint`` drops
    them, warns that the pretrained loaders force ``transform_input=True``,
    and the rest loads strictly."""
    from nbdt_torch.model import load_checkpoint

    port = pairs(case)[2]
    sd = {f"module.{k}": v for k, v in port.state_dict().items()}
    sd.update({k: torch.zeros(3) for k in aux})
    path = tmp_path / f"{case}.pth"
    torch.save({"net": sd}, path)
    with pytest.warns(UserWarning, match="transform_input=True"):
        loaded = load_checkpoint(path)
    assert not any(k.startswith(("aux", "AuxLogits")) for k in loaded)
    port.clone().load_state_dict(loaded, strict=True)


def test_registry_has_every_jax_name():
    """Every name of the JAX registry builds in the port, the zoo's under
    the JAX constructors' names; keywords pass through to them."""
    from nbdt_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from nbdt_tpu.models import get_model_choices

    import nbdt_torch.models as tm

    assert set(get_model_choices()) <= set(tm.get_model_choices())
    zoo = [n for n in JAX_REGISTRY if n.startswith((
        "mobilenet", "densenet", "vgg", "alexnet", "googlenet", "inception", "mnasnet",
        "squeezenet", "shufflenet"))]
    assert len(zoo) == 26
    for name in zoo:
        assert tm.MODEL_REGISTRY[name].__name__ == JAX_REGISTRY[name].__name__
    with torch.device("meta"):
        assert tm.get_model("googlenet", 10, transform_input=True).transform_input
        assert tm.get_model("vgg16_bn", 10, classic_head=True).classifier[6].in_features == 4096
        assert isinstance(tm.get_model("vgg16_bn", 10).classifier, torch.nn.Linear)


def test_count_work_of_the_zoo_paths():
    """``tools/count_work.py`` on the meta device: each zoo path's pooled
    width (SqueezeNet has none), VGG's classic head through
    ``classic_head``, and B1's work and bound on the Imagenet1000 tree at
    those widths: the larger of its bytes at HBM rate and its operations at
    the f32 peak, growing with D."""
    from nbdt_torch.tools.count_work import (
        PEAK_BYTES_PER_S, PEAK_F32_FLOPS, count_head, count_work)

    assert count_work("alexnet", 2, 224)["features"] == 4096
    assert count_work("vgg11_bn", 2, 32)["features"] == 512
    assert count_work("vgg11_bn", 2, 32, classic_head=True)["features"] == 4096
    assert count_work("squeezenet1_1", 2, 64)["features"] is None
    bounds = []
    for dim in (1024, 1280, 2048, 4096):
        head = count_head("Imagenet1000", 256, dim)
        assert head["classes"] == 1000 and head["classifier_flops"] == 2 * 256 * dim * 1000
        t_bytes = head["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = (head["classifier_flops"] + head["tree_flops"]) / PEAK_F32_FLOPS * 1e3
        assert head["bound_ms_at_h100_peaks"] == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
        assert head["bound_by"] == "operations"
        bounds.append(head["bound_ms_at_h100_peaks"])
    assert bounds == sorted(bounds)
