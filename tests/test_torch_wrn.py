"""nbdt_torch.models.wideresnet against the JAX WRN on the same weights.

A WRN of depth 10 (one unit a stage) and width 2 at 16px and 32px, batch 4,
f32: logits and pooled features within rtol=atol=1e-4 in eval mode, and in
train mode with the BatchNorm running variance mapped through n/(n-1)
(torch updates it with the unbiased batch variance, flax with the biased
one). The full-size ``wrn28_10*`` modules are built on the meta device and
held to the pinned pytorchcv key contract, ``tests/fixtures/wrn28_10_keys.json``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port import random_variables, tree_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "wrn28_10_keys.json"
DEPTH, WIDTH, CLASSES = 10, 2, 10


def wrn_pair(img=32, num_classes=CLASSES, seed=0):
    """(flax WRN, numpy variables with perturbed BatchNorms, the port's WRN
    loaded from them through ``state_dict_from_flax``)."""
    import jax
    import jax.numpy as jnp
    from nbdt_tpu.models.wideresnet import WRN as JWRN

    from nbdt_torch.models import WRN, state_dict_from_flax

    module = JWRN(depth=DEPTH, width=WIDTH, num_classes=num_classes)
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)), train=False)
    variables = random_variables(variables, seed)
    port = WRN(DEPTH, WIDTH, num_classes)
    port.load_state_dict(state_dict_from_flax(variables, "WRN"), strict=True)
    return module, variables, port.eval()


def _x(batch=4, img=32, seed=1):
    return np.random.RandomState(seed).randn(batch, img, img, 3).astype(np.float32)


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("img", [16, 32])
@pytest.mark.parametrize("features_only", [False, True], ids=["logits", "features"])
def test_wrn_matches_flax(img, features_only):
    module, variables, port = wrn_pair(img)
    x = _x(img=img)
    want = np.asarray(module.apply(variables, x, train=False, features_only=features_only))
    with torch.no_grad():
        got = port(_nchw(x), features_only=features_only).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[1] == (64 * WIDTH if features_only else CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_wrn_train_mode_matches_flax():
    """One train-mode forward: the same logits (batch statistics), and the
    same running statistics once flax's biased variance update is mapped
    through n/(n-1)."""
    module, variables, port = wrn_pair(16)
    x = _x(img=16)
    want, updates = module.apply(variables, x, train=True, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)

    # n of each BatchNorm: batch x its input's spatial size
    sizes = {}

    def record(name):
        def hook(mod, inp, out):
            sizes[name] = inp[0][:, 0].numel()
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in port.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        port.eval()(_nchw(x))
    for h in hooks:
        h.remove()
    new_sd = {k: v.numpy() for k, v in port.state_dict().items()}
    from nbdt_torch.models import state_dict_from_flax

    old = state_dict_from_flax(variables, "WRN")
    flax_new = state_dict_from_flax({"params": variables["params"],
                                     "batch_stats": updates["batch_stats"]}, "WRN")
    assert len(sizes) == 2 * 3 + 1
    for bn, n in sizes.items():
        np.testing.assert_allclose(new_sd[f"{bn}.running_mean"],
                                   flax_new[f"{bn}.running_mean"].numpy(), rtol=1e-4, atol=1e-5)
        old_var = old[f"{bn}.running_var"].numpy()
        mapped = 0.9 * old_var + (flax_new[f"{bn}.running_var"].numpy() - 0.9 * old_var) * n / (n - 1)
        np.testing.assert_allclose(new_sd[f"{bn}.running_var"], mapped, rtol=1e-4, atol=1e-5)
        assert int(new_sd[f"{bn}.num_batches_tracked"]) == 1


@pytest.mark.parametrize("arch,num_classes", [("wrn28_10_cifar10", 10),
                                              ("wrn28_10_cifar100", 100),
                                              ("wrn28_10", 200)])
def test_wrn28_10_keys_match_the_pytorchcv_fixture(arch, num_classes):
    """The full-size modules have exactly the pinned keys and shapes, in
    order (wrn28_10 has the cifar keys with a 200-row ``output``)."""
    from nbdt_torch.models import MODEL_REGISTRY, get_model

    fixture = json.loads(FIXTURE.read_text())
    want = [(k, list(s)) for k, s in fixture.get(arch, fixture["wrn28_10_cifar10"])]
    if arch == "wrn28_10":
        want = [(k, [num_classes] + s[1:] if k.startswith("output.") else s) for k, s in want]
    with torch.device("meta"):
        model = get_model(arch, num_classes)
    got = [(k, list(v.shape)) for k, v in model.state_dict().items()]
    assert len(got) == 155 and got == want
    assert MODEL_REGISTRY[arch] is not None and "WRN" in MODEL_REGISTRY
    assert "features.init_block.weight" in dict(got)
    assert "features.post_activ.bn.num_batches_tracked" in dict(got)


def test_jax_exporter_grammar_loads_strictly(tmp_path):
    """The JAX exporter writes ``init_block.conv.weight`` and
    ``identity_conv.conv.weight``: after ``pytorchcv_wrn_keys`` its state
    dict loads strictly and gives the same logits; ``load_checkpoint`` reads
    a ``.pth`` in either grammar."""
    from nbdt_tpu.models.convert import flax_to_torch_state_dict

    from nbdt_torch.model import load_checkpoint
    from nbdt_torch.models import WRN, pytorchcv_wrn_keys

    module, variables, port = wrn_pair(16)
    theirs = {k: torch.tensor(np.asarray(v)) for k, v in
              flax_to_torch_state_dict(variables, "wrn28_10_cifar10").items()}
    assert "features.init_block.conv.weight" in theirs
    assert any(k.endswith("identity_conv.conv.weight") for k in theirs)
    with pytest.raises(RuntimeError, match="init_block"):
        WRN(DEPTH, WIDTH, CLASSES).load_state_dict(theirs, strict=True)
    x = _nchw(_x(img=16))
    with torch.no_grad():
        want = port(x).numpy()
    for name, sd in (("exporter", theirs), ("pytorchcv", port.state_dict())):
        m = WRN(DEPTH, WIDTH, CLASSES)
        m.load_state_dict(pytorchcv_wrn_keys(sd), strict=True)
        torch.save({"net": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / f"{name}.pth")
        m2 = WRN(DEPTH, WIDTH, CLASSES)
        m2.load_state_dict(load_checkpoint(tmp_path / f"{name}.pth"), strict=True)
        with torch.no_grad():
            np.testing.assert_allclose(m.eval()(x).numpy(), want, rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(m2.eval()(x).numpy(), m.eval()(x).numpy())


def test_port_state_dict_loads_into_jax():
    """The other way: the port's pytorchcv-keyed state dict, read by the JAX
    package's importer, gives the JAX WRN the same logits."""
    from nbdt_tpu.models.convert import torch_state_dict_to_flax

    module, variables, port = wrn_pair(16)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    jvars = torch_state_dict_to_flax(sd, arch="wrn28_10_cifar10")
    x = _x(img=16)
    with torch.no_grad():
        want = port(_nchw(x)).numpy()
    np.testing.assert_allclose(np.asarray(module.apply(jvars, x, train=False)), want,
                               rtol=1e-4, atol=1e-4)


def test_bf16_wrn_matches_flax_bf16():
    """dtype=bf16: convs in bf16, BatchNorm and the head in f32, as in flax;
    the logits agree to bf16 precision."""
    import jax.numpy as jnp

    module, variables, port = wrn_pair(16)
    x = _x(img=16)
    bport = port.clone(dtype=torch.bfloat16)
    bport.load_state_dict(port.state_dict())
    assert bport.features.init_block.weight.dtype == torch.bfloat16
    assert bport.features.post_activ.bn.weight.dtype == torch.float32
    with torch.no_grad():
        got = bport.eval()(_nchw(x)).numpy()
    want = np.asarray(module.clone(dtype=jnp.bfloat16).apply(variables, x, train=False))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-2 * np.abs(want).max())


def test_wrn_serving_and_nbdt_wrappers():
    """A 100-class WRN through SoftNBDT (plain and fused, the fused head's
    plain version on the CPU), HardNBDT and the uint8 serving fn (f32
    against the JAX one on the same weights; bf16 finite); fold_bn refuses
    a WRN with TypeError, as the JAX package's does."""
    from nbdt_tpu.model import SoftNBDT as JSoft
    from nbdt_tpu.serving import make_serving_fn as jserve

    from nbdt_torch import HardNBDT, SoftNBDT, make_serving_fn
    from nbdt_torch.data.transforms import CIFAR_MEAN, CIFAR_STD

    jtree, ttree = tree_pair("CIFAR100")
    module, variables, port = wrn_pair(16, num_classes=100)
    x = _x(img=16, batch=6)
    want = np.asarray(JSoft("CIFAR100", module, params=variables, tree=jtree)(x))
    plain = SoftNBDT("CIFAR100", port, tree=ttree, device="cpu")(x).numpy()
    fused = SoftNBDT("CIFAR100", port, tree=ttree, fused=True, device="cpu")(x).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(fused, want, rtol=1e-4, atol=1e-6)
    _, decisions = HardNBDT("CIFAR100", port, tree=ttree, device="cpu").forward_with_decisions(x)
    assert len(decisions) == 6 and decisions[0][0]["name"] == "root"

    u8 = np.random.RandomState(2).randint(0, 256, (6, 16, 16, 3)).astype(np.uint8)
    for bf16 in (False, True):
        got = make_serving_fn(port, ttree, bf16=bf16, uint8_input=True, device="cpu")(u8)
        assert got.shape == (6, 100) and bool(torch.isfinite(got).all())
        if not bf16:  # bf16 streams round in each framework's own order
            ref = jserve(module, variables, jtree, bf16=False, uint8_input=True,
                         normalize=(CIFAR_MEAN, CIFAR_STD))(u8)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)
    with pytest.raises(TypeError, match="folded"):
        make_serving_fn(port, ttree, fold_bn=True, device="cpu")
