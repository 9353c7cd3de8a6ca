"""The port's torch -> flax direction (``torch_state_dict_to_flax``, the
msgpack writer and the convert CLI) against the JAX package's
``torch_state_dict_to_flax`` and ``flax.serialization``.

State dicts come from the port's own modules (built on the meta device for
their keys and shapes), filled with seeded numpy values. The mapping only
moves and transposes arrays, so every dimension but the ViT's width is cut
to at most 3; the ViTs are 12 blocks of width 24. The port's result must
equal JAX's to the bit, key order included, and its bytes flax's.
"""

import os
import subprocess
import sys
import warnings

import flax.serialization
import numpy as np
import pytest
import torch

from test_torch_port import REPO
from test_torch_port import torch_threads  # noqa: F401  (autouse)

import nbdt_torch.serialization as ser
from nbdt_torch.models.convert import torch_state_dict_to_flax

# every family whose torch -> flax direction the JAX package's tests hold
# (tests/test_models.py, test_models_extra.py, test_models_zoo3.py,
# test_convert_specs.py)
ARCHS = ["ResNet18", "ResNet50", "resnet18", "resnet50", "resnext50_32x4d",
         "wide_resnet50_2", "wrn28_10_cifar10", "wrn28_10_cifar100", "efficientnet_b0",
         "efficientnet_b7b", "efficientnet_b3c", "vit_s16", "vit_b16", "squeezenet1_0",
         "squeezenet1_1", "shufflenet_v2_x0_5", "shufflenet_v2_x2_0", "densenet121",
         "densenet161", "mobilenet_v2", "alexnet", "googlenet", "inception_v3", "mnasnet0_5",
         "mnasnet1_3", "vgg11", "vgg16_bn", "vgg19_bn"]


def seeded_state_dict(arch: str, seed: int = 0) -> dict:
    """A state dict of the port's ``arch`` (VGG with torchvision's head),
    seeded numpy values, dimensions cut to 3 (ViTs: width 24)."""
    from nbdt_torch.models import ViT, get_model

    with torch.device("meta"):
        if arch.startswith("vit"):
            model = ViT(dim=24, depth=12, heads={"vit_s16": 6}.get(arch, 12), num_classes=10,
                        image_size=32)
        else:
            kw = {"classic_head": True} if arch.startswith("vgg") else {}
            model = get_model(arch, 10, **kw)
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = v.shape if arch.startswith("vit") else [min(d, 3) for d in v.shape]
        out[k] = (rng.randn(*shape).astype(np.float32) if v.dtype.is_floating_point
                  else np.array(seed, np.int64))
    return out


def assert_same_variables(want, got, path="root"):
    """The same nested dicts, in the same key order, with bit-equal arrays
    of the same dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(want)[:4],
                                                                   list(got)[:4])
        for k in want:
            assert_same_variables(want[k], got[k], f"{path}/{k}")
    else:
        assert isinstance(got, np.ndarray), (path, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def jax_variables(state_dict, arch):
    from nbdt_tpu.models.convert import torch_state_dict_to_flax as jax_convert

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_convert(dict(state_dict), arch=arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_equals_jax_to_the_bit(arch):
    sd = seeded_state_dict(arch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = torch_state_dict_to_flax(sd, arch)
    assert_same_variables(jax_variables(sd, arch), got)
    # torch tensors, wrapped as a training checkpoint under DataParallel's prefix
    wrapped = {"net": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert_same_variables(got, torch_state_dict_to_flax(wrapped, arch))


def test_exporter_grammars_map_alike():
    """The reference's ``shortcut.N``/``linear`` and torchvision's
    ``downsample.N``/``fc`` map onto one flax ResNet, and pytorchcv's WRN
    keys onto the same tree as the JAX exporter's ``init_block.conv`` and
    ``identity_conv.conv``, in both packages."""
    tv = seeded_state_dict("resnet18")
    ref = {k.replace("downsample", "shortcut").replace("fc.", "linear."): v for k, v in tv.items()}
    assert_same_variables(torch_state_dict_to_flax(tv, "resnet18"),
                          torch_state_dict_to_flax(ref, "ResNet18"))
    assert_same_variables(jax_variables(ref, "resnet18"), torch_state_dict_to_flax(ref,
                                                                                  "resnet18"))
    wrn = seeded_state_dict("wrn28_10_cifar10")
    exported = {k.replace("init_block.weight", "init_block.conv.weight")
                .replace("identity_conv.weight", "identity_conv.conv.weight"): v
                for k, v in wrn.items()}
    assert any(".identity_conv.conv.weight" in k for k in exported)
    assert_same_variables(jax_variables(exported, "wrn28_10_cifar10"),
                          torch_state_dict_to_flax(exported, "wrn28_10_cifar10"))
    assert_same_variables(torch_state_dict_to_flax(wrn, "wrn28_10_cifar10"),
                          torch_state_dict_to_flax(exported, "wrn28_10_cifar10"))


@pytest.mark.parametrize("arch", ["googlenet", "inception_v3"])
def test_aux_heads_are_skipped_with_jax_warning(arch):
    sd = seeded_state_dict(arch)
    aux = "aux1.conv.conv.weight" if arch == "googlenet" else "AuxLogits.fc.weight"
    sd[aux] = np.ones((2, 2), np.float32)
    from nbdt_tpu.models.convert import torch_state_dict_to_flax as jax_convert

    messages = []
    for convert in (jax_convert, torch_state_dict_to_flax):
        with pytest.warns(UserWarning, match="transform_input=True") as rec:
            out = convert(dict(sd), arch=arch)
        messages.append(str(rec[0].message))
        assert "aux1" not in out["params"] and "AuxLogits" not in out["params"]
    assert messages[0] == messages[1]


def test_unmapped_and_missing_keys_raise_as_jax():
    from nbdt_tpu.models.convert import torch_state_dict_to_flax as jax_convert

    cases = []
    extra = {**seeded_state_dict("ResNet18"), "head.weight": np.zeros((2, 2), np.float32)}
    cases.append((extra, "ResNet18"))
    vit = seeded_state_dict("vit_s16")
    missing = {k: v for k, v in vit.items() if k != "encoder.ln.bias"}
    cases += [(missing, "vit_s16"), ({**vit, "extra.weight": np.zeros(2, np.float32)},
                                     "vit_s16")]
    for sd, arch in cases:
        errors = []
        for convert in (jax_convert, torch_state_dict_to_flax):
            with pytest.raises(AssertionError) as e:
                convert(dict(sd), arch=arch)
            errors.append(str(e.value))
        assert errors[0] == errors[1], errors


# --- the writer -------------------------------------------------------------


@pytest.mark.parametrize("arch", ["ResNet18", "efficientnet_b0", "vit_s16", "alexnet"])
def test_writer_bytes_equal_flax(arch):
    """``to_bytes`` of the converted variables (alexnet has no batch_stats)
    is ``flax.serialization.to_bytes``'s, and both readers restore it."""
    variables = torch_state_dict_to_flax(seeded_state_dict(arch), arch)
    data = ser.to_bytes(variables)
    assert data == flax.serialization.to_bytes(variables)
    assert_same_variables(variables, flax.serialization.msgpack_restore(data))
    assert_same_variables(variables, ser.msgpack_restore(data))


def test_writer_bytes_equal_flax_on_a_jax_checkpoint():
    """The variables of a flax ResNet10 init as the JAX trainer writes them
    (jax arrays, which flax's writer moves to numpy in place, keeping each
    dict's key order)."""
    import jax

    from nbdt_tpu.models import get_model

    module = get_model("ResNet10", 10)
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), jax.numpy.zeros((1, 8, 8, 3)))

    def numpy_tree(tree):
        return ({k: numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict)
                else np.asarray(tree))

    assert ser.to_bytes(numpy_tree(variables)) == flax.serialization.to_bytes(variables)


def test_writer_chunks_as_flax(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes go out in flax's chunked form, with
    the chunk size read at call time (both sides patched small)."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"w": rng.randn(7, 5).astype(np.float32), "v": {"i": np.arange(40, dtype=np.int16),
                                                          "s": rng.randn(3)},
            "b": rng.randn(200).astype(np.float64)}
    data = ser.to_bytes(tree)
    assert data == flax.serialization.to_bytes(tree)
    assert data.count(b"__msgpack_chunked_array__") == 3
    assert ser.msgpack_serialize(tree) == flax.serialization.msgpack_serialize(tree)
    for restore in (flax.serialization.msgpack_restore, ser.msgpack_restore):
        back = restore(data)
        np.testing.assert_array_equal(back["w"], tree["w"])
        np.testing.assert_array_equal(back["b"], tree["b"])


def test_writer_packs_every_width_as_msgpack():
    """Python and numpy scalars, strings, bytes and containers at each of
    msgpack's widths; lists and tuples as flax's index-keyed state dicts;
    ``msgpack_serialize`` with its keys sorted."""
    tree = {"ints": {str(v): v for v in (0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
                                         2**32, 2**63, -1, -32, -33, -128, -129, -32768,
                                         -32769, -2**31, -2**31 - 1, -2**63)},
            "floats": [1.5, -0.0, float("inf")], "tuple": (1, "a"), "none": None,
            "bools": [True, False], "complex": 1 + 2j,
            "str": {"s0": "", "s31": "x" * 31, "s32": "x" * 32, "s256": "y" * 256,
                    "s65536": "z" * 65536, "utf8": "néœud"},
            "bytes": {"b0": b"", "b256": b"\x01" * 256, "b65536": b"\x02" * 65536},
            "map16": {f"k{i:02d}": i for i in range(20)},
            "np": {"f64": np.float64(2.5), "f32": np.float32(0.5), "i8": np.int8(-3),
                   "b": np.bool_(True), "0d": np.array(4.0), "empty": np.zeros((0, 3))},
            "z": 1, "a": 2}
    assert ser.to_bytes(tree) == flax.serialization.to_bytes(tree)
    flat = {k: v for k, v in tree.items() if k not in ("tuple", "floats", "bools")}
    assert ser.msgpack_serialize(flat) == flax.serialization.msgpack_serialize(flat)
    with pytest.raises(TypeError, match="cannot serialize"):
        ser.to_bytes({"x": object()})


# --- the CLI ----------------------------------------------------------------


def test_cli_round_trips_torch_msgpack_torch(tmp_path, capsys):
    """python -m nbdt_torch.models.convert: a seeded .pth -> .msgpack with
    flax's bytes of JAX's conversion, and back to a .pth whose state dict
    equals the original bit for bit (num_batches_tracked aside: flax has
    none)."""
    from nbdt_tpu.models.convert import torch_state_dict_to_flax as jax_convert
    from nbdt_tpu.models.utils import load_torch_checkpoint

    from nbdt_torch.models import ResNet18
    from nbdt_torch.models.convert import main

    torch.manual_seed(3)
    model = ResNet18(10)
    for b in model.buffers():
        b.copy_(torch.rand_like(b.float()).to(b.dtype) * 2)
    src, mid, back = tmp_path / "a.pth", tmp_path / "b.msgpack", tmp_path / "c.pth"
    torch.save({"net": model.state_dict()}, src)
    main([str(src), "--arch", "ResNet18", "--out", str(mid)])
    main([str(mid), "--arch", "ResNet18", "--out", str(back)])
    assert f"==> Wrote {mid}" in capsys.readouterr().out
    assert mid.read_bytes() == flax.serialization.to_bytes(
        jax_convert(load_torch_checkpoint(str(src)), arch="ResNet18"))
    got = torch.load(back, weights_only=True)["net"]
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with pytest.raises(SystemExit):
        main([str(src), "--arch", "ResNet18", "--out", str(tmp_path / "x.npz")])


BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "nbdt_tpu")


def test_new_modules_run_without_jax_flax_optax_msgpack(tmp_path):
    """Under a ``sys.meta_path`` hook that makes jax, flax, optax, msgpack
    and nbdt_tpu unimportable: every module this slice adds imports, the
    schedule runs, and the convert CLI goes torch -> msgpack -> torch."""
    model = tmp_path / "m.pth"
    from nbdt_torch.models import ResNet10

    torch.manual_seed(0)
    torch.save({"net": ResNet10(10).state_dict()}, model)
    code = f"""
import sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
        return None
sys.meta_path.insert(0, Block())
import nbdt_torch.examples.train_imagenet as ti
import nbdt_torch.examples.load_pretrained, nbdt_torch.examples.vis_demo, nbdt_torch.examples.app
import nbdt_torch.parallel.tp, nbdt_torch.serialization, nbdt_torch.models.convert
from nbdt_torch.utils import format_time, get_directory, get_mean_and_std
from nbdt_torch.hierarchy.wnid import get_wnids_from_dataset
import json
opt = json.load(open({os.path.join(REPO, 'examples/imagenet/configs/resnet18-nbdt.json')!r}))
print(round(ti.build_lr_schedule(opt["optimizer"], 5005, 90)(0), 6),
      len(get_wnids_from_dataset("CIFAR10")))
from nbdt_torch.models.convert import main
main([{str(model)!r}, "--arch", "ResNet10", "--out", {str(tmp_path / 'm.msgpack')!r}])
main([{str(tmp_path / 'm.msgpack')!r}, "--arch", "ResNet10", "--out", {str(tmp_path / 'n.pth')!r}])
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("loaded", loaded)
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "0.1 10" in out.stdout and "loaded []" in out.stdout
    a = torch.load(model, weights_only=True)["net"]
    b = torch.load(tmp_path / "n.pth", weights_only=True)["net"]
    assert all(torch.equal(a[k], b[k]) for k in b) and len(b) == len(a) - sum(
        k.endswith("num_batches_tracked") for k in a)
