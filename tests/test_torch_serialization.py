"""The port's reader of flax's .msgpack checkpoints (nbdt_torch.serialization)
against flax.serialization.msgpack_restore on the same bytes, and what reads
through it: state_dict_from_flax, load_checkpoint, the classifier centres
and the flax -> torch conversion CLI."""

import os
import subprocess
import sys

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port import REPO, resnet_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

from nbdt_torch.serialization import msgpack_restore, read_msgpack


def assert_same_tree(want, got, path="root"):
    """Leaf for leaf, dtype for dtype, the same containers and keys in the
    same order; flax's bfloat16 leaves are compared as float32, which is
    what the port reads them as."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        a = np.asarray(want)
        if a.dtype == jnp.bfloat16:
            a = a.astype(np.float32)
        else:
            assert type(got) is type(want), (path, type(want), type(got))
        b = np.asarray(got)
        assert b.dtype == a.dtype and b.shape == a.shape, (path, a.dtype, b.dtype, a.shape)
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, want, got)


@pytest.fixture(scope="module")
def resnet10():
    module, variables, port = resnet_pair("ResNet10")
    return variables, port


def test_reads_a_resnet10_checkpoint_as_flax_does(resnet10):
    variables, _ = resnet10
    data = flax.serialization.to_bytes(variables)
    assert_same_tree(flax.serialization.msgpack_restore(data), msgpack_restore(data))


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int8", "int32", "int64",
                                   "uint8", "uint16", "bool"])
def test_reads_every_numpy_dtype(dtype):
    x = (np.arange(-12, 12) % 7).reshape(2, 3, 4).astype(dtype)
    data = flax.serialization.msgpack_serialize({"x": x, "empty": np.zeros((0, 3), dtype)})
    assert_same_tree(flax.serialization.msgpack_restore(data), msgpack_restore(data))


def test_reads_bfloat16_as_float32():
    x = jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6), jnp.bfloat16)
    data = flax.serialization.msgpack_serialize({"p": {"kernel": x}})
    got = msgpack_restore(data)["p"]["kernel"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x).astype(np.float32))
    assert_same_tree(flax.serialization.msgpack_restore(data), msgpack_restore(data))


@pytest.mark.parametrize("scalar", [np.float32(2.5), np.int64(-7), np.float64(1e300),
                                    np.bool_(True), np.uint8(200)], ids=str)
def test_reads_numpy_scalars(scalar):
    data = flax.serialization.msgpack_serialize({"s": scalar, "nested": {"t": [scalar]}})
    assert_same_tree(flax.serialization.msgpack_restore(data), msgpack_restore(data))


def test_reads_python_values_of_every_wire_width():
    """Ints of every msgpack width and sign, floats, None, bools, str and
    bin of every length class, long lists and maps, a native complex."""
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128,
                 -129, -32768, -32769, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 3.141592653589793, 1e-300],
        "misc": [None, True, False, complex(1.5, -2.0)],
        "strs": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "long_list": list(range(70000)),
        "long_map": {str(i): i for i in range(20)},
    }
    data = flax.serialization.msgpack_serialize(tree)
    assert_same_tree(flax.serialization.msgpack_restore(data), msgpack_restore(data))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_joins_chunked_arrays(monkeypatch, dtype):
    """flax chunks array leaves over MAX_CHUNK_SIZE bytes into marker dicts;
    the reader joins them back, at the top of the tree and nested."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    x = jnp.asarray(np.arange(100, dtype=np.float32).reshape(4, 25), dtype)
    tree = {"params": {"w": x, "small": np.ones(3, np.float32)}, "top": x}
    data = flax.serialization.msgpack_serialize(tree)
    assert_same_tree(flax.serialization.msgpack_restore(data), msgpack_restore(data))
    assert msgpack_restore(data)["params"]["w"].shape == (4, 25)


def test_refuses_truncated_and_trailing_bytes():
    data = flax.serialization.msgpack_serialize({"x": np.arange(10, dtype=np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="after the object"):
        msgpack_restore(data + b"\x00")


def test_reads_without_flax_or_msgpack(tmp_path, resnet10):
    """The reader imports neither flax nor the msgpack package: in a
    process where both imports fail it still reads the checkpoint."""
    variables, _ = resnet10
    path = tmp_path / "ckpt.msgpack"
    path.write_bytes(flax.serialization.to_bytes(variables))
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None; sys.modules['flax'] = None; sys.modules['jax'] = None\n"
        "from nbdt_torch.serialization import read_msgpack\n"
        f"tree = read_msgpack({str(path)!r})\n"
        "print(sorted(tree), tree['params']['linear']['kernel'].shape)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "['batch_stats', 'params'] (512, 10)" in out.stdout


def test_state_dict_from_flax_of_the_read_tree(resnet10, tmp_path):
    """The weights that reach the port through the reader equal those
    converted from the JAX tree directly, and load strictly."""
    from nbdt_torch.models import ResNet10, state_dict_from_flax

    variables, port = resnet10
    path = tmp_path / "ckpt.msgpack"
    path.write_bytes(flax.serialization.to_bytes(variables))
    want = state_dict_from_flax(variables, "ResNet10")
    got = state_dict_from_flax(read_msgpack(path), "ResNet10")
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    ResNet10(10).load_state_dict(got, strict=True)


def test_load_checkpoint_reads_msgpack(resnet10, tmp_path):
    from nbdt_torch.model import load_checkpoint

    variables, port = resnet10
    path = tmp_path / "ckpt.msgpack"
    path.write_bytes(flax.serialization.to_bytes(variables))
    got = load_checkpoint(path, arch="ResNet10")
    want = port.state_dict()
    assert set(got) == {k for k in want if not k.endswith("num_batches_tracked")}
    for k, v in got.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="arch="):
        load_checkpoint(path)


@pytest.mark.parametrize("arch,img", [("ResNet10", 32), ("squeezenet1_1", 64)])
def test_centers_from_msgpack_match_jax(tmp_path, arch, img):
    """get_centers_from_checkpoint on the JAX package's .msgpack equals the
    JAX package's own reading, a Dense head and SqueezeNet's 1x1 conv."""
    import jax

    from nbdt_tpu.hierarchy.generate import get_centers_from_checkpoint as jcenters
    from nbdt_tpu.models import get_model

    from nbdt_torch.hierarchy.generate import get_centers_from_checkpoint

    module = get_model(arch, 10)
    variables = jax.jit(module.init)(jax.random.PRNGKey(3), jnp.zeros((1, img, img, 3)))
    path = tmp_path / f"{arch}.msgpack"
    path.write_bytes(flax.serialization.to_bytes(variables))
    want = jcenters(str(path))
    got = get_centers_from_checkpoint(str(path))
    assert got.shape == want.shape == (10, want.shape[1])
    np.testing.assert_array_equal(got, want)


def test_convert_cli_writes_a_strict_pth(resnet10, tmp_path, capsys):
    """python -m nbdt_torch.models.convert: a .msgpack in, a .pth out that
    the port's module loads strictly; the torch -> flax direction writes
    that .pth back as flax's bytes of the JAX package's conversion."""
    from nbdt_torch.model import load_checkpoint
    from nbdt_torch.models import ResNet10
    from nbdt_torch.models.convert import main

    variables, port = resnet10
    src = tmp_path / "ckpt.msgpack"
    src.write_bytes(flax.serialization.to_bytes(variables))
    out = tmp_path / "ckpt.pth"
    main([str(src), "--arch", "ResNet10", "--out", str(out)])
    assert f"==> Wrote {out}" in capsys.readouterr().out
    fresh = ResNet10(10)
    fresh.load_state_dict(load_checkpoint(out), strict=True)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    from nbdt_tpu.models.convert import torch_state_dict_to_flax
    from nbdt_tpu.models.utils import load_torch_checkpoint

    main([str(out), "--arch", "ResNet10", "--out", str(tmp_path / "back.msgpack")])
    assert (tmp_path / "back.msgpack").read_bytes() == flax.serialization.to_bytes(
        torch_state_dict_to_flax(load_torch_checkpoint(str(out)), arch="ResNet10"))
