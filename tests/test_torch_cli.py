"""The port's single-image CLIs (nbdt, original), its export CLI and its
released-checkpoint resolution, against the JAX package's on the same
.msgpack weights (JAX's init, perturbed BatchNorms, flax's to_bytes), the
same PIL-written PNG and the same checkpoint cache. Nothing is fetched: the
download is monkeypatched to fail wherever a lookup could reach it."""

import re

import flax.serialization
import numpy as np
import pytest
import torch

from test_torch_port import resnet_pair
from test_torch_port import torch_threads  # noqa: F401  (autouse)

IMG = 32


@pytest.fixture(scope="module", params=["ResNet10", "ResNet18"])
def weights(request, tmp_path_factory):
    """(arch, JAX module, variables, port module, .msgpack path, .pth path
    written by the JAX converter, PNG path)."""
    from PIL import Image

    from nbdt_tpu.models.convert import main as jconvert

    arch = request.param
    module, variables, port = resnet_pair(arch, img=IMG)
    root = tmp_path_factory.mktemp(arch)
    msgpack = root / f"{arch}.msgpack"
    msgpack.write_bytes(flax.serialization.to_bytes(variables))
    pth = root / f"{arch}.pth"
    jconvert([str(msgpack), "--arch", arch, "--out", str(pth)])
    pixels = np.random.RandomState(7).randint(0, 256, (40, 48, 3), dtype=np.uint8)
    png = root / "image.png"
    Image.fromarray(pixels).save(png)
    return arch, module, variables, port, msgpack, pth, png


@pytest.fixture()
def no_download(monkeypatch):
    """Both packages' downloads fail, as they do offline."""
    import nbdt_tpu.models.utils as jutils

    import nbdt_torch.models.utils as tutils

    def offline(url, dest):
        raise OSError(f"no network for {url}")

    monkeypatch.setattr(jutils, "download_checkpoint", offline)
    monkeypatch.setattr(tutils, "download_checkpoint", offline)


def parse_decision_line(text: str):
    """(prediction, [(decision name, confidence %)]) of the CLI's line."""
    (line,) = [ln for ln in text.splitlines() if ln.startswith("Prediction:")]
    pred, _, rest = line[len("Prediction: "):].partition(" // Decisions: ")
    steps = re.findall(r"(.+?) \(Confidence: (-?[\d.]+)%\)(?:, |$)", rest)
    return pred, [(name, float(conf)) for name, conf in steps]


def assert_same_decisions(jax_out: str, torch_out: str):
    jpred, jsteps = parse_decision_line(jax_out)
    tpred, tsteps = parse_decision_line(torch_out)
    assert tpred == jpred
    assert [n for n, _ in tsteps] == [n for n, _ in jsteps] and len(tsteps) > 1
    # 0.01 percentage points, plus one unit of the printed rounding
    np.testing.assert_allclose([c for _, c in tsteps], [c for _, c in jsteps], rtol=0,
                               atol=0.01 + 1e-9)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_nbdt_cli_matches_jax(weights, hard, capsys):
    from nbdt_tpu.bin.nbdt import main as jmain

    from nbdt_torch.bin.nbdt import main as tmain

    arch, _, _, _, msgpack, _, png = weights
    argv = [str(png), "--arch", arch, "--dataset", "CIFAR10", "--checkpoint", str(msgpack)]
    argv += ["--hard"] * hard
    jmain(argv + ["--platform", "cpu"])
    jax_out = capsys.readouterr().out
    tmain(argv + ["--device", "cpu"])
    assert_same_decisions(jax_out, capsys.readouterr().out)


def test_nbdt_cli_pth_and_msgpack_agree(weights, capsys):
    """The same weights as the JAX converter's .pth and as .msgpack give
    the port's CLI one line."""
    from nbdt_torch.bin.nbdt import main

    arch, _, _, _, msgpack, pth, png = weights
    lines = []
    for ckpt in (msgpack, pth):
        main([str(png), "--arch", arch, "--checkpoint", str(ckpt), "--device", "cpu"])
        lines.append(capsys.readouterr().out)
    assert_same_decisions(*lines)


def test_preprocess_matches_jax(weights):
    from nbdt_tpu.bin.nbdt import preprocess as jpreprocess
    from nbdt_tpu.utils import load_image_from_path as jload

    from nbdt_torch.bin.nbdt import preprocess
    from nbdt_torch.utils import load_image_from_path

    png = weights[-1]
    got = preprocess(load_image_from_path(str(png)))
    want = jpreprocess(jload(str(png)))
    assert got.shape == (1, IMG, IMG, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_original_cli_matches_jax(weights, capsys):
    """nbdt-original: the JAX CLI on the converter's .pth, the port's on the
    .msgpack and on the .pth, one prediction."""
    from nbdt_tpu.bin.original import main as jmain

    from nbdt_torch.bin.original import main as tmain

    arch, _, _, _, msgpack, pth, png = weights
    base = [str(png), "--arch", arch, "--dataset", "CIFAR10"]
    jmain(base + ["--checkpoint", str(pth), "--platform", "cpu"])
    want = capsys.readouterr().out.strip()
    assert want.startswith("Prediction: ")
    for ckpt in (msgpack, pth):
        tmain(base + ["--checkpoint", str(ckpt), "--device", "cpu"])
        assert capsys.readouterr().out.strip() == want
    with pytest.raises(SystemExit):
        tmain(base + ["--device", "cpu"])


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "uint8"])
def test_export_cli_matches_jax(weights, tmp_path, capsys, u8):
    """nbdt-export of the same .msgpack in both packages: the port's
    artifact equals the port's serving function on the vendored tree and
    matches the JAX artifact."""
    import jax.numpy as jnp

    from nbdt_tpu.bin.nbdt_export import main as jexport
    from nbdt_tpu.serving import load_serving as jload

    from nbdt_torch.bin.nbdt_export import main as texport
    from nbdt_torch.serving import load_serving, make_serving_fn
    from nbdt_torch.tree import Tree

    arch, _, _, port, msgpack, _, _ = weights
    flags = ["--arch", arch, "--dataset", "CIFAR10", "--checkpoint", str(msgpack), "--f32"]
    flags += ["--uint8-input"] * u8
    jpath, tpath = str(tmp_path / "jax.stablehlo"), str(tmp_path / "torch.pt2")
    jexport(flags + ["--out", jpath, "--platforms", "cpu", "--platform", "cpu"])
    texport(flags + ["--out", tpath, "--device", "cpu"])
    out = capsys.readouterr().out
    assert (f"==> Exported {arch}/CIFAR10 serving artifact to {tpath} (" in out
            and "device=cpu, input [b,32,32,3])" in out)
    rng = np.random.RandomState(8)
    x = (rng.randint(0, 256, (6, IMG, IMG, 3)).astype(np.uint8) if u8
         else rng.randn(6, IMG, IMG, 3).astype(np.float32))
    got = load_serving(tpath, device="cpu")(x)
    hierarchy = f"induced-{arch}"
    live = make_serving_fn(port, Tree("CIFAR10", hierarchy=hierarchy), bf16=False,
                           uint8_input=u8, device="cpu")
    torch.testing.assert_close(got, live(x), rtol=0, atol=0)
    want = np.asarray(jload(jpath)(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))


def test_export_cli_random_init(tmp_path, capsys):
    """nbdt-export end to end without weights: CLI -> artifact -> load ->
    serve, at the given image size; --uint8-input exits where the dataset
    has no normalization constants."""
    from nbdt_torch.bin.nbdt_export import main
    from nbdt_torch.serving import load_serving

    out = str(tmp_path / "cli.pt2")
    main(["--arch", "ResNet10", "--dataset", "CIFAR10", "--random-init", "--out", out,
          "--image-size", "16", "--f32", "--device", "cpu"])
    assert "input [b,16,16,3]" in capsys.readouterr().out
    got = load_serving(out, device="cpu")(torch.zeros(3, 16, 16, 3))
    assert got.shape == (3, 10) and bool(torch.isfinite(got).all())
    with pytest.raises(SystemExit, match="no normalization constants for Cityscapes"):
        main(["--arch", "ResNet10", "--dataset", "Cityscapes", "--random-init", "--out", out,
              "--uint8-input", "--device", "cpu"])


def test_nbdt_cli_flags(tmp_path, weights, capsys):
    """--random-init runs offline and prints the decision line;
    --random-init with --checkpoint is refused, as in JAX."""
    from nbdt_torch.bin.nbdt import main
    from nbdt_torch.tree import Tree
    from nbdt_torch.utils import DATASET_TO_CLASSES

    arch, _, _, _, msgpack, _, png = weights
    main([str(png), "--arch", arch, "--random-init", "--device", "cpu"])
    pred, steps = parse_decision_line(capsys.readouterr().out)
    assert pred in DATASET_TO_CLASSES["CIFAR10"] and len(steps) > 1
    assert steps[0][0] == Tree("CIFAR10", hierarchy=f"induced-{arch}").root.name
    with pytest.raises(SystemExit):
        main([str(png), "--random-init", "--checkpoint", str(msgpack), "--device", "cpu"])


def test_load_image_without_pil_names_it(monkeypatch, weights):
    import sys

    from nbdt_torch.utils import load_image_from_path

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        load_image_from_path(str(weights[-1]))


# ---------------------------------------------------------------------------
# Released checkpoints: tables, cache, resolution
# ---------------------------------------------------------------------------


def test_url_tables_match_jax():
    import nbdt_tpu
    from nbdt_tpu.models import resnet as jresnet
    from nbdt_tpu.models import wideresnet as jwrn

    import nbdt_torch
    from nbdt_torch.models import resnet, wideresnet

    assert nbdt_torch.model_urls == nbdt_tpu.model_urls
    assert resnet.model_urls == jresnet.model_urls
    assert wideresnet.model_urls == jwrn.model_urls


@pytest.mark.parametrize("wrap", ["bare", "net", "state_dict", "net-module", "module"])
def test_coerce_state_dict_matches_jax(wrap):
    from nbdt_tpu.models.utils import coerce_state_dict as jcoerce

    from nbdt_torch.models.utils import coerce_state_dict

    sd = {"linear.weight": np.ones((2, 3)), "bn1.running_mean": np.zeros(3)}
    if "module" in wrap:
        sd = {f"module.{k}": v for k, v in sd.items()}
    data = {"bare": sd, "module": sd, "net": {"net": sd, "acc": 1.0},
            "state_dict": {"state_dict": sd}, "net-module": {"net": sd}}[wrap]
    got, want = coerce_state_dict(data), jcoerce(data)
    assert list(got) == list(want) == ["linear.weight", "bn1.running_mean"]
    assert all(got[k] is want[k] for k in want)


def _place(cache, name, sd):
    cache.mkdir(parents=True, exist_ok=True)
    torch.save({"net": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3}, cache / name)


def test_load_state_dict_from_key_matches_jax(tmp_path, monkeypatch, no_download):
    """The last key a table holds wins; a cached file is read, never
    fetched; both packages read the same tensors."""
    from nbdt_tpu.models.utils import checkpoint_cache_dir as jcache
    from nbdt_tpu.models.utils import load_state_dict_from_key as jload

    from nbdt_torch.models.utils import checkpoint_cache_dir, load_state_dict_from_key

    monkeypatch.setenv("NBDT_CHECKPOINT_DIR", str(tmp_path / "cache"))
    assert checkpoint_cache_dir() == jcache() == tmp_path / "cache"
    table = {("A", "D"): "https://example.invalid/0.0.1/a.pth",
             ("A", "D", "h"): "https://example.invalid/0.0.1/b.pth"}
    _place(tmp_path / "cache", "a.pth", {"w": torch.zeros(2)})
    _place(tmp_path / "cache", "b.pth", {"w": torch.ones(2)})
    for keys, value in (([("A", "D")], 0.0), ([("A", "D"), ("A", "D", "h")], 1.0),
                        ([("A", "D"), ("A", "D", None)], 0.0)):
        got, want = load_state_dict_from_key(keys, table), jload(keys, table)
        assert list(got) == list(want) == ["w"]
        np.testing.assert_array_equal(got["w"].numpy(), want["w"])
        assert float(got["w"][0]) == value
    path = tmp_path / "local.pth"
    _place(tmp_path, "local.pth", {"w": torch.full((2,), 5.0)})
    got = load_state_dict_from_key([("X", "Y")], table, checkpoint_path=str(path))
    assert float(got["w"][0]) == 5.0


def test_missing_checkpoint_raises_jax_message(tmp_path, monkeypatch, no_download):
    from nbdt_tpu.models.utils import load_state_dict_from_key as jload

    from nbdt_torch.models.utils import load_state_dict_from_key

    monkeypatch.setenv("NBDT_CHECKPOINT_DIR", str(tmp_path / "cache"))
    table = {("A", "D"): "https://example.invalid/0.0.1/a.pth"}
    messages = []
    for load in (jload, load_state_dict_from_key):
        with pytest.raises(RuntimeError) as err:
            load([("A", "D")], table)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert f"Place the file at {tmp_path / 'cache' / 'a.pth'}" in messages[1]
    for load in (jload, load_state_dict_from_key):
        with pytest.raises(KeyError, match="No pretrained checkpoint"):
            load([("B", "D")], table)


def test_pretrained_nbdt_resolves_through_the_cache(tmp_path, monkeypatch, no_download):
    """SoftNBDT(pretrained=True) with no path reads the released ResNet18
    file from NBDT_CHECKPOINT_DIR in both packages, with the same output."""
    from nbdt_tpu.model import SoftNBDT as JSoftNBDT
    from nbdt_tpu.models import get_model as jget_model

    from nbdt_torch import SoftNBDT, model_urls
    from nbdt_torch.models import ResNet18

    _, variables, port = resnet_pair("ResNet18", img=IMG)
    monkeypatch.setenv("NBDT_CHECKPOINT_DIR", str(tmp_path))
    name = model_urls[("ResNet18", "CIFAR10")].rsplit("/", 1)[-1]
    _place(tmp_path, name, port.state_dict())
    x = np.random.RandomState(9).randn(3, IMG, IMG, 3).astype(np.float32)
    got = SoftNBDT("CIFAR10", ResNet18(10), arch="ResNet18", pretrained=True, device="cpu")(x)
    want = JSoftNBDT("CIFAR10", jget_model("ResNet18", 10), arch="ResNet18", pretrained=True)(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got, SoftNBDT("CIFAR10", port, arch="ResNet18", device="cpu")(x))


def test_nbdt_cli_reads_the_cached_release(weights, tmp_path, monkeypatch, no_download,
                                           capsys):
    """Without --checkpoint both CLIs read the released file of (arch,
    CIFAR10) from the cache, when the table has one."""
    from nbdt_tpu.bin.nbdt import main as jmain

    from nbdt_torch import model_urls
    from nbdt_torch.bin.nbdt import main as tmain

    arch, _, _, port, _, _, png = weights
    argv = [str(png), "--arch", arch]
    monkeypatch.setenv("NBDT_CHECKPOINT_DIR", str(tmp_path))
    if (arch, "CIFAR10") not in model_urls:
        with pytest.raises(KeyError, match="No pretrained checkpoint"):
            tmain(argv + ["--device", "cpu"])
        return
    _place(tmp_path, model_urls[(arch, "CIFAR10")].rsplit("/", 1)[-1], port.state_dict())
    jmain(argv + ["--platform", "cpu"])
    jax_out = capsys.readouterr().out
    tmain(argv + ["--device", "cpu"])
    assert_same_decisions(jax_out, capsys.readouterr().out)


@pytest.mark.parametrize("hierarchy", [None, "induced-ResNet18"])
def test_main_pretrained_resolves_through_the_tables(tmp_path, monkeypatch, no_download,
                                                     capsys, hierarchy):
    """python -m nbdt_torch.main --pretrained --eval: the (arch, dataset)
    key of the merged tables names the plain backbone's release, as the JAX
    CLI's tables do; the file comes from the cache."""
    from nbdt_tpu.model import model_urls as jnbdt
    from nbdt_tpu.models import resnet as jresnet
    from nbdt_tpu.models import wideresnet as jwrn

    from nbdt_torch.main import main
    from nbdt_torch.models import ResNet18

    jtable = {**jnbdt, **jwrn.model_urls, **jresnet.model_urls}
    keys = [("ResNet18", "CIFAR10"), ("ResNet18", "CIFAR10", hierarchy)]
    name = jtable[[k for k in keys if k in jtable][-1]].rsplit("/", 1)[-1]
    assert name == "ckpt-CIFAR10-ResNet18.pth"
    torch.manual_seed(1)
    _place(tmp_path / "cache", name, ResNet18(10).state_dict())
    monkeypatch.setenv("NBDT_CHECKPOINT_DIR", str(tmp_path / "cache"))
    argv = ["--pretrained", "--eval", "--synthetic", "--device", "cpu", "--arch", "ResNet18",
            "--batch-size", "4", "--checkpoint-dir", str(tmp_path), "--no-progress"]
    argv += ["--hierarchy", hierarchy] if hierarchy else []
    acc = main(argv)
    assert 0 <= acc <= 100
    assert f"Loaded pretrained weights for ResNet18/CIFAR10 from {tmp_path / 'cache' / name}" \
        in capsys.readouterr().out


def test_main_checkpoint_path_takes_msgpack(weights, tmp_path, capsys):
    """--checkpoint-path wins over the tables and takes the JAX package's
    .msgpack."""
    from nbdt_torch.main import main

    arch, _, _, _, msgpack, _, _ = weights
    acc = main(["--pretrained", "--checkpoint-path", str(msgpack), "--eval", "--synthetic",
                "--device", "cpu", "--arch", arch, "--batch-size", "4",
                "--checkpoint-dir", str(tmp_path), "--no-progress"])
    assert 0 <= acc <= 100
    assert f"from {msgpack}" in capsys.readouterr().out


def test_hierarchy_cli_induces_from_msgpack_as_jax(weights, tmp_path):
    """nbdt_hierarchy --checkpoint x.msgpack: the port induces the graph the
    JAX CLI induces from the same file, byte for byte."""
    from nbdt_tpu.bin.nbdt_hierarchy import main as jmain

    from nbdt_torch.bin.nbdt_hierarchy import main as tmain

    msgpack = weights[4]
    for pkg, main, extra in (("jax", jmain, ["--platform", "cpu"]),
                             ("torch", tmain, ["--device", "cpu"])):
        main(["--dataset", "CIFAR10", "--method", "induced", "--checkpoint", str(msgpack),
              "--hierarchies-root", str(tmp_path / pkg), "--no-vis", *extra])
    (jgraph,) = (tmp_path / "jax").rglob("*.json")
    (tgraph,) = (tmp_path / "torch").rglob("*.json")
    assert jgraph.name == tgraph.name
    assert tgraph.read_bytes() == jgraph.read_bytes()
