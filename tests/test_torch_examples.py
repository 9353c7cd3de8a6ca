"""The port's examples (load_pretrained, vis_demo, the HTTP app) and host
helpers against the JAX package's, on the same seeded checkpoint and image.

The JAX examples are scripts: they are loaded by file path, unedited. The
checkpoint is a seeded ResNet10 ``.pth`` (the port's module with its
BatchNorm statistics drawn too); the image a seeded 40x36 PNG written by
PIL.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import re
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_port import REPO
from test_torch_port import torch_threads  # noqa: F401  (autouse)

C10 = "CIFAR10"


def _load_script(name: str, *parts):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, *parts))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _jax_examples():
    return (_load_script("jax_load_pretrained", "examples", "load_pretrained.py"),
            _load_script("jax_vis_demo", "examples", "vis_demo.py"),
            _load_script("jax_app_api", "examples", "app", "api.py"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A seeded ResNet10 checkpoint for each class count, and a PNG."""
    from PIL import Image

    from nbdt_torch.models import ResNet10

    root = tmp_path_factory.mktemp("examples")
    out = {}
    for n in (10, 200):
        torch.manual_seed(n)
        model = ResNet10(n)
        with torch.no_grad():
            for name, b in model.named_buffers():
                if name.endswith("running_mean"):
                    b.copy_(torch.randn_like(b) * 0.1)
                elif name.endswith("running_var"):
                    b.copy_(torch.rand_like(b) + 0.5)
        out[n] = root / f"resnet10-{n}.pth"
        torch.save({"net": model.state_dict()}, out[n])
    rng = np.random.RandomState(5)
    out["png"] = root / "image.png"
    Image.fromarray(rng.randint(0, 256, (36, 40, 3), dtype=np.uint8)).save(out["png"])
    return out


@pytest.mark.parametrize("dataset,classes", [(C10, 10), ("TinyImagenet200", 200)])
def test_load_pretrained_prints_jax_lines(files, dataset, classes):
    """The prediction and decision lines equal JAX's: CIFAR10 on the
    vendored induced-ResNet10 graph, TinyImagenet200 (no such graph) on the
    tree both induce from the loaded classifier."""
    from nbdt_torch.examples import load_pretrained

    argv = [str(files["png"]), "--arch", "ResNet10", "--dataset", dataset, "--checkpoint",
            str(files[classes])]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _jax_examples()[0].main(argv + ["--platform", "cpu"])
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = load_pretrained.main(argv + ["--device", "cpu"])
    assert got == buf.getvalue().splitlines() == want
    assert want[0].startswith("Prediction: ") and want[1].count("Confidence") >= 2


def test_vis_demo_pages_equal_jax(tmp_path, monkeypatch):
    """Both HTML pages byte for byte (the JAX script reads its graphs by
    paths relative to the repository root)."""
    from nbdt_torch.examples import vis_demo

    monkeypatch.chdir(REPO)
    _jax_examples()[1].main(str(tmp_path / "jax"))
    paths = vis_demo.main(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["graph-induced.html", "graph-wordnet.html"]
    assert sorted(os.path.basename(p) for p in paths) == names
    for name in names:
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
    assert b"n01471682" in (tmp_path / "port" / "graph-wordnet.html").read_bytes()


def _call(handler_cls, method: str, body: bytes = b"", ctype: str = "image/png"):
    """One request through a handler class with no socket: (status, JSON)."""
    handler = handler_cls.__new__(handler_cls)
    handler.rfile, handler.wfile = io.BytesIO(body), io.BytesIO()
    handler.headers = {"Content-Length": str(len(body)), "Content-Type": ctype}
    handler.request_version, handler.command = "HTTP/1.1", method
    handler.requestline, handler.client_address = f"{method} / HTTP/1.1", ("test", 0)
    getattr(handler, f"do_{method}")()
    head, payload = handler.wfile.getvalue().split(b"\r\n\r\n", 1)
    payload = json.loads(payload)
    if "error" in payload:  # an object's repr names its address
        payload["error"] = re.sub(r" at 0x[0-9a-f]+", "", payload["error"])
    return int(head.split()[1]), payload


def _app_args(**kw):
    args = dict(arch="ResNet10", dataset=C10, hierarchy=None, path_graph=None, checkpoint=None,
                hard=False, fold_bn=False, random_init=False)
    args.update(kw)
    return types.SimpleNamespace(**args)


@pytest.mark.parametrize("hard", [False, True])
def test_app_answers_as_jax(files, hard):
    """``build_model`` and ``make_handler`` of both apps on one checkpoint:
    the same JSON for the PNG's bytes, for ``{"url": path}``, for GET, and a
    400 with the same error for bytes that are no image."""
    from nbdt_torch.examples import app

    jax_app = _jax_examples()[2]
    png = files["png"].read_bytes()
    handlers = [jax_app.make_handler(jax_app.build_model(_app_args(checkpoint=str(files[10]),
                                                                   hard=hard))),
                app.make_handler(app.build_model(_app_args(checkpoint=str(files[10]),
                                                           hard=hard, device="cpu")))]
    answers = []
    for h in handlers:
        answers.append([_call(h, "POST", png),
                        _call(h, "POST", json.dumps({"url": str(files["png"])}).encode(),
                              "application/json"),
                        _call(h, "GET"), _call(h, "POST", b"not an image")])
    assert answers[0] == answers[1]
    (code, body), again, _, (bad, err) = answers[1]
    assert code == 200 and again == (code, body) and bad == 400 and "error" in err
    assert body["prediction"] in ("airplane", "automobile", "bird", "cat", "deer", "dog",
                                  "frog", "horse", "ship", "truck")
    assert body["decisions"][0]["prob"] == 1.0 and len(body["decisions"]) >= 3


def test_app_serves_over_a_socket(files):
    """The port's server on a free port of localhost: one POST of the PNG
    answers what the handler answers without a socket."""
    from http.server import ThreadingHTTPServer

    from nbdt_torch.examples import app

    model = app.build_model(_app_args(checkpoint=str(files[10]), device="cpu"))
    handler = app.make_handler(model)
    png = files["png"].read_bytes()
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/", data=png,
                                     headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = (resp.status, json.loads(resp.read()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert got == _call(handler, "POST", png)


def test_app_random_init_and_flags():
    """``--random-init`` serves a seeded backbone on the vendored tree; no
    checkpoint and no ``--random-init`` is refused, as in JAX."""
    from nbdt_torch.examples import app

    model = app.build_model(_app_args(random_init=True, device="cpu"))
    assert model.tree.path_graph.endswith("CIFAR10/graph-induced-ResNet10.json")
    with pytest.raises(SystemExit):
        app.main(["--device", "cpu"])


# --- the host helpers --------------------------------------------------------


def test_format_time_matches_jax():
    from nbdt_tpu.utils import format_time as jax_format_time

    from nbdt_torch.utils import format_time

    for s in (0, 0.0004, 0.25, 1, 59.999, 61.5, 3600, 3661.25, 86400, 86400 + 300, 90061.7,
              10 * 86400 + 7):
        assert format_time(s) == jax_format_time(s), s


def test_get_mean_and_std_matches_jax():
    from nbdt_tpu.data import SyntheticDataset as JSynthetic
    from nbdt_tpu.utils import get_mean_and_std as jax_mean_std

    from nbdt_torch.data import SyntheticDataset
    from nbdt_torch.utils import get_mean_and_std

    for got, want in zip(get_mean_and_std(SyntheticDataset(10, size=12, image_size=8)),
                         jax_mean_std(JSynthetic(10, size=12, image_size=8))):
        np.testing.assert_array_equal(got, want)
    floats = [(np.random.RandomState(i).rand(5, 4, 3).astype(np.float32), 0) for i in range(3)]
    for got, want in zip(get_mean_and_std(floats), jax_mean_std(floats)):
        np.testing.assert_array_equal(got, want)


def test_directories_and_wnids_match_jax(monkeypatch):
    """Given a root, the same paths and wnids; by default the port reads the
    vendored lists wherever it runs from (JAX's defaults are relative to
    the repository root)."""
    from nbdt_tpu.hierarchy.wnid import get_wnids_from_dataset as jax_wnids
    from nbdt_tpu.utils import get_directory as jax_get_directory

    from nbdt_torch.hierarchy.wnid import get_wnids_from_dataset
    from nbdt_torch.utils import get_directory

    root = os.path.join(REPO, "nbdt_tpu", "wnids")
    assert get_directory("CIFAR10", "some/root") == jax_get_directory("CIFAR10", "some/root")
    for dataset in ("CIFAR10", "CIFAR100", "TinyImagenet200", "Imagenet1000"):
        assert get_wnids_from_dataset(dataset, root) == jax_wnids(dataset, root)
    monkeypatch.chdir(REPO)
    assert get_directory("CIFAR10") == os.path.abspath(jax_get_directory("CIFAR10"))
    assert get_wnids_from_dataset("Imagenet1000") == jax_wnids("Imagenet1000")


@pytest.mark.gpu
def test_load_pretrained_on_the_card_matches_the_cpu(tmp_path):
    """On a card, the example's lines equal the CPU's on the same files."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from PIL import Image

    from nbdt_torch.examples import load_pretrained
    from nbdt_torch.models import ResNet10

    torch.manual_seed(10)
    torch.save({"net": ResNet10(10).state_dict()}, tmp_path / "m.pth")
    Image.fromarray(np.random.RandomState(5).randint(0, 256, (36, 40, 3), dtype=np.uint8)).save(
        tmp_path / "x.png")
    argv = [str(tmp_path / "x.png"), "--arch", "ResNet10", "--checkpoint", str(tmp_path / "m.pth")]
    with contextlib.redirect_stdout(io.StringIO()):
        assert load_pretrained.main(argv) == load_pretrained.main(argv + ["--device", "cpu"])
