"""The port's notebook walkthrough, ``nbdt_torch/examples/load_pretrained_nbdts.ipynb``,
against the JAX package's ``examples/load_pretrained_nbdts.ipynb``, cell for
cell, on the CPU.

Both notebooks run once, in this process, on one seeded ResNet18 ``.pth``
(``NBDT_CHECKPOINT``; the port's module with its BatchNorm statistics drawn
too) and one seeded 32x32 PNG (``NBDT_IMAGE``), the port's with
``NBDT_DEVICE=cpu``. They must print the same lines, make the same soft and
hard predictions through the same decision nodes, and give each step's
probability within 1e-4 (f32 on both sides; the backbones' convolutions sum
in another order)."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from test_torch_port import REPO
from test_torch_port import torch_threads  # noqa: F401  (autouse)

JAX_NB = os.path.join(REPO, "examples", "load_pretrained_nbdts.ipynb")
PORT_NB = os.path.join(REPO, "nbdt_torch", "examples", "load_pretrained_nbdts.ipynb")
NUMBER = re.compile(r"-?\d+\.\d+")


def _cells(path, kind="code"):
    with open(path) as f:
        return ["".join(c["source"]) for c in json.load(f)["cells"] if c["cell_type"] == kind]


def _execute(path, env, monkeypatch):
    """Run a notebook's code cells in one namespace under ``env``; return the
    namespace and the lines it printed."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ns, buf = {}, io.StringIO()
    with contextlib.redirect_stdout(buf):
        exec(compile("\n\n".join(_cells(path)), path, "exec"), ns)
    return ns, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from PIL import Image

    from nbdt_torch.models import ResNet18

    root = tmp_path_factory.mktemp("notebook")
    torch.manual_seed(18)
    model = ResNet18(10)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn_like(b) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand_like(b) + 0.5)
    torch.save({"net": model.state_dict()}, root / "resnet18.pth")
    Image.fromarray(np.random.RandomState(16).randint(0, 256, (32, 32, 3), dtype=np.uint8)).save(
        root / "image.png")
    env = {"NBDT_CHECKPOINT": str(root / "resnet18.pth"), "NBDT_IMAGE": str(root / "image.png")}
    with pytest.MonkeyPatch.context() as mp:
        jax_run = _execute(JAX_NB, {**env, "NBDT_PLATFORM": "cpu"}, mp)
    with pytest.MonkeyPatch.context() as mp:
        port_run = _execute(PORT_NB, {**env, "NBDT_DEVICE": "cpu"}, mp)
    return {"jax": jax_run, "port": port_run}


def test_cells_match_jax_one_for_one():
    """The same cells in the same order: each code cell opens with the same
    numbered step, and the markdown cells frame them alike."""
    steps = [[re.match(r"# (\d)\.", c).group(1) for c in _cells(p)] for p in (JAX_NB, PORT_NB)]
    assert steps[0] == steps[1] == ["1", "2", "3", "4", "5", "6"]
    assert len(_cells(JAX_NB, "markdown")) == len(_cells(PORT_NB, "markdown"))
    assert not any("nbdt_tpu" in c or "jax" in c for c in _cells(PORT_NB))


@pytest.mark.parametrize("part", ["soft", "hard"])
def test_predictions_equal_jax(runs, part):
    (jns, _), (tns, _) = runs["jax"], runs["port"]
    key = "outputs" if part == "soft" else "h_out"
    want = int(np.asarray(jns[key]).argmax(-1)[0])
    assert int(tns[key].argmax(-1)[0]) == want
    assert tns["model"].tree.classes == jns["model"].tree.classes
    assert tns["model"].tree.classes[3] == "cat"


@pytest.mark.parametrize("part", ["soft", "hard"])
def test_decisions_equal_jax(runs, part):
    (jns, _), (tns, _) = runs["jax"], runs["port"]
    key = "decisions" if part == "soft" else "h_dec"
    want, got = jns[key][0], tns[key][0]
    assert [s["name"] for s in got] == [s["name"] for s in want] and len(got) >= 2
    for g, w in zip(got, want):
        assert abs(float(g["prob"]) - float(w["prob"])) <= 1e-4, (g, w)
        if "entropy" in w:
            assert abs(float(g["entropy"]) - float(w["entropy"])) <= 1e-4, (g, w)


def test_printed_lines_equal_jax(runs):
    """The same lines; their numbers (4-digit probabilities, 2-digit
    percentages) within one unit of their last printed digit."""
    want, got = runs["jax"][1], runs["port"][1]
    assert [NUMBER.sub("#", line) for line in got] == [NUMBER.sub("#", line) for line in want]
    assert got[0].startswith("classes: ") and got[1].startswith("Prediction: ")
    assert got[-2].startswith("Hard prediction: ") and got[-1].startswith("Path: ")
    for g, w in zip(got, want):
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            assert abs(float(a) - float(b)) <= 10.0 ** -len(b.split(".")[1]), (g, w)


def test_default_device_is_the_card(monkeypatch):
    """Without ``NBDT_DEVICE`` the walkthrough asks for the card: on a
    machine without one it raises instead of running on the CPU."""
    monkeypatch.delenv("NBDT_DEVICE", raising=False)
    monkeypatch.delenv("NBDT_CHECKPOINT", raising=False)
    ns = {}
    setup, build = _cells(PORT_NB)[:2]
    exec(compile(setup, PORT_NB, "exec"), ns)
    assert ns["DEVICE"] == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        exec(compile(build, PORT_NB, "exec"), ns)
