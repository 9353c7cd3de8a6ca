"""``nbdt_torch.tools.verify_release`` (the port's released-checkpoint parity
harness) on the CPU: the cases of ``tests/test_verify_release.py`` on the
port's tool, then the two tools against each other on one staged
reference-format ``.pth`` (a seeded ResNet10 through the JAX exporter) and
one seeded synthetic val set: equal top-1s, transcripts each tool accepts
from the other with no mismatch, step probabilities and entropies within
1e-5, the same report keys and stdout lines, the ``.msgpack`` of the same
weights giving the same report, and the tool running with jax, flax and
nbdt_tpu unimportable."""

import contextlib
import io
import json
import math
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbdt_torch.tools import verify_release as port_tool
from test_torch_port import torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

# The JAX tests' val set: ResNet10 at 32px, 96 images in batches of 48
BASE = ["--arch", "ResNet10", "--dataset", "CIFAR10", "--val", "synthetic",
        "--synthetic-size", "96", "--batch-size", "48",
        "--transcript-n", "8"]
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """(.pth, .msgpack) of one seeded ResNet10: the .pth in the reference's
    layout ({net: module.-prefixed state dict, acc, epoch}) from the JAX
    exporter, as ``tests/test_verify_release.py`` stages it, and flax's
    bytes of the same variables."""
    import flax.serialization

    from nbdt_tpu.models import init_model
    from nbdt_tpu.models.convert import flax_to_torch_state_dict

    _, variables = init_model("ResNet10", 10, (32, 32, 3), seed=3)
    sd = flax_to_torch_state_dict(variables, arch="ResNet10")
    root = tmp_path_factory.mktemp("release")
    pth = root / "ckpt-CIFAR10-ResNet10.pth"
    torch.save({"net": {f"module.{k}": torch.tensor(np.asarray(v)) for k, v in sd.items()},
                "acc": 12.3, "epoch": 0}, pth)
    msgpack = root / "ckpt-CIFAR10-ResNet10.msgpack"
    msgpack.write_bytes(flax.serialization.to_bytes(variables))
    return str(pth), str(msgpack)


def run_port(argv):
    """(exit code, stdout) of the port's tool on the CPU."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = port_tool.main([*argv, "--device", "cpu"])
    return rc, buf.getvalue()


def run_jax(argv):
    """(exit code, stdout) of ``tools/verify_release.py``."""
    import verify_release as jax_tool

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jax_tool.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def reports(staged, tmp_path_factory):
    """Each tool's report-only run on the staged .pth, written to the same
    path one after the other: {"jax"|"port": (exit code, stdout, report,
    its own copy's path)}."""
    root = tmp_path_factory.mktemp("reports")
    out = root / "report.json"
    runs = {}
    for name, run in (("jax", run_jax), ("port", run_port)):
        rc, text = run(["--checkpoint", staged[0], *BASE, "--report-out", str(out)])
        copy = root / f"{name}.json"
        copy.write_text(out.read_text())
        runs[name] = (rc, text, json.loads(out.read_text()), str(copy))
    return runs


# -- the JAX file's cases on the port's tool ---------------------------------


def test_report_only_run(staged, tmp_path):
    """No expected value and no reference transcript: report-only, exit 0,
    all three top-1s and the transcript present."""
    out = tmp_path / "report.json"
    rc, text = run_port(["--checkpoint", staged[0], *BASE, "--report-out", str(out)])
    assert rc == 0 and text.rstrip().endswith("report only)")
    report = json.loads(out.read_text())
    for k in ("backbone_top1", "nbdt_soft_top1", "nbdt_hard_top1"):
        assert 0.0 <= report[k] <= 100.0
    assert report["pass"] is None and report["n_val"] == 96
    assert len(report["transcript"]) == 8
    first = report["transcript"][0]["path"]
    assert len(first) >= 2  # root decision + leaf at minimum
    assert all("prob" in step and "name" in step for step in first)


def test_verdict_pass_and_transcript_selfdiff(staged, reports, tmp_path):
    """Measured top-1 vs itself passes; the transcript diffed against the
    tool's own prior output has zero mismatches."""
    _, _, first, path = reports["port"]
    out = tmp_path / "r2.json"
    rc, text = run_port(["--checkpoint", staged[0], *BASE,
                         "--expected-top1", str(first["nbdt_soft_top1"]), "--tolerance", "0.2",
                         "--reference-transcript", path, "--report-out", str(out)])
    assert rc == 0 and text.rstrip().endswith("PASS")
    report = json.loads(out.read_text())
    assert report["pass"] is True
    assert report["transcript_mismatches"] == []
    assert report["top1_delta"] == 0.0


def test_verdict_fails_on_accuracy_gap(staged, reports):
    measured = reports["port"][2]["nbdt_soft_top1"]
    rc, text = run_port(["--checkpoint", staged[0], *BASE,
                         "--expected-top1", str(measured + 5.0), "--tolerance", "0.2"])
    assert rc == 1
    assert "-> MISMATCH" in text and text.rstrip().endswith("FAIL")


def test_val_real_branch_runs_on_staged_pickle(staged, tmp_path):
    """The --val real branch on a small CIFAR10 test_batch in the loader's
    pickle format: --val real defaults expected_top1 to the published
    table, so random weights FAIL against 97.55; the JAX tool reports the
    same numbers on the same files. A root with nothing staged exits with
    the actionable message."""
    base = tmp_path / "data" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    rng = np.random.RandomState(0)
    n = 50
    with open(base / "test_batch", "wb") as fh:
        pickle.dump({"data": rng.randint(0, 256, size=(n, 3072)).astype(np.uint8),
                     "labels": (np.arange(n) % 10).tolist()}, fh)

    argv = ["--checkpoint", staged[0], "--arch", "ResNet10", "--dataset", "CIFAR10",
            "--val", "real", "--dataset-root", str(tmp_path / "data"),
            "--batch-size", "25", "--transcript-n", "4"]
    rc, _ = run_port([*argv, "--report-out", str(tmp_path / "real.json")])
    report = json.loads((tmp_path / "real.json").read_text())
    assert report["val"] == "real" and report["n_val"] == n
    assert report["expected_top1"] == 97.55  # README table default kicks in
    assert rc == 1 and report["pass"] is False  # random init != released
    assert len(report["transcript"]) == 4
    jrc, _ = run_jax([*argv, "--report-out", str(tmp_path / "jax.json")])
    jreport = json.loads((tmp_path / "jax.json").read_text())
    assert jrc == rc
    for k in ("backbone_top1", "nbdt_soft_top1", "nbdt_hard_top1", "top1_delta"):
        assert report[k] == jreport[k], k

    with pytest.raises(SystemExit, match="No staged"):
        run_port(["--checkpoint", staged[0], "--arch", "ResNet10", "--dataset", "CIFAR10",
                  "--val", "real", "--dataset-root", str(tmp_path / "nowhere")])


def test_verdict_fails_on_decision_path_divergence(staged, reports, tmp_path):
    """A reference transcript with one wnid swapped flags that image and
    fails."""
    report = json.loads(json.dumps(reports["port"][2]))
    report["transcript"][3]["path"][0]["wnid"] = "n00000000"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(report))
    out = tmp_path / "r2.json"
    rc, text = run_port(["--checkpoint", staged[0], *BASE,
                         "--reference-transcript", str(bad), "--report-out", str(out)])
    assert rc == 1
    assert json.loads(out.read_text())["transcript_mismatches"] == [3]
    assert "MISMATCH: [3]" in text


# -- the two tools against each other ----------------------------------------


def test_top1s_equal_jax(reports):
    (jrc, _, jax_report, _), (prc, _, port_report, _) = reports["jax"], reports["port"]
    assert jrc == prc == 0
    for k in ("n_val", "backbone_top1", "nbdt_soft_top1", "nbdt_hard_top1"):
        assert port_report[k] == jax_report[k], k


def test_transcripts_accepted_both_ways(staged, reports, tmp_path):
    """The JAX report as the port's --reference-transcript, and the port's
    as JAX's: 0 mismatches either way, with the predictions and labels of
    every entry equal."""
    jax_path, port_path = reports["jax"][3], reports["port"][3]
    out = tmp_path / "p.json"
    rc, text = run_port(["--checkpoint", staged[0], *BASE, "--reference-transcript", jax_path,
                         "--report-out", str(out)])
    assert rc == 0 and json.loads(out.read_text())["transcript_mismatches"] == []
    assert "decision paths: 8 compared, 0 mismatched -> OK" in text
    out = tmp_path / "j.json"
    rc, text = run_jax(["--checkpoint", staged[0], *BASE, "--reference-transcript", port_path,
                        "--report-out", str(out)])
    assert rc == 0 and json.loads(out.read_text())["transcript_mismatches"] == []
    assert "decision paths: 8 compared, 0 mismatched -> OK" in text
    for a, b in zip(reports["port"][2]["transcript"], reports["jax"][2]["transcript"]):
        assert {k: a[k] for k in ("index", "label", "prediction", "predicted_class")} == \
               {k: b[k] for k in ("index", "label", "prediction", "predicted_class")}


def test_step_probabilities_within_tolerance(reports):
    """Each step's wnid and name equal, its prob and entropy within 1e-5 of
    JAX's (NaN where JAX has NaN)."""
    port_t, jax_t = reports["port"][2]["transcript"], reports["jax"][2]["transcript"]
    assert len(port_t) == len(jax_t) == 8
    n_steps = 0
    for a, b in zip(port_t, jax_t):
        assert len(a["path"]) == len(b["path"])
        for sa, sb in zip(a["path"], b["path"]):
            assert (sa["wnid"], sa["name"]) == (sb["wnid"], sb["name"])
            for k in ("prob", "entropy"):
                if math.isnan(sb[k]):
                    assert math.isnan(sa[k]), (a["index"], k)
                else:
                    assert abs(sa[k] - sb[k]) <= PROB_TOL, (a["index"], k, sa[k], sb[k])
            n_steps += 1
    assert n_steps > 16


def test_report_keys_and_stdout_match(reports):
    """The same report keys in the same order, the same scalar fields, and
    the same stdout lines once their numbers are masked."""
    (_, jtext, jrep, _), (_, ptext, prep, _) = reports["jax"], reports["port"]
    assert list(prep) == list(jrep)
    assert [sorted(e) for e in prep["transcript"]] == [sorted(e) for e in jrep["transcript"]]
    assert [sorted(s) for e in prep["transcript"] for s in e["path"]] == \
           [sorted(s) for e in jrep["transcript"] for s in e["path"]]
    for k in ("checkpoint", "arch", "dataset", "val", "expected_top1", "tolerance", "pass"):
        assert prep[k] == jrep[k], k

    def masked(text):
        return [re.sub(r"\d+(\.\d+)?", "#", line) for line in text.strip().splitlines()]

    assert masked(ptext) == masked(jtext)
    assert len(masked(ptext)) == 3  # the top-1 line, the report path, DONE


def test_msgpack_gives_the_same_report(staged, reports, tmp_path):
    """The JAX package's .msgpack of the same variables, loaded through the
    port's converter, gives the .pth's report."""
    out = tmp_path / "m.json"
    rc, _ = run_port(["--checkpoint", staged[1], *BASE, "--report-out", str(out)])
    assert rc == 0
    got, want = json.loads(out.read_text()), reports["port"][2]
    assert got["checkpoint"] == staged[1]
    got.pop("checkpoint")
    want = {k: v for k, v in want.items() if k != "checkpoint"}
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


BLOCKED = ("jax", "jaxlib", "flax", "optax", "nbdt_tpu")


def test_tool_runs_without_jax_flax_nbdt_tpu(staged, reports, tmp_path):
    """``python -m nbdt_torch.tools.verify_release`` under a ``sys.meta_path``
    hook that makes jax, flax, optax and nbdt_tpu unimportable: it imports,
    runs on the .pth and the .msgpack on the CPU and reports the numbers of
    the in-process run."""
    out = tmp_path / "sub.json"
    code = f"""
import sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
        return None
sys.meta_path.insert(0, Block())
from nbdt_torch.tools.verify_release import main
for ckpt in {list(staged)!r}:
    assert main(["--checkpoint", ckpt, *{BASE!r}, "--device", "cpu",
                 "--report-out", {str(out)!r}]) == 0
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("loaded", loaded)
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded []" in proc.stdout
    assert proc.stdout.count("report only)") == 2
    got, want = json.loads(out.read_text()), reports["port"][2]
    for k in ("backbone_top1", "nbdt_soft_top1", "nbdt_hard_top1", "transcript"):
        assert got[k] == want[k], k
