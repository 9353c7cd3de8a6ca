"""The benchmark's data and yardstick on the CPU: every cell's files, the
traffic's seeds, the frozen work counts, the trace reduction and the
metric readers, and a run's refusals (no card; JAX loaded)."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from bench_testlib import ROOT, tiny_cell
from benchmark import harness
from benchmark.reference import work
from benchmark.reference.tree import Hierarchy, hierarchy

SPEC = harness.load_json(ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_names_files_that_exist(workload):
    spec, cell, config = harness.cell_files(workload)
    assert cell["why"] == next(w["why"] for w in spec["workloads"] if w["name"] == workload)
    kind = harness.load_module(harness.BENCH / "traffic" / f"{cell['kind']}.py")
    assert all(callable(getattr(kind, f)) for f in ("setup", "window", "check"))
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    assert harness.load_json(ROOT / entry["file"])["name"] == cell["config"]
    assert set(cell["limits"]), "a cell compares at least one number"
    reports = harness.cell_metrics(spec, workload, trace=False)
    assert "setup_s" in reports and len(reports) >= 2
    assert harness.cell_metrics(spec, workload, trace=True), "at least one per-layer metric"
    hierarchy(config)  # the vendored tree parses


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    reader = harness.load_module(harness.BENCH / "metrics" / f"{metric}.py")
    assert callable(reader.read)
    entry = next(m for m in METRICS if m["name"] == metric)
    for w in entry.get("workloads", []):
        assert w in WORKLOADS
    if "moves" in entry:
        moved = next(m for m in SPEC["end_to_end"] if m["name"] == entry["moves"])
        assert set(entry["workloads"]) <= set(moved.get("workloads", WORKLOADS))


def test_benchmark_json_keeps_the_contract_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["moves"], set()).add(m["layer"])
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_same_seed_same_inputs_and_weights(workload):
    _, cell, config = tiny_cell(workload)
    one, two, other = (harness.Context(workload, cell, config, s, "cpu")
                       for s in (2 ** 31 + 12345, 2 ** 31 + 12345, 7))
    assert torch.equal(one.images(3, "pool0"), two.images(3, "pool0"))
    assert not torch.equal(one.images(3, "pool0"), other.images(3, "pool0"))
    sd1, sd2 = one.weights(), two.weights()
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)
    assert not torch.equal(sd1[next(iter(sd1))], other.weights()[next(iter(sd1))])


def test_train_store_is_seeded():
    _, cell, config = tiny_cell("resnet18_cifar10.train")
    kind = harness.load_module(harness.BENCH / "traffic" / "train_steps.py")
    states = [kind.setup(harness.Context("t", cell, config, s, "cpu")) for s in (9, 9)]
    for key in ("images", "labels", "perm_start"):
        assert torch.equal(states[0][key], states[1][key])
    assert states[0]["losses"] == states[1]["losses"]


# Matrix FLOPs of one image, 2 a multiply-add, direct convolution. ResNet18
# at 32px: the 3x3 stem 3,538,944, the four stages' 3x3 and 1x1 shortcut
# convolutions 1,107,296,256, the classifier 10,240; the soft rules 4 x 10
# classes x 18 child slots = 720. ViT-B/16 at 224px (197 tokens): the patch
# convolution 231,211,008, 12 layers of QKV, scores, values, projection and
# MLP 34,894,909,440, the classifier 1,536,000, the rules 4 x 1000 x 1998.
# A SoftTreeSupLoss step: three times the forward, less the stem's input
# gradient, and the rules' two backward products.
SERVED = {"resnet18_cifar10": 1_110_846_160, "vit_b16_imagenet1000": 35_135_648_448}
TRAINED = {"resnet18_cifar10": 3 * 1_110_845_440 - 3_538_944 + 2 * 720}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_flop_counts_of_the_published_architectures(name):
    config = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    ctx = harness.Context(name, {"params": {}}, config, 1, "cpu")
    size = config["model"]["image_size"]
    assert work.flops_per_image(ctx.build_reference, ctx.hierarchy, size) == SERVED[name]
    if name in TRAINED:
        assert work.flops_per_image(ctx.build_reference, ctx.hierarchy, size,
                                    train=True) == TRAINED[name]


def test_work_counts_of_the_kernels():
    config = harness.load_json(harness.BENCH / "configs" / "resnet18_cifar10.json")
    h = hierarchy(config)
    assert work.tree_sizes(h) == {"C": 10, "S": 18, "pairs": 34}  # path lengths 3 and 4
    head = work.head_work(h, 8192, 512)
    assert head["bytes"] > 4 * 8192 * 512  # the features dominate: bound by bytes
    assert work.least_seconds(head["flops"], head["bytes"]) == pytest.approx(
        head["bytes"] / work.PEAK_BYTES_PER_S)
    ln = work.layernorm_work(256 * 197, 768)
    assert ln["bytes"] == 8 * 256 * 197 * 768 + 8 * 768
    assert 34e9 < SERVED["vit_b16_imagenet1000"] < 36e9  # ViT-B/16: 17.6 GMACs
    assert 1.1e9 < SERVED["resnet18_cifar10"] < 1.2e9  # CIFAR ResNet18: 0.56 GMACs


def test_reduce_trace_counts_the_busy_union_and_names_the_gaps():
    phases = harness.Phases()
    phases.add(0, 40, "call")
    phases.add(40, 100, "result_to_host")
    events = [(10, 20, "k1"), (20, 5, "k2"), (50, 10, "k1"), (95, 50, "k3"), (-5, 8, "k0")]
    s = harness.reduce_trace(events, 0, 100, phases)
    assert s["busy_s"] == pytest.approx((3 + 20 + 10 + 5) / 1e9)
    assert s["window_s"] == pytest.approx(100 / 1e9)
    assert s["device_ops"][0] == ["k1", pytest.approx(30 / 1e9)]
    assert s["idle_gaps"][0][0].startswith("result_to_host")
    assert s["idle_gaps"][0][1] == pytest.approx(35 / 1e9)
    assert [round(g * 1e9) for _, g in s["idle_gaps"]] == [35, 20, 7]


def test_readers_of_a_traced_run():
    config = harness.load_json(harness.BENCH / "configs" / "resnet18_cifar10.json")
    _, cell, _ = harness.cell_files("resnet18_cifar10.offline")
    ctx = harness.Context("resnet18_cifar10.offline", cell, config, 1, "cpu")
    trace = {"busy_s": 9.0, "window_s": 10.0,
             "kernels": [("void soft_head_stream<8, 4>(float const*)", 20e-6)] * 3
             + [("cudnn_conv", 1e-3)]}
    run = SimpleNamespace(trace=trace, window_s=10.0, images=290000, requests=35,
                          config=config, cell=cell, context=ctx, setup_s=12.0)
    read = {m: harness.load_module(harness.BENCH / "metrics" / f"{m}.py").read
            for m in ("device_idle.offline", "mfu.serve", "b1_roofline.serve",
                      "serve_images_per_s", "setup_s")}
    assert read["device_idle.offline"](run) == pytest.approx(10.0)
    assert read["serve_images_per_s"](run) == 29000
    assert read["mfu.serve"](run) == pytest.approx(
        100 * 29000 * SERVED["resnet18_cifar10"] / 67e12)
    head = work.head_work(ctx.hierarchy, 8192, 512)
    assert read["b1_roofline.serve"](run) == pytest.approx(
        100 * work.least_seconds(head["flops"], head["bytes"]) / 20e-6)
    run.trace = None
    assert read["mfu.serve"](run) is None and read["b1_roofline.serve"](run) is None


def test_tree_parser_refuses_a_graph_that_is_not_a_tree(tmp_path):
    graph = {"nodes": [{"id": "a"}, {"id": "b"}, {"id": "c"}],
             "links": [{"source": "a", "target": "c"}, {"source": "b", "target": "c"}]}
    (tmp_path / "g.json").write_text(json.dumps(graph))
    (tmp_path / "w.txt").write_text("c\n")
    with pytest.raises(ValueError):
        Hierarchy(tmp_path / "g.json", tmp_path / "w.txt")


BLOCKER = r"""
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "nbdt_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
"""


def test_the_harness_loads_no_jax(tmp_path):
    """Every module of the benchmark, and a run up to its look for a card,
    with JAX, flax, optax and the JAX package blocked from loading."""
    code = BLOCKER + r"""
import glob, runpy
sys.path.insert(0, ".")
from benchmark import harness, faults, calibrate
from benchmark.reference import train, tree, work, resnet, vit
for path in glob.glob("benchmark/traffic/*.py") + glob.glob("benchmark/metrics/*.py"):
    harness.load_module(harness.BENCH / path.split("benchmark/", 1)[1])
import nbdt_torch, nbdt_torch.model, nbdt_torch.trainer, nbdt_torch.rules
sys.argv = ["run.py", "--workload", "resnet18_cifar10.offline", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
try:
    runpy.run_path("benchmark/run.py", run_name="__main__")
except SystemExit as e:
    print("exit", e.code)
print("loaded", harness.loaded_blocked_modules())
"""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "exit 2" in out.stdout and "loaded []" in out.stdout, out.stdout


def test_run_without_a_card_exits_with_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "resnet18_cifar10.train", "--seed", str(2 ** 31 + 5), "--seconds",
                          "1", "--trace", "1"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
