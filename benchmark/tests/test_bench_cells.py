"""The benchmark's data and yardstick on the CPU: every cell's files and
its CPU size, the traffic's seeds, every configuration's frozen work
counts, the trace reduction and the metric readers, and a run's refusals
(too few cards; JAX loaded)."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from bench_testlib import (CELLS, CONFIGS, ROOT, SPEC, WAITING, WORKLOADS, cell_file, chips_of,
                           tiny_cell)
from benchmark import cells, faults, harness
from benchmark.reference import work
from benchmark.reference.tree import Hierarchy, hierarchy

METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
READERS = sorted(p.name[:-len(".py")] for p in (cells.BENCH / "metrics").glob("*.py"))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_names_files_that_exist(workload):
    spec, cell, config = cells.cell_files(workload)
    assert cell["why"] == next(w["why"] for w in spec["workloads"] if w["name"] == workload)
    kind = harness.load_module(cells.BENCH / "traffic" / f"{cell['kind']}.py")
    assert all(callable(getattr(kind, f)) for f in ("setup", "window", "check"))
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    assert cells.load_json(ROOT / entry["file"])["name"] == cell["config"]
    assert set(cell["limits"]), "a cell compares at least one number"
    reports = harness.cell_metrics(spec, workload, trace=False)
    assert "setup_s" in reports and len(reports) >= 2
    assert harness.cell_metrics(spec, workload, trace=True), "at least one per-layer metric"
    assert cell["faults"] and set(cell["faults"]) <= set(faults.FAULTS)
    hierarchy(config)  # the vendored tree parses


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_states_its_cpu_size(workload):
    """A cell's ``tiny`` form: parameters it has, on no more ranks than its
    cards; and the parameters of its test on the card."""
    cell = cell_file(workload)
    tiny, chips = cell["tiny"], chips_of(workload)
    assert set(tiny) <= {"params", "model", "program", "ranks", "why"}
    assert set(tiny["params"]) <= set(cell["params"])
    assert set(cell["control_test"]) <= set(cell["params"])
    assert 1 <= tiny.get("ranks", 1) <= chips and (chips == 1) == (tiny.get("ranks", 1) == 1)
    _, _, config = tiny_cell(workload)
    assert set(config["model"]) == set(cells.load_json(
        cells.BENCH / "configs" / f"{cell['config']}.json")["model"])


def test_every_cell_file_is_a_cell_or_waits():
    """A file of ``workloads/`` is a cell of BENCHMARK.json, or waits
    outside it for a later PR with the cards it will ask for and why."""
    files = sorted(p.stem for p in (cells.BENCH / "workloads").glob("*.json"))
    assert files == sorted(CELLS)
    for workload in WAITING:
        waiting = cell_file(workload)["waiting"]
        assert waiting["chips"] in (1, 4) and waiting["why"]


@pytest.mark.parametrize("workload", WAITING)
def test_run_refuses_a_waiting_cell(workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "not in BENCHMARK.json" in out.stderr


@pytest.mark.parametrize("name", CONFIGS)
def test_every_configuration_states_its_work(name):
    config = cells.load_json(cells.BENCH / "configs" / f"{name}.json")
    flops = config["flops_per_image"]
    assert isinstance(flops["serve"], int) and flops["serve"] > 0
    assert isinstance(flops.get("train", 1), int)


@pytest.mark.parametrize("metric", sorted({m["name"] for m in METRICS} | set(READERS)))
def test_every_metric_has_a_reader(metric):
    """Every metric of BENCHMARK.json has a reader, and every reader loads
    (those of a waiting cell's metrics too)."""
    reader = harness.load_module(cells.BENCH / "metrics" / f"{metric}.py")
    assert callable(reader.read)
    entry = next((m for m in METRICS if m["name"] == metric), {})
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
    chips = [w["chips"] for w in SPEC["workloads"]]
    assert set(chips) <= {1, 4}
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])


@pytest.mark.parametrize("workload", CELLS)
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
    kind = harness.load_module(cells.BENCH / "traffic" / "train_steps.py")
    states = [kind.setup(harness.Context("t", cell, config, s, "cpu")) for s in (9, 9)]
    for key in ("images", "labels", "perm_start"):
        assert torch.equal(states[0][key], states[1][key])
    assert states[0]["losses"] == states[1]["losses"]


def frozen_flops(name: str) -> dict:
    """A configuration's matrix FLOPs of one image as its file states them
    (and derives them, under ``why``)."""
    return cells.load_json(cells.BENCH / "configs" / f"{name}.json")["flops_per_image"]


@pytest.mark.parametrize("name", CONFIGS)
def test_flop_counts_of_the_published_architectures(name):
    config = cells.load_json(cells.BENCH / "configs" / f"{name}.json")
    ctx = harness.Context(name, {"params": {}}, config, 1, "cpu")
    size = config["model"]["image_size"]
    frozen = frozen_flops(name)
    assert work.flops_per_image(ctx.build_reference, ctx.hierarchy, size) == frozen["serve"]
    if "train" in frozen:
        assert work.flops_per_image(ctx.build_reference, ctx.hierarchy, size,
                                    train=True) == frozen["train"]


def test_work_counts_of_the_kernels():
    config = cells.load_json(cells.BENCH / "configs" / "resnet18_cifar10.json")
    h = hierarchy(config)
    assert work.tree_sizes(h) == {"C": 10, "S": 18, "pairs": 34}  # path lengths 3 and 4
    head = work.head_work(h, 8192, 512)
    assert head["bytes"] > 4 * 8192 * 512  # the features dominate: bound by bytes
    assert work.least_seconds(head["flops"], head["bytes"]) == pytest.approx(
        head["bytes"] / work.PEAK_BYTES_PER_S)
    ln = work.layernorm_work(256 * 197, 768)
    assert ln["bytes"] == 8 * 256 * 197 * 768 + 8 * 768
    assert 34e9 < frozen_flops("vit_b16_imagenet1000")["serve"] < 36e9  # ViT-B/16: 17.6 GMACs
    assert 1.1e9 < frozen_flops("resnet18_cifar10")["serve"] < 1.2e9  # CIFAR ResNet18: 0.56 GMACs


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
    config = cells.load_json(cells.BENCH / "configs" / "resnet18_cifar10.json")
    _, cell, _ = cells.cell_files("resnet18_cifar10.offline")
    ctx = harness.Context("resnet18_cifar10.offline", cell, config, 1, "cpu")
    trace = {"busy_s": 9.0, "window_s": 10.0,
             "kernels": [("void soft_head_stream<8, 4>(float const*)", 20e-6)] * 3
             + [("cudnn_conv", 1e-3)]}
    run = SimpleNamespace(trace=trace, window_s=10.0, images=290000, requests=35,
                          config=config, cell=cell, context=ctx, setup_s=12.0, chips=1)
    read = {m: harness.load_module(cells.BENCH / "metrics" / f"{m}.py").read
            for m in ("device_idle.offline", "mfu.serve", "b1_roofline.serve",
                      "serve_images_per_s", "setup_s")}
    assert read["device_idle.offline"](run) == pytest.approx(10.0)
    assert read["serve_images_per_s"](run) == 29000
    assert read["mfu.serve"](run) == pytest.approx(
        100 * 29000 * frozen_flops("resnet18_cifar10")["serve"] / 67e12)
    run.chips = 4  # the same images over four cards: a quarter of the share
    assert read["mfu.serve"](run) == pytest.approx(
        100 * 29000 * frozen_flops("resnet18_cifar10")["serve"] / (4 * 67e12))
    run.chips = 1
    head = work.head_work(ctx.hierarchy, 8192, 512)
    assert read["b1_roofline.serve"](run) == pytest.approx(
        100 * work.least_seconds(head["flops"], head["bytes"]) / 20e-6)
    run.trace = None
    assert read["mfu.serve"](run) is None and read["b1_roofline.serve"](run) is None


def test_nccl_reader_sums_the_collectives_a_step():
    read = harness.load_module(cells.BENCH / "metrics" / "nccl_ms.train.py").read
    trace = {"busy_s": 9.0, "window_s": 10.0,
             "kernels": [("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 2e-3)] * 6
             + [("ncclKernel_AllGather_RING_LL_Sum_int8_t", 1e-4)] * 2 + [("cudnn_conv", 1e-2)]}
    run = SimpleNamespace(trace=trace, steps=4)
    assert read(run) == pytest.approx(1000 * (12e-3 + 2e-4) / 4)
    run.trace = {**trace, "kernels": [("cudnn_conv", 1e-2)]}  # one card: no collective
    assert read(run) is None
    run.trace = None
    assert read(run) is None


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
from benchmark import cells, harness, faults, calibrate, ranks
from benchmark.reference import train, tree, work, resnet, vit
for path in glob.glob("benchmark/traffic/*.py") + glob.glob("benchmark/metrics/*.py"):
    harness.load_module(cells.BENCH / path.split("benchmark/", 1)[1])
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


@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_without_a_card_exits_with_no_result(workload):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          workload, "--seed", str(2 ** 31 + 5), "--seconds",
                          "1", "--trace", "1"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
