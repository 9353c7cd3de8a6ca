"""What every cell of the benchmark shares: finding a cell's files by name,
the seeded weights and inputs, the system under test (the ``nbdt_torch``
program, or the reference in a lower precision put in its place as the
control of the correctness check), the traced window, the metrics and the
result line.

A cell is ``workloads/<cell>.json``: it names its configuration
(``configs/<config>.json``), its traffic kind (``traffic/<kind>.py``) and
holds the kind's parameters and the limits of the numbers its check
compares. A metric is ``metrics/<metric>.py``, whose ``read(run)`` returns
a number or None. ``BENCHMARK.json`` at the checkout's root says which
metrics each cell reports and on how many cards it runs; a cell over
several cards runs one process a card (``ranks.py``), each through
:func:`run_cell`.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark.cells import BENCH, cell_files

BLOCKED = ("jax", "jaxlib", "flax", "optax", "nbdt_tpu")
NAME_WIDTH = 120  # characters of a kernel's name kept in the breakdown
# Intra-op threads of a run: its host work is Python and launches, and a
# host-bound loop of small requests spread 13.9% over six runs on an H100
# machine with PyTorch's default (one a core), 3.9% with one.
HOST_THREADS = 1


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    name = "benchmark_" + "_".join(path.relative_to(BENCH).with_suffix("").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def import_string(target: str):
    """``package.module:attribute`` -> the attribute."""
    module, _, attr = target.partition(":")
    return getattr(importlib.import_module(module), attr)


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metric names a run of ``workload`` reports: the end-to-end ones,
    or with ``trace`` the per-layer ones, each where its ``workloads`` (or,
    without the key, the metric it moves) belongs to this cell."""
    reports = [m["name"] for m in spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
    if not trace:
        return reports
    return [m["name"] for m in spec["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in reports else [])]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of a run's seed."""
    h = 1469598103934665603
    for ch in f"{seed}/{tag}":
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h >> 1


@contextlib.contextmanager
def precision(tf32: bool):
    """f32 products with TF32 on or off, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free_memory(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Phases:
    """What the host was doing, on the profiler's clock (``time.time_ns``):
    ``(start, end, label)`` spans the traffic records around its calls."""

    def __init__(self):
        self.spans = []

    def add(self, start: int, end: int, label: str) -> None:
        self.spans.append((start, end, label))

    def label_at(self, t: int) -> str:
        for start, end, label in self.spans:
            if start <= t < end:
                return label
        return "harness"


class Context:
    """One run of one cell: its files, seed and device, and the seeded
    weights, inputs and systems built from them. Over several cards,
    ``group`` (a ``ranks.Group``) is this rank's place among them: every
    rank draws the same weights and inputs from the seed."""

    def __init__(self, workload: str, cell: dict, config: dict, seed: int, device="cuda",
                 variant: str = "program", group=None):
        if variant not in ("program", "control"):
            raise ValueError(f"variant must be program or control, not {variant!r}")
        self.workload, self.cell, self.config = workload, cell, config
        self.params, self.seed, self.variant = cell["params"], int(seed), variant
        self.device = torch.device(device)
        self.group = group
        self.rank, self.world = (group.rank, group.world) if group is not None else (0, 1)
        self._reference = None
        self._hierarchy = None

    def running(self, t0: float, seconds: float) -> bool:
        """Whether the window goes on: fewer than ``seconds`` past ``t0`` on
        the host's clock; over several cards, rank 0's reading of a few
        calls before, which every rank takes, so that all run the same
        steps (``ranks.Group.agree``)."""
        go = time.perf_counter() - t0 < seconds
        return go if self.group is None else self.group.agree(go)

    # seeded inputs ---------------------------------------------------------
    def generator(self, tag: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, tag))

    def images(self, n: int, tag: str) -> torch.Tensor:
        """``n`` NHWC f32 images of the configuration's size, N(0, 1)."""
        size = self.config["model"]["image_size"]
        return torch.randn(n, size, size, 3, generator=self.generator(tag), device=self.device)

    # the reference and its weights ----------------------------------------
    @property
    def hierarchy(self):
        if self._hierarchy is None:
            from benchmark.reference.tree import hierarchy
            self._hierarchy = hierarchy(self.config)
        return self._hierarchy

    def rules(self):
        from benchmark.reference.tree import SoftRules
        return SoftRules(self.hierarchy, self.device)

    def reference(self) -> torch.nn.Module:
        """The reference model with the run's seeded weights (built once):
        one normal and one uniform draw for all leaves, scaled by kind
        (running means N(0, 0.01), variances and 1-d scales U(0.5, 1.5),
        1-d biases N(0, 0.0004), the model's ``normal_std`` leaves N(0,
        std^2), every other leaf N(0, gain^2 / fan_in)); the
        BatchNorm statistics set from a calibration batch and, unless the
        cell says ``calibrate_classifier: false``, the classifier calibrated
        on its features, so that random weights give spread,
        image-dependent predictions. The reference's ``features(x)`` gives
        rows of features, one an image or one a pixel; its classifier is a
        matrix or a 1x1 convolution over them."""
        if self._reference is None:
            with precision(False):
                self._reference = self._seeded_reference()
        return self._reference

    def build_reference(self) -> torch.nn.Module:
        """The reference model that the configuration names
        (``"reference": "module:Class"``), at its ``model`` sizes, with the
        weights its constructor gives."""
        return import_string(self.config["reference"]).from_sizes(self.config["model"])

    def _seeded_reference(self) -> torch.nn.Module:
        with torch.device("meta"):
            model = self.build_reference()
        shapes = model.state_dict()
        floats = [k for k, v in shapes.items() if v.is_floating_point()]
        total = sum(shapes[k].numel() for k in floats)
        gen = self.generator("weights")
        normal = torch.randn(total, generator=gen, device=self.device)
        uniform = torch.rand(total, generator=gen, device=self.device)
        gain = self.config["init"]["gain"]
        named = getattr(model, "normal_std", {})
        state, at = {}, 0
        for key, like in shapes.items():
            if not like.is_floating_point():
                state[key] = torch.zeros(like.shape, dtype=like.dtype, device=self.device)
                continue
            n = like.numel()
            z, u = normal[at:at + n].view(like.shape), uniform[at:at + n].view(like.shape)
            at += n
            if key.endswith("running_mean"):
                state[key] = 0.1 * z
            elif key.endswith("running_var") or (like.dim() == 1 and key.endswith("weight")):
                state[key] = 0.5 + u
            elif like.dim() == 1 and key.endswith("bias"):
                state[key] = 0.02 * z
            elif key.split(".")[-1] in named:
                state[key] = named[key.split(".")[-1]] * z
            else:
                state[key] = z * (gain / math.sqrt(like[0].numel()))
        model.load_state_dict(state, assign=True)
        with torch.no_grad():
            x = self.images(self.config["init"]["calibration_images"], "calibration")
            x = x.permute(0, 3, 1, 2).contiguous()
            norms = [b for b in model.modules() if isinstance(b, torch.nn.BatchNorm2d)]
            if norms:  # running statistics = the calibration batch's
                for b in norms:
                    b.momentum = 1.0
                model.train()(x)
                for b in norms:
                    b.momentum = 0.1
                    b.num_batches_tracked.zero_()
            if not self.params.get("calibrate_classifier", True):
                return model.eval()
            feats = model.eval().features(x)
            weight = model.classifier.weight
            C, D = weight.shape[0], weight[0].numel()
            w = torch.randn(C, D, generator=gen, device=self.device)
            w = w * (3.0 / math.sqrt(D)) / (feats.std(0) + 1e-6)
            weight.copy_(w.view_as(weight))
            model.classifier.bias.copy_(-(w @ feats.mean(0)))
        return model

    def weights(self) -> dict:
        """A copy of the reference's seeded state dict, for the program."""
        return {k: v.detach().clone() for k, v in self.reference().state_dict().items()}

    # the system under test -------------------------------------------------
    def program_model(self) -> torch.nn.Module:
        """The program's backbone with the run's weights."""
        spec = self.config["program"]
        with torch.device("meta"):
            model = import_string(spec["model"])(**spec["kwargs"])
        model.load_state_dict(self.weights(), strict=True, assign=True)
        return model

    def program_tree(self):
        from benchmark.reference.tree import DATA
        from nbdt_torch.tree import Tree

        t = self.config["tree"]
        return Tree(t["dataset"], path_graph=str(DATA / t["graph"]),
                    path_wnids=str(DATA / t["wnids"]))

    def serve_system(self):
        """The served NBDT: ``SoftNBDT(fused=True)`` over the program's
        backbone, or (the control) the reference in TF32 behind the same
        calls."""
        if self.variant == "control":
            return ReferenceServe(self.reference(), self.rules(), tf32=True)
        from nbdt_torch.model import SoftNBDT

        return SoftNBDT(self.config["tree"]["dataset"], self.program_model(),
                        tree=self.program_tree(), fused=True, device=self.device)


class ReferenceServe:
    """The reference behind the program's serving call: ``(x)`` -> class
    probabilities of NHWC images."""

    def __init__(self, model, rules, tf32: bool, block: int = 2048):
        self.model, self.rules, self.tf32, self.block = model.eval(), rules, tf32, block

    def logits(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.rules.M.device)
        with torch.no_grad(), precision(self.tf32):
            return torch.cat([self.model(part.permute(0, 3, 1, 2).contiguous())
                              for part in x.split(self.block)])

    def __call__(self, x) -> torch.Tensor:
        with precision(self.tf32):
            return self.rules.probs(self.logits(x))


def worst(*values: float) -> float:
    """The largest of ``values``; infinite if any is not finite (NaN too)."""
    return max(v if math.isfinite(v) else math.inf for v in values)


class Tracer:
    """``torch.profiler`` over the window, device activity only (kernels,
    copies, sets); the harness's own host spans are kept by :class:`Phases`
    on the same clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.device_type = torch.autograd.DeviceType.CUDA

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def summary(self, t0: int, t1: int, phases: Phases) -> dict:
        events = [(e.start_ns(), e.duration_ns(), e.name())
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == self.device_type]
        return reduce_trace(events, t0, t1, phases)


def reduce_trace(events, t0: int, t1: int, phases: Phases) -> dict:
    """Device events ``(start ns, duration ns, name)`` clipped to ``[t0,
    t1)``: their busy union, the 10 operations that took most time and the
    10 longest idle gaps, each named by what the host was doing at its
    middle."""
    clipped = []
    for start, duration, name in events:
        a, b = max(start, t0), min(start + duration, t1)
        if b > a:
            clipped.append((a, b, name))
    clipped.sort()
    busy, gaps, cursor = 0, [], t0
    for start, end, _ in clipped:
        if start > cursor:
            gaps.append((start - cursor, cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if t1 > cursor:
        gaps.append((t1 - cursor, cursor, t1))
    by_name = {}
    for start, end, name in clipped:
        by_name[name] = by_name.get(name, 0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(reverse=True)
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernels": [(name, (end - start) / 1e9) for start, end, name in clipped],
        "device_ops": [[name[:NAME_WIDTH], ns / 1e9] for name, ns in top],
        "idle_gaps": [[f"{phases.label_at((a + b) // 2)} at +{(a - t0) / 1e9:.3f}s", g / 1e9]
                      for g, a, b in gaps[:10]],
    }


class BlockedModules(RuntimeError):
    """A rank loaded modules that the port's runs may not load."""


def merge_checks(parts: list) -> dict:
    """Every rank's compared numbers as one: each number's worst reading
    over the ranks that compare it, beside its limit."""
    merged = {}
    for checks in parts:
        for name, (value, limit) in checks.items():
            merged[name] = (worst(merged[name][0], value) if name in merged else value, limit)
    return merged


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             variant: str = "program", t0: float = None, spec: dict = None,
             cell: dict = None, config: dict = None, keep_facts: bool = False,
             group=None) -> dict:
    """One run of one cell: set-up, the window (traced with ``trace``), the
    correctness check, the metrics. Returns the result line's object, with
    the numbers compared under ``checks``, last; ``keep_facts`` adds the
    window's scalar facts under ``facts``.

    Over several cards every rank calls it with its ``group``: the ranks
    meet before and after each phase, and rank 0 alone returns the result
    (the others None), from every rank's checks (``correct`` only if all
    hold), the largest peak, the mean busy seconds, and its own window,
    trace and spans. It raises :class:`BlockedModules` where another rank
    loaded a module that the port's runs may not load."""
    t0 = time.perf_counter() if t0 is None else t0
    if cell is None or config is None:
        spec, cell, config = cell_files(workload, spec)
    kind = load_module(BENCH / "traffic" / f"{cell['kind']}.py")
    with precision(config["precision"]["tf32"]):
        ctx = Context(workload, cell, config, seed, device, variant, group)
        state = kind.setup(ctx)
        sync(device)
        if group is not None:
            group.barrier()  # set-up ends when the slowest rank's does
        setup_s = time.perf_counter() - t0
        phases = Phases()
        cuda = ctx.device.type == "cuda"
        trace = trace and cuda  # a device trace comes from the card alone
        tracer = Tracer() if trace else contextlib.nullcontext()
        with tracer:
            if group is not None:
                group.barrier()  # every rank's profiler has started
            facts = kind.window(state, seconds, phases)
        summary = tracer.summary(facts["t0_ns"], facts["t1_ns"], phases) if trace else None
        peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
        checks = kind.check(state)
    if group is not None:
        parts = group.gather({"checks": checks, "peak": peak, "blocked": loaded_blocked_modules(),
                              "busy_s": summary["busy_s"] if summary else None})
        if parts is None:
            return None
        blocked = {f"rank {r}": p["blocked"] for r, p in enumerate(parts) if p["blocked"]}
        if blocked:
            raise BlockedModules(f"modules the port's runs may not load were loaded: {blocked}")
        checks = merge_checks([p["checks"] for p in parts])
        peak = max(p["peak"] for p in parts)
        if summary is not None:
            summary["busy_s"] = statistics.mean(p["busy_s"] for p in parts)
    correct = all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    run = SimpleNamespace(setup_s=setup_s, trace=summary, config=config, cell=cell,
                          context=ctx, chips=ctx.world, **facts)
    metrics = {}
    for name in cell_metrics(spec, workload, trace) if spec else []:
        entry = next(m for m in spec["end_to_end"] + spec["per_layer"] if m["name"] == name)
        value = load_module(BENCH / "metrics" / f"{name}.py").read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": int(facts["attempted"]),
        "failed": int(facts["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
            "count": ctx.world,
            "memory_peak_bytes": int(peak),
        },
    }
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if keep_facts:
        result["facts"] = {k: v for k, v in facts.items() if isinstance(v, (int, float))}
    # a reading that is not finite goes as text, so that the line stays JSON
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": limit}
                        for name, (v, limit) in checks.items()}
    return result


def loaded_blocked_modules() -> list:
    """Top-level names of loaded modules that the port's runs may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BLOCKED))
